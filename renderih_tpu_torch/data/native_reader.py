"""ctypes bindings for the native packed-dataset reader (counterpart of
`renderih_tpu/data/native_reader.py`).

`csrc/packed_reader.cpp` maps a file of fixed-size records and gathers a
batch of them with a GIL-free thread pool, so the host assembles the next
batch while the card runs the current step. It is built with g++ at first
use into `build/renderih_tpu_torch/` (`kernels/_build.py:load_host`).
Unlike the JAX package, a failed build or a file that does not map raises:
there is no silent memmap fallback (a caller that wants the memmap asks
for it, `PackedInterHand.load(..., use_native=False)`).
"""

from __future__ import annotations

import ctypes

import numpy as np

from renderih_tpu_torch.kernels import _build

_SIGNATURES = {
    "pr_open": (ctypes.c_void_p, (ctypes.c_char_p,)),
    "pr_close": (None, (ctypes.c_void_p,)),
    "pr_size": (ctypes.c_int64, (ctypes.c_void_p,)),
    "pr_gather": (ctypes.c_int, (ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                                 ctypes.POINTER(ctypes.c_uint8), ctypes.c_int)),
}


def load_library() -> ctypes.CDLL:
    """The reader's library, built on first use; raises if it cannot be."""
    return _build.load_host("packed_reader", _SIGNATURES)


class PackedReader:
    """Random-access reader over a file of fixed-size records."""

    def __init__(self, path: str, record_shape: tuple, dtype=np.uint8,
                 n_threads: int = 4):
        self.record_shape = tuple(record_shape)
        self.dtype = np.dtype(dtype)
        self.record_bytes = int(np.prod(record_shape)) * self.dtype.itemsize
        self.n_threads = n_threads
        self._lib = load_library()
        handle = self._lib.pr_open(str(path).encode())
        if not handle:
            raise OSError(f"packed reader: cannot open and map {path}")
        self._handle = ctypes.c_void_p(handle)
        self.num_records = self._lib.pr_size(self._handle) // self.record_bytes

    def __len__(self) -> int:
        return int(self.num_records)

    def gather(self, indices: np.ndarray) -> np.ndarray:
        """Records `indices`, (n,) + record_shape; IndexError if one is out
        of range."""
        if self._handle is None:
            raise ValueError("packed reader is closed")
        indices = np.ascontiguousarray(indices, np.int64)
        n = len(indices)
        out = np.empty((n,) + self.record_shape, self.dtype)
        rc = self._lib.pr_gather(
            self._handle, self.record_bytes,
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), self.n_threads)
        if rc != 0:
            raise IndexError("record index out of bounds")
        return out

    def close(self) -> None:
        if getattr(self, "_handle", None) is not None:
            self._lib.pr_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
