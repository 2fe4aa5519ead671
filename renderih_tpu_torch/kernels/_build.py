"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and compiles on its own into
`build/renderih_tpu_torch/lib<name>-<hash>.so` at the root of the checkout
(`build/` is git-ignored). The hash covers the source, every header
`csrc/*.cuh` it may include, and its flags (the shared `NVCC_FLAGS` and
its own `SOURCE_FLAGS`), so an edited source, header or flag never loads a
stale library. A library is built at first use
(`load`), or ahead of time for several sources at once (`build`: one nvcc
per source, all started together). Nothing is compiled when a module is
imported.

The host sources (`csrc/<name>.cpp`: the image codec, the packed-dataset
reader) build the same way with the C++ compiler `HOST_CXX` and
`HOST_FLAGS` (`load_host`); a failed build raises, as nvcc's does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

# the kernels' launch counters, under the name their readers use
from renderih_tpu_torch.utils.trace import Counter as LaunchCounter  # noqa: F401

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "renderih_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# Flags of one source on top of NVCC_FLAGS. `sdf.cu` must not contract
# multiply-adds: its inside/outside parity has to agree bit for bit with
# the plain version's separately rounded products and sums.
SOURCE_FLAGS = {"sdf": ("-fmad=false",)}


def nvcc_flags(name: str) -> tuple:
    """Every nvcc flag of `csrc/<name>.cu` (shared and per-source)."""
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())

HOST_CXX = "g++"
HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", "-ffp-contract=off")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "port's CUDA kernels build only where the CUDA "
                           "toolkit is installed")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(nvcc_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names, verbose: bool = False) -> dict:
    """Compile every named source whose library is missing, in parallel.

    Returns {name: compiler output} for the sources compiled (with
    `verbose`, nvcc's `-Xptxas -v` report of registers, shared memory and
    spills per kernel). Raises RuntimeError with the log if one fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *nvcc_flags(name), *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{logs[name]}")
        else:
            os.replace(tmp, out)  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use.

    `signatures` maps each C function to its argtypes; every function
    returns an int (the cudaError_t of its launch).
    """
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def host_library_path(name: str) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cpp").read_bytes())
    h.update(" ".join((HOST_CXX,) + HOST_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def load_host(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cpp`, built with `HOST_CXX` on
    first use. `signatures` maps each C function to (restype, argtypes).
    Raises RuntimeError if the compiler is missing or the build fails."""
    key = f"host:{name}"
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            path = host_library_path(name)
            if not path.exists():
                path.parent.mkdir(parents=True, exist_ok=True)
                tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
                cmd = [HOST_CXX, *HOST_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cpp")]
                try:
                    proc = subprocess.run(cmd, capture_output=True, text=True)
                except OSError as e:
                    raise RuntimeError(f"{HOST_CXX} failed to start for {name}.cpp: {e}") from e
                if proc.returncode != 0:
                    raise RuntimeError(f"{HOST_CXX} failed for {name}.cpp:\n"
                                       f"{proc.stdout}{proc.stderr}")
                os.replace(tmp, path)  # atomic: a reader never sees half a file
            lib = ctypes.CDLL(str(path))
            for fn, (restype, argtypes) in signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _libs[key] = lib
        return lib

