"""Stride-1 SAME 3x3 convolution: hand-written CUDA kernel + plain version.

`conv3x3_same(x, w)` takes x NHWC (a `channels_last` NCHW tensor permuted
to NHWC is contiguous) and w HWIO `(3, 3, Cin, Cout)`, both float32 or
both bfloat16, and returns NHWC in x's dtype. It replaces
`renderih_tpu/kernels/conv_pallas.py:conv3x3_same`; the kernel
(`csrc/conv3x3.cu`) says what bounds it and how it is built.

Dispatch: a CPU tensor takes the plain version (`conv3x3_reference`); a
CUDA tensor launches the kernel or raises. There is no other route.
The kernel has no backward yet, so on the card it refuses inputs that
require grad while grad mode is on.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from renderih_tpu_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    f"conv3x3_same_{t}": (_P, _P, _P, _I, _I, _I, _I, _I, _P)
    for t in ("f32", "bf16")
}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

launches = _build.LaunchCounter()


def conv3x3_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: `F.conv2d(..., padding=1)` on the same layouts."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def conv3x3_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME 3x3 conv, x (B, H, W, Cin) NHWC, w (3, 3, Cin, Cout)."""
    if x.device.type == "cpu":
        return conv3x3_reference(x, w)
    if not x.is_cuda:
        raise ValueError(f"conv3x3_same: unsupported device {x.device}")
    if w.device != x.device:
        raise ValueError("conv3x3_same: x and w must be on one device")
    if x.dtype not in _SUFFIX or w.dtype != x.dtype:
        raise TypeError("conv3x3_same: x and w must both be float32 or both "
                        f"bfloat16, got {x.dtype} and {w.dtype}")
    if x.dim() != 4 or w.dim() != 4 or w.shape[:2] != (3, 3) \
            or w.shape[2] != x.shape[3]:
        raise ValueError(f"conv3x3_same: bad shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv3x3_same: x (NHWC) and w (HWIO) must be contiguous")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError("conv3x3_same has no backward on the card yet")
    b, h, wd, cin = x.shape
    cout = w.shape[3]
    y = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = _build.load("conv3x3", _SIGNATURES)
    fn = getattr(lib, f"conv3x3_same_{_SUFFIX[x.dtype]}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), b, h, wd, cin,
                 cout, stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_same: kernel launch failed (CUDA error {err})")
    launches.add()
    return y
