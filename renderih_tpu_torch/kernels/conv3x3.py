"""Stride-1 SAME 3x3 convolution: hand-written CUDA kernel + plain version.

`conv3x3_same(x, w)` takes x NHWC (a `channels_last` NCHW tensor permuted
to NHWC is contiguous) and w HWIO `(3, 3, Cin, Cout)`, both float32 or
both bfloat16, and returns NHWC in x's dtype. It replaces
`renderih_tpu/kernels/conv_pallas.py:conv3x3_same`; the kernel
(`csrc/conv3x3.cu`) says what bounds it and how it is built.

Dispatch: a CPU tensor takes the plain version (`conv3x3_reference`); a
CUDA tensor launches the kernel or raises. There is no other route.
On the card the C launcher picks one of three kernels and reports which:
`wgmma` (Hopper tensor cores, bf16 with Cin % 16 == 0), `tf32x3` (the same
tensor-core kernel in float32, three TF32 passes, with Cin % 8 == 0; its
weight split into TF32 hi and lo halves first, into a scratch buffer
allocated here), both with Cout % 8 == 0 and 16-byte aligned tensors, or
`simt` (CUDA cores; every other input, in either dtype). `route` states
that rule; `routes` counts the launches of each beside `launches`.

Backward (`_Conv3x3Fn`, the counterpart of `conv_pallas.py:_bwd`): the
exact transpose pair. dx is itself a stride-1 SAME 3x3 conv of the output
gradient with the kernel flipped in space and its channels swapped, so it
runs through the same launch (and counts in `launches` and `routes`); dw
is the stock `torch.nn.grad.conv2d_weight` (cuDNN on the card), as the
JAX package computes it with XLA outside its kernel.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from renderih_tpu_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {  # x, w, [f32: the split weight's scratch], y, B, H, W, Cin, Cout, stream, route
    "conv3x3_same_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, ctypes.POINTER(_I)),
    "conv3x3_same_bf16": (_P, _P, _P, _I, _I, _I, _I, _I, _P, ctypes.POINTER(_I)),
}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
ROUTES = ("simt", "wgmma", "tf32x3")  # the launcher's route codes 0, 1 and 2


def route(dtype: torch.dtype, cin: int, cout: int, aligned: bool = True) -> str:
    """The route the launcher (`csrc/conv3x3.cu:launch`) takes: `wgmma` for
    bf16 with Cin % 16 == 0, `tf32x3` for float32 with Cin % 8 == 0, both
    with Cout % 8 == 0 and `aligned` (x, w and y 16-byte aligned); else
    `simt`. The wrapper and the card's checks read the rule here."""
    bf16 = dtype == torch.bfloat16
    if aligned and cin % (16 if bf16 else 8) == 0 and cout % 8 == 0:
        return "wgmma" if bf16 else "tf32x3"
    return "simt"

launches = _build.LaunchCounter()
routes = {name: _build.LaunchCounter() for name in ROUTES}


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
        return _Conv3x3Fn.apply(x, w)
    return _launch(x, w)


def _conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The forward without autograd: the plain version for a CPU tensor
    (any float dtype, for `gradcheck`), else the kernel."""
    return conv3x3_reference(x, w) if x.device.type == "cpu" else _launch(x, w)


class _Conv3x3Fn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _conv(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()  # arrives as the NHWC view of an NCHW gradient
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _conv(g, w.flip(0, 1).transpose(2, 3).contiguous())
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(
                x.permute(0, 3, 1, 2), (w.shape[3], w.shape[2], 3, 3),
                g.permute(0, 3, 1, 2), padding=1).permute(2, 3, 1, 0)
        return dx, dw


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel on validated CUDA tensors."""
    b, h, wd, cin = x.shape
    cout = w.shape[3]
    y = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = _build.load("conv3x3", _SIGNATURES)
    fn = getattr(lib, f"conv3x3_same_{_SUFFIX[x.dtype]}")
    ptrs = [x.data_ptr(), w.data_ptr(), y.data_ptr()]
    if x.dtype == torch.float32:
        # the tf32x3 route's weight, split into hi and lo, (2, 9, Cout, Cin);
        # null where the route is simt (the launcher raises if tf32x3 lacks it)
        aligned = not (x.data_ptr() | w.data_ptr() | y.data_ptr()) & 15
        w_split = (torch.empty((2, 9, cout, cin), dtype=x.dtype, device=x.device)
                   if route(x.dtype, cin, cout, aligned) == "tf32x3" else None)
        ptrs.insert(2, None if w_split is None else w_split.data_ptr())
    taken = _I(-1)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*ptrs, b, h, wd, cin, cout, stream, ctypes.byref(taken))
    if err != 0:
        raise RuntimeError(f"conv3x3_same: kernel launch failed (CUDA error {err})")
    launches.add()
    routes[ROUTES[taken.value]].add()
    return y
