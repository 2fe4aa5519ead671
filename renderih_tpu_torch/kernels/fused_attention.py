"""Fused multi-head attention for short token streams: CUDA kernel + plain
version.

`fused_mha(q, k, v)` takes q (B, N, H, D), k/v (B, M, H, D) and returns
softmax(q k^T / sqrt(D)) v as (B, N, H*D) in q's dtype, the contract of
`renderih_tpu/kernels/fused_attention.py:fused_mha`, whose `_mha_kernel`
it replaces. The kernel (`csrc/fused_attention.cu`, Hopper tensor cores:
3xTF32 in float32, bf16 in one pass) takes D in {8, 16, 32, 64, 96, 128} in
float32 or bfloat16; it says what bounds it and how.

Dispatch: a CPU tensor takes the plain version (`mha_reference`); a CUDA
tensor launches the kernel or raises. The kernel has no dropout and no
backward; `models/attention.py:_mha` uses the plain version in training
with dropout, as the JAX package does.
"""

from __future__ import annotations

import ctypes

import torch

from renderih_tpu_torch.kernels import _build
from renderih_tpu_torch.ops.dropout import dropout

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    f"fused_mha_{t}": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P)
    for t in ("f32", "bf16")
}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
HEAD_DIMS = (8, 16, 32, 64, 96, 128)

launches = _build.LaunchCounter()


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  dropout_p: float = 0.0, training: bool = False) -> torch.Tensor:
    """Plain version (`renderih_tpu/models/attention.py:_mha` einsum path),
    with optional attention dropout for training."""
    b, n, h, d = q.shape
    scale = torch.tensor(1.0 / d ** 0.5, dtype=q.dtype, device=q.device)
    logits = torch.einsum("bnhd,bmhd->bhnm", q, k) * scale
    attn = torch.softmax(logits, dim=-1)
    attn = dropout(attn, dropout_p, training)
    out = torch.einsum("bhnm,bmhd->bnhd", attn, v)
    return out.reshape(b, n, h * d)


def fused_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Attention core: q (B, N, H, D), k/v (B, M, H, D) -> (B, N, H*D)."""
    if q.device.type == "cpu":
        return mha_reference(q, k, v)
    if not q.is_cuda:
        raise ValueError(f"fused_mha: unsupported device {q.device}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("fused_mha: q, k and v must be on one device")
    if q.dtype not in _SUFFIX or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("fused_mha: q, k, v must all be float32 or all "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"fused_mha: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, n, h, d = q.shape
    m = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"fused_mha: head dim {d} not in {HEAD_DIMS}")
    if m == 0:
        raise ValueError("fused_mha: no keys")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("fused_mha: q, k, v must be contiguous")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError("fused_mha has no backward on the card")
    out = torch.empty((b, n, h * d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    # the kernel copies 16-byte pieces: a view that starts off that grid
    # is copied to a fresh (aligned) allocation first
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    lib = _build.load("fused_attention", _SIGNATURES)
    fn = getattr(lib, f"fused_mha_{_SUFFIX[q.dtype]}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, n, m, h, d, stream)
    if err != 0:
        raise RuntimeError(f"fused_mha: kernel launch failed (CUDA error {err})")
    launches.add()
    return out
