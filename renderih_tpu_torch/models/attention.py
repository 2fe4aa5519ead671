"""Attention blocks of the dual-graph decoder (counterpart of
`renderih_tpu/models/attention.py`).

  * `SelfAttn` — pre-norm MHA + MLP residual block
    (`common/myhand/model_attn/self_attn.py:36-85`).
  * `InterAttn` — cross-hand attention: Q/K from LN(L + R) of one hand, V
    from the other, with shared projections
    (`common/myhand/model_attn/inter_attn_lijun.py:38-125`).
  * `ImgEx` — image-grid tokens via strided-conv patchify + self-attention
    over concat([verts, grid]) (`common/myhand/model_attn/img_attn.py`).

Parameter names follow the upstream torch modules (`layer_norm`, `w_qs`,
`ff.fc1`, `L_self_attn_layer`, `layer_norm1`, `attn.Attn`, ...). Every
attention core goes through kernel B1 (`kernels/fused_attention.py`)
unless the module is training, where the plain version applies the
attention dropout the kernel does not have.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from renderih_tpu_torch.kernels.fused_attention import fused_mha, mha_reference
from renderih_tpu_torch.models.layers import Conv2d, LayerNorm, Linear
from renderih_tpu_torch.ops.dropout import dropout

_LN_EPS = 1e-6


class MlpResBlock(nn.Module):
    """x + Dropout(fc2(Dropout(relu(fc1(LN(x))))))."""

    def __init__(self, dim: int, hid_dim: int, dropout: float = 0.1):
        super().__init__()
        self.layer_norm = LayerNorm(dim, eps=_LN_EPS)
        self.fc1 = Linear(dim, hid_dim)
        self.fc2 = Linear(hid_dim, dim)
        self.dropout = dropout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.fc1(self.layer_norm(x)))
        h = dropout(h, self.dropout, self.training)
        h = dropout(self.fc2(h), self.dropout, self.training)
        return x + h


def _mha(q, k, v, n_heads: int, dropout: float = 0.0, training: bool = False):
    """Multi-head attention core. q: (B, N, H*Dq), k/v: (B, M, H*D)."""
    b, n, _ = q.shape
    m = k.shape[1]
    q = q.reshape(b, n, n_heads, -1)
    k = k.reshape(b, m, n_heads, -1)
    v = v.reshape(b, m, n_heads, -1)
    if training:
        return mha_reference(q, k, v, dropout, training=True)
    return fused_mha(q.contiguous(), k.contiguous(), v.contiguous())


class SelfAttn(nn.Module):
    """Pre-norm self-attention + MLP residual block."""

    def __init__(self, f_dim: int, n_heads: int = 4, hid_dim: int | None = None,
                 dropout: float = 0.1):
        super().__init__()
        d_model = n_heads * (f_dim // n_heads)
        self.n_heads = n_heads
        self.dropout = dropout
        self.layer_norm = LayerNorm(f_dim, eps=_LN_EPS)
        self.w_qs = Linear(f_dim, d_model)
        self.w_ks = Linear(f_dim, d_model)
        self.w_vs = Linear(f_dim, d_model)
        self.fc = Linear(d_model, f_dim)
        self.ff = MlpResBlock(f_dim, hid_dim or f_dim, dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.layer_norm(x)
        out = _mha(self.w_qs(h), self.w_ks(h), self.w_vs(h), self.n_heads,
                   self.dropout, self.training)
        out = dropout(self.fc(out), self.dropout, self.training)
        return self.ff(x + out)


class InterAttn(nn.Module):
    """Cross-hand attention.

    Each hand first runs its own `SelfAttn`; then the shared projections
    see LN(L + R) (two LayerNorms over the same sum, kept for the
    reference layout) and each hand attends to the other hand's values,
    followed by per-hand MLP residual blocks.
    """

    def __init__(self, f_dim: int, n_heads: int = 4, dropout: float = 0.1):
        super().__init__()
        d_model = n_heads * (f_dim // n_heads)
        self.n_heads = n_heads
        self.dropout = dropout
        self.L_self_attn_layer = SelfAttn(f_dim, n_heads, f_dim, dropout)
        self.R_self_attn_layer = SelfAttn(f_dim, n_heads, f_dim, dropout)
        self.w_qs = Linear(f_dim, d_model)
        self.w_ks = Linear(f_dim, d_model)
        self.w_vs = Linear(f_dim, d_model)
        self.fc = Linear(d_model, f_dim)
        self.layer_norm1 = LayerNorm(f_dim, eps=_LN_EPS)
        self.layer_norm2 = LayerNorm(f_dim, eps=_LN_EPS)
        self.ffL = MlpResBlock(f_dim, f_dim, dropout)
        self.ffR = MlpResBlock(f_dim, f_dim, dropout)

    def forward(self, lf: torch.Tensor, rf: torch.Tensor):
        lf = self.L_self_attn_layer(lf)
        rf = self.R_self_attn_layer(rf)
        lf2 = self.layer_norm1(lf + rf)
        rf2 = self.layer_norm2(rf + lf)
        # R2L: queries/keys from the left stream, values from the right.
        feat_r2l = _mha(self.w_qs(lf2), self.w_ks(lf2), self.w_vs(rf2),
                        self.n_heads, self.dropout, self.training)
        feat_l2r = _mha(self.w_qs(rf2), self.w_ks(rf2), self.w_vs(lf2),
                        self.n_heads, self.dropout, self.training)
        feat_r2l = dropout(self.fc(feat_r2l), self.dropout, self.training)
        feat_l2r = dropout(self.fc(feat_l2r), self.dropout, self.training)
        return self.ffL(lf + feat_r2l), self.ffR(rf + feat_l2r)


class ImgFeatToGrid(nn.Module):
    """Feature map (B, C, h, w) -> (B, grid*grid, grid_f_dim) tokens."""

    def __init__(self, img_size: int, grid_size: int, in_dim: int,
                 grid_f_dim: int, n_heads: int = 4, dropout: float = 0.01):
        super().__init__()
        patch = img_size // grid_size
        self.proj = Conv2d(in_dim, grid_f_dim, patch, patch)
        self.position_embeddings = nn.Embedding(grid_size * grid_size, grid_f_dim)
        self.self_attn = SelfAttn(grid_f_dim, n_heads, grid_f_dim, dropout)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.proj(img))
        x = x.flatten(2).transpose(1, 2)  # row-major (h, w) tokens
        x = x + self.position_embeddings.weight.to(x.dtype)
        return self.self_attn(x)


class ImgAttn(nn.Module):
    """Grid tokens projected to the vertex width (`fc`), concatenated after
    the vertex tokens, one `SelfAttn` (`Attn`), vertex rows kept
    (`img_attn.py:79-92`)."""

    def __init__(self, grid_f_dim: int, verts_f_dim: int, n_heads: int = 4,
                 dropout: float = 0.01):
        super().__init__()
        self.fc = Linear(grid_f_dim, verts_f_dim)
        self.Attn = SelfAttn(verts_f_dim, n_heads, verts_f_dim, dropout)

    def forward(self, verts_f: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
        grid = self.fc(grid)
        x = torch.cat([verts_f.to(grid.dtype), grid], dim=1)
        return self.Attn(x)[:, :verts_f.shape[1]]


class ImgEx(nn.Module):
    """Inject image-grid tokens into vertex tokens."""

    def __init__(self, img_size: int, grid_size: int, in_dim: int,
                 grid_f_dim: int, verts_f_dim: int, n_heads: int = 4,
                 dropout: float = 0.01):
        super().__init__()
        self.encoder = ImgFeatToGrid(img_size, grid_size, in_dim, grid_f_dim,
                                     n_heads, dropout)
        self.attn = ImgAttn(grid_f_dim, verts_f_dim, n_heads, dropout)

    def forward(self, img: torch.Tensor, verts_f: torch.Tensor) -> torch.Tensor:
        return self.attn(verts_f, self.encoder(img))
