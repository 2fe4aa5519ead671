"""Experimental cross-hand attention variants (counterpart of
`renderih_tpu/models/experimental_attn.py`).

* `PointAttn` / `InterPoint`: position-aware inter-hand attention with
  learned per-vertex positions and a per-head MLP score (reference
  `common/myhand/model_attn/point_transformer.py:10-129`).
* `LinearCrossAttention`: O(V) cross-hand attention where each hand's
  values are modulated by a global context vector of the other (reference
  `common/myhand/model_attn/new_cattention.py:33-98`).

The flagship decoder uses neither. Both reference quirks of `PointAttn`
are kept: the values come from the destination hand, and the score's
softmax runs over the query axis. Its pairwise (B, V, V, H, D) tensors are
plain einsums, as in the JAX package (3.9 GB at batch 256 and V = 244:
callers keep the batch small). The per-hand `SelfAttn`s are the decoder's
(`models/attention.py`), so on the card their cores run in kernel B1
(`InterPoint`'s 8 heads at width 64: D = 8). Parameter names are the JAX
modules' but for the `SelfAttn` and `MlpResBlock` inside, which keep the
decoder's (`utils/weights.py:flax_module_state_dict`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from renderih_tpu_torch.models.attention import MlpResBlock, SelfAttn
from renderih_tpu_torch.models.layers import LayerNorm, Linear
from renderih_tpu_torch.ops.dropout import dropout

_LN_EPS = 1e-6


class PointAttn(nn.Module):
    """One direction of position-aware cross-hand attention (`Pointatt`,
    `point_transformer.py:10-96`): queries from the destination hand
    (`lf`), keys from the source hand (`rf`), values also from the
    destination hand (quirk 1, `:70`); the score's softmax normalises over
    the query axis (quirk 2, `:86`) while the aggregation sums over keys."""

    def __init__(self, f_dim: int, n_heads: int = 8, dropout: float = 0.1):
        super().__init__()
        h, d = n_heads, f_dim // n_heads
        self.n_heads = n_heads
        self.dropout = dropout
        self.pos_mlp1 = Linear(f_dim, 2 * f_dim)
        self.pos_mlp2 = Linear(2 * f_dim, f_dim)
        self.left_qs = Linear(f_dim, f_dim)
        self.left_vs = Linear(f_dim, f_dim)
        self.right_ks = Linear(f_dim, f_dim)
        # the reference's grouped 1x1 convs: D -> 2D -> D within each head
        self.attn_mlp_w1 = nn.Parameter(torch.randn(h, d, 2 * d) * d ** -0.5)
        self.attn_mlp_b1 = nn.Parameter(torch.zeros(h, 2 * d))
        self.attn_mlp_w2 = nn.Parameter(torch.randn(h, 2 * d, d) * (2 * d) ** -0.5)
        self.attn_mlp_b2 = nn.Parameter(torch.zeros(h, d))
        self.ffL = MlpResBlock(f_dim, 2 * f_dim, dropout)

    def forward(self, lf, rf, left_pos, right_pos):
        b, v, f = lf.shape
        h = self.n_heads
        d = f // h
        rel = left_pos[:, :, None, :] - right_pos[:, None, :, :]
        rel = self.pos_mlp2(F.relu(self.pos_mlp1(rel)))
        rel = rel.expand(b, v, v, f).reshape(b, v, v, h, d)
        q = self.left_qs(lf).reshape(b, v, h, d)
        val = self.left_vs(lf).reshape(b, v, h, d)
        k = self.right_ks(rf).reshape(b, v, h, d)
        score_in = q[:, :, None] - k[:, None, :] + rel  # (B, Vq, Vk, H, D)
        w1, b1, w2, b2 = (p.to(score_in.dtype) for p in (
            self.attn_mlp_w1, self.attn_mlp_b1, self.attn_mlp_w2, self.attn_mlp_b2))
        hmid = F.relu(torch.einsum("bijhd,hde->bijhe", score_in, w1) + b1)
        sim = torch.einsum("bijhe,hed->bijhd", hmid, w2) + b2
        attn = torch.softmax(sim, dim=1)  # over queries: quirk 2
        # values broadcast over the queries, indexed by the keys, plus rel
        agg = torch.einsum("bijhd,bijhd->bihd", attn, val[:, None] + rel).reshape(b, v, f)
        agg = dropout(agg, self.dropout, self.training)
        return self.ffL(lf + agg)


class InterPoint(nn.Module):
    """Position-aware inter-hand block (`point_transformer.py:98-129`):
    per-hand self-attention, then the left hand attends to the right and
    the right hand to the *updated* left (`:128`)."""

    def __init__(self, f_dim: int, verts_num: int, n_heads: int = 8, dropout: float = 0.1):
        super().__init__()
        self.L_self_attn = SelfAttn(f_dim, n_heads, f_dim, dropout)
        self.R_self_attn = SelfAttn(f_dim, n_heads, f_dim, dropout)
        self.left_pos = nn.Parameter(torch.zeros(1, verts_num, f_dim))
        self.right_pos = nn.Parameter(torch.zeros(1, verts_num, f_dim))
        self.left_trans = PointAttn(f_dim, n_heads, dropout)
        self.right_trans = PointAttn(f_dim, n_heads, dropout)

    def forward(self, lf: torch.Tensor, rf: torch.Tensor):
        lf = self.L_self_attn(lf)
        rf = self.R_self_attn(rf)
        shape = (lf.shape[0],) + self.left_pos.shape[1:]
        lp, rp = self.left_pos.expand(shape), self.right_pos.expand(shape)
        lf = self.left_trans(lf, rf, lp, rp)
        rf = self.right_trans(rf, lf, rp, lp)
        return lf, rf


class _SiluBlock(nn.Module):
    """`MyBlock` (`new_cattention.py:7-29`): LN -> SiLU -> 4x MLP. Not
    residual: the caller adds its skip terms first."""

    def __init__(self, latent_dim: int, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.norm = LayerNorm(latent_dim, eps=_LN_EPS)
        self.fc1 = Linear(latent_dim, 4 * latent_dim)
        self.fc2 = Linear(4 * latent_dim, latent_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = dropout(F.silu(self.norm(x)), self.dropout, self.training)
        x = dropout(self.fc1(x), self.dropout, self.training)
        return self.fc2(x)


class LinearCrossAttention(nn.Module):
    """Linear-complexity cross-hand attention (`new_cattention.py:33-98`):
    each hand pools a context vector (softmax over its own vertex scores
    times its keys, summed over vertices), which modulates the other
    hand's values."""

    def __init__(self, latent_dim: int, n_heads: int = 4, dropout: float = 0.1):
        super().__init__()
        f = latent_dim
        self.L_self_attn = SelfAttn(f, n_heads, 4 * f, dropout)
        self.R_self_attn = SelfAttn(f, n_heads, 4 * f, dropout)
        self.norm1 = LayerNorm(f, eps=_LN_EPS)
        self.norm2 = LayerNorm(f, eps=_LN_EPS)
        for side in ("l", "r"):
            setattr(self, f"{side}_qs", Linear(f, 1))
            setattr(self, f"{side}_ks", Linear(f, f))
            setattr(self, f"{side}_vs", Linear(f, f))
        self.ffL = _SiluBlock(f, dropout)
        self.ffR = _SiluBlock(f, dropout)

    def forward(self, lf: torch.Tensor, rf: torch.Tensor):
        lf = self.L_self_attn(lf)
        rf = self.R_self_attn(rf)
        lf2, rf2 = self.norm1(lf), self.norm2(rf)
        ctx_l = torch.sum(torch.softmax(self.l_qs(lf2), dim=1) * self.l_ks(lf2), 1, keepdim=True)
        ctx_r = torch.sum(torch.softmax(self.r_qs(rf2), dim=1) * self.r_ks(rf2), 1, keepdim=True)
        new_l = self.ffL(self.r_vs(rf2) * ctx_l + lf)
        new_r = self.ffR(self.l_vs(lf2) * ctx_r + rf)
        return new_l, new_r
