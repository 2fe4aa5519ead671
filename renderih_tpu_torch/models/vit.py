"""ViTPose encoder (counterpart of `renderih_tpu/models/vit.py`).

Plain ViT-B/16 or ViT-L/16 with no position embedding, pre-norm blocks and
a GELU MLP x4, plus the two-hand wrapper's 3-scale pyramid:
f16 = the trunk's output; f32 = conv1x1(patch_embed8(img) + nearest
2x(f16)); f8 = the pooled-KV downsampling block on f16; the global
feature is the mean of f16. Every attention core goes through
`models/attention.py:_mha`: kernel B1 outside training (D = 64 in the
blocks, D = embed_dim / 8 = 96 or 128 in the pooled-KV block), the plain
version in training, as the JAX package trains through XLA's einsum.

Maps are NCHW views of `channels_last` memory, like the ResNet's. Names
are the upstream wrapper's (`lijun_vitpose.py`), which
`renderih_tpu/utils/checkpoint_convert.py:convert_vit_wrapper` reads: the
trunk as `encoder.{patch_embed.proj, blocks.{i}.{norm1, attn.qkv,
attn.proj, norm2, mlp.fc1, mlp.fc2}, last_norm}` and, beside it at the
top level, `patch_embed.proj` (the stride-8 embedding), `conv1` and
`downsample.*`. `ViTEncoder` holds those four children under the same
names; `HandNet` holds them itself.

dtypes follow flax's: the compute dtype is the image's. LayerNorm works
and returns float32 (flax `dtype=float32`), and every Dense/Conv casts its
input to the compute dtype, so the residual stream stays in the compute
dtype, f16 is float32 (`last_norm`), `f32 + up` is float32 before `conv1`
casts it back, and f8 comes out in the compute dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from renderih_tpu_torch.models.attention import _mha
from renderih_tpu_torch.models.layers import Conv2d, Linear

_VIT_CONFIGS = {
    "vit_base": dict(embed_dim=768, depth=12, num_heads=12),
    "vit_large": dict(embed_dim=1024, depth=24, num_heads=16),
}
_POOL_HEADS = 8
_POOL_GRID = 16  # PooledKVAttention's token grid: a 256² image at patch 16


class LayerNorm32(nn.LayerNorm):
    """flax `LayerNorm(dtype=float32)`: float32 out whatever comes in."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())


class PatchEmbed(nn.Module):
    """Conv k = s = patch, padding 2: (B, 3, 256, 256) -> (B, C, 16, 16) at
    patch 16, (B, C, 32, 32) at patch 8."""

    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = Conv2d(3, dim, patch, patch, padding=2)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.proj(img)


class Attention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)


class ViTBlock(nn.Module):
    """Pre-norm block (LN eps 1e-6), exact GELU, MLP x4. Computes in its
    input's dtype."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = LayerNorm32(dim, eps=1e-6)
        self.attn = Attention(dim)
        self.norm2 = LayerNorm32(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        # split as (b, n, 3, heads, d): q, k, v are the thirds of the width
        qkv = self.attn.qkv(self.norm1(x).to(x.dtype)).reshape(b, n, 3, -1)
        out = _mha(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], self.num_heads,
                   training=self.training)
        x = x + self.attn.proj(out)
        h = F.gelu(self.mlp.fc1(self.norm2(x).to(x.dtype)))
        return x + self.mlp.fc2(h)


class ViT(nn.Module):
    """The trunk: patch-16 embedding, `depth` blocks, `last_norm`.
    (B, 3, H, W) -> f16 (B, C, H/16, W/16) float32."""

    def __init__(self, model_type: str = "vit_base"):
        super().__init__()
        cfg = _VIT_CONFIGS[model_type]
        d = cfg["embed_dim"]
        self.embed_dim = d
        self.patch_embed = PatchEmbed(16, d)
        self.blocks = nn.ModuleList(ViTBlock(d, cfg["num_heads"])
                                    for _ in range(cfg["depth"]))
        self.last_norm = LayerNorm32(d, eps=1e-6)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(img)
        b, c, h, w = x.shape
        tokens = x.flatten(2).transpose(1, 2)  # row-major (h, w) tokens
        for blk in self.blocks:
            tokens = blk(tokens)
        tokens = self.last_norm(tokens)
        return tokens.reshape(b, h, w, c).permute(0, 3, 1, 2)


class PooledKVAttention(nn.Module):
    """`Myattention` (`vitpose.py:16-101`): 2x spatial downsampling.

    Queries from 64 fused tokens: the channel-major regrouping (B, C, N)
    -> (B, 4C, N/4) through `fc0` (not a patch merge), plus an 8x8 average
    pool through the 1x1 `sr`, then LN (eps 1e-5) and GELU; keys and
    values from all 256 tokens. 8 heads, so D = C / 8. Needs the 16x16
    token grid of a 256² image.
    """

    def __init__(self, dim: int, num_heads: int = _POOL_HEADS):
        super().__init__()
        self.num_heads = num_heads
        self.fc0 = Linear(4 * dim, dim)
        self.sr = Conv2d(dim, dim, 1)
        self.norm = LayerNorm32(dim, eps=1e-5)
        self.q = Linear(dim, dim, bias=False)
        self.kv = Linear(dim, 2 * dim, bias=False)
        self.linear1 = Linear(dim, 2 * dim)
        self.linear2 = Linear(2 * dim, dim)

    def forward(self, fmap: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """fmap (B, C, 16, 16) -> (B, C, 8, 8), computing in `dtype`."""
        b, c, h, w = fmap.shape
        if (h, w) != (_POOL_GRID, _POOL_GRID):
            raise ValueError(f"PooledKVAttention needs a {_POOL_GRID}x{_POOL_GRID} "
                             f"token grid (a 256² image), got {h}x{w}")
        tokens = fmap.flatten(2).transpose(1, 2)  # (B, N, C)
        x_1 = fmap.reshape(b, c, h * w).reshape(b, 4 * c, h * w // 4).transpose(1, 2)
        x_1 = self.fc0(x_1.to(dtype))
        pooled = F.avg_pool2d(fmap, (h // 8, w // 8))
        pooled = self.sr(pooled.to(dtype)).flatten(2).transpose(1, 2)  # (B, 64, C)
        x_q = F.gelu(self.norm(pooled + x_1))
        q = self.q(x_q.to(dtype))
        kv = self.kv(tokens.to(dtype))
        out = _mha(q, kv[..., :c], kv[..., c:], self.num_heads, training=self.training)
        out = self.linear2(F.gelu(self.linear1(out)))
        return out.reshape(b, h // 2, w // 2, c).permute(0, 3, 1, 2)


def vit_head(m: nn.Module, f16: torch.Tensor, img: torch.Tensor) -> list:
    """[f8, f16, f32] of the ViT wrapper whose children `m` holds
    (`patch_embed`, `conv1`, `downsample`) from the trunk's f16, coarsest
    first, computing in img's dtype."""
    up = f16.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)  # nearest 2x
    f32 = m.conv1((m.patch_embed(img) + up).to(img.dtype))
    f8 = m.downsample(f16, img.dtype)
    return [f8, f16, f32]


def vit_pyramid(m: nn.Module, img: torch.Tensor) -> list:
    """`vit_head` on the output of `m.encoder`, the trunk."""
    return vit_head(m, m.encoder(img), img)


class ViTEncoder(nn.Module):
    """The ViT trunk and its pyramid: (B, 3, 256, 256) -> [f8, f16, f32]
    with `embed_dim` channels each."""

    def __init__(self, model_type: str = "vit_base"):
        super().__init__()
        d = _VIT_CONFIGS[model_type]["embed_dim"]
        self.encoder = ViT(model_type)
        self.patch_embed = PatchEmbed(8, d)
        self.conv1 = Conv2d(d, d, 1)
        self.downsample = PooledKVAttention(d)

    def forward(self, img: torch.Tensor) -> list:
        return vit_pyramid(self, img)


class ViTMid(nn.Module):
    """Global feature (the float32 mean of f16) and the maps as they are:
    the wrapper has no mid projections."""

    def forward(self, pyramid: list, n_levels: int | None = None):
        fmaps = list(pyramid) if n_levels is None else list(pyramid[:n_levels])
        return pyramid[1].mean(dim=(2, 3)), fmaps
