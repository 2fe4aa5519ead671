"""Plain PyTorch reference of the ViTPose two-hand network: the ViT trunk ->
the wrapper's three-scale pyramid and global feature -> the dual-graph decoder
of `model.py`.

It follows RenderIH's ViT variant: the trunk is `vit_large_patch16_224` /
`vit_base_patch16_224` of `models/vitpose/vitpose.py:438-455` (`ViT`,
`:296-436`; `PatchEmbed`, `:236-262`; `Block`), the pyramid and the global
feature are `HandNET_GCN` of `common/myhand/lijun_vitpose.py:17-84`, and the
pooled block is `Myattention` (`vitpose.py:16-101`). Stock torch layers only:
`F.conv2d`, `F.linear`, `F.layer_norm`, exact `F.gelu` and an einsum softmax
for every attention core (`model.AttentionCore`), float32 throughout unless
`set_precision` says otherwise. It imports nothing of the program under test.

Layers (widths from the configuration file: `embed_dim`, `depth`,
`num_heads`, `mlp_ratio`, `pool_heads`):
  * the trunk, `encoder.*`: a patch-16 embedding (`patch_embed.proj`, a conv
    of kernel and stride 16, padding 2: a 256^2 image gives 16x16 tokens),
    `depth` pre-norm blocks (`blocks.{i}`: `norm1`, `attn.qkv` with its bias,
    `attn.proj`, `norm2`, `mlp.fc1`, `mlp.fc2`; LayerNorm eps 1e-6, exact GELU,
    `num_heads` heads) and `last_norm`; f16 is its output as a map;
  * the pyramid, as the wrapper has it at the top level: `patch_embed.proj`
    (kernel and stride 8, padding 2: 32x32), f32 = `conv1`(that embedding +
    f16 upsampled 2x by nearest neighbour), and f8 = `downsample`, the pooled
    block: queries from 64 tokens, the channel-major regrouping (B, C, 256) ->
    (B, 4C, 64) through `fc0` plus f16 average-pooled to 8x8 through the 1x1
    `sr`, then LayerNorm (eps 1e-5) and GELU and `q` (no bias); keys and values
    from all 256 tokens through `kv` (no bias); `pool_heads` heads; then
    `linear1`, GELU, `linear2`;
  * the global feature, the mean of f16 over its 16x16 positions; the decoder
    reads [f8, f16, f32], every one `embed_dim` wide (`deconv_dims`).

The state dict is upstream's: the trunk under `encoder.`, and `patch_embed.`,
`conv1.` and `downsample.` beside it. `mid_model` holds those three modules
too (the same objects), so that a walk of `encoder`, `mid_model` and
`decoder` (`harness/work.py`) meets every convolution, linear layer and
attention core of the wrapper once; `state_dict` leaves the second names out,
and `load_state_dict` fills them from the first.

Departures from upstream: no class token and no position embedding, as the
fork runs the trunk (`pos_embed` None, `vitpose.py:326`); dropout and
drop-path, identity in eval, are left out; the attention's scale is
1/sqrt(D) (`qk_scale` None); the nearest 2x upsample is `F.interpolate`'s.
None of these changes an eval forward beyond rounding. The decoder is the
dual-graph decoder of `load_graph_model` (the configuration's `decoder`,
`graph`) in place of the newgraph decoder that `load_vit` feeds, which adds
a MANO parameter head whose outputs the served forward does not return.

`Precision` is `model.Precision`: `bfloat16` runs every op of the trunk and
the pyramid in bfloat16 on float32 parameters cast per op; `fp8` runs them in
float32 with every convolution's and linear layer's input and weight first
rounded to float8 e4m3 under a per-tensor scale; the decoder's `float32` or
`tf32` is `model.py`'s.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .model import (IMAGENET_MEAN, IMAGENET_STD, AttentionCore, BlockConv3x3, Conv, Decoder,
                    Precision, _tf32, fp8_round)

__all__ = ["AttentionCore", "BlockConv3x3", "Precision", "build"]

LN_EPS = 1e-6       # the trunk's norms (`norm_layer=partial(nn.LayerNorm, eps=1e-6)`)
POOL_LN_EPS = 1e-5  # `Myattention.norm`, torch's default
GELU_APPROXIMATE = "none"  # exact GELU (`nn.GELU()`)
UPSAMPLE = "nearest"       # f16 to f32's grid
PYRAMID = ("patch_embed", "conv1", "downsample")  # the wrapper's modules beside the trunk


class Linear(nn.Linear):
    """`nn.Linear` in its input's dtype, whose input and weight may be rounded
    first (`quant`)."""

    quant = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        if self.quant is not None:
            x, w = self.quant(x), self.quant(w)
        return F.linear(x, w, b)


class LayerNorm(nn.LayerNorm):
    """`nn.LayerNorm` in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate=GELU_APPROXIMATE)


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    return t.reshape(t.shape[0], t.shape[1], heads, -1)


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = Conv(3, dim, patch, patch, 2)

    def forward(self, img):
        return self.proj(img)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.core = AttentionCore()

    def forward(self, x):
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, c // self.heads)
        return self.proj(self.core(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, heads)
        self.norm2 = LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class ViT(nn.Module):
    """The trunk: (B, 3, 256, 256) -> f16 (B, C, 16, 16)."""

    def __init__(self, c: dict):
        super().__init__()
        d = c["embed_dim"]
        self.patch_embed = PatchEmbed(16, d)
        self.blocks = nn.ModuleList(Block(d, c["num_heads"], c["mlp_ratio"])
                                    for _ in range(c["depth"]))
        self.last_norm = LayerNorm(d, eps=LN_EPS)

    def forward(self, img):
        x = self.patch_embed(img)
        b, d, hp, wp = x.shape
        tokens = x.flatten(2).transpose(1, 2)  # (B, Hp Wp, C), row-major positions
        for block in self.blocks:
            tokens = block(tokens)
        return self.last_norm(tokens).transpose(1, 2).reshape(b, d, hp, wp)


class Myattention(nn.Module):
    """The pooled block: f16 (B, C, 16, 16) -> f8 (B, C, 8, 8)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.fc0 = Linear(4 * dim, dim)
        self.sr = Conv(dim, dim, 1, 1, 0)
        self.norm = LayerNorm(dim, eps=POOL_LN_EPS)
        self.q = Linear(dim, dim, bias=False)
        self.kv = Linear(dim, 2 * dim, bias=False)
        self.linear1 = Linear(dim, 2 * dim)
        self.linear2 = Linear(2 * dim, dim)
        self.core = AttentionCore()

    def forward(self, f16):
        b, c, h, w = f16.shape
        channels = f16.reshape(b, c, h * w)                  # (B, C, N)
        tokens = channels.transpose(1, 2)                     # (B, N, C)
        regrouped = channels.reshape(b, 4 * c, h * w // 4).transpose(1, 2)
        pooled = self.sr(F.adaptive_avg_pool2d(f16, 8)).flatten(2).transpose(1, 2)  # (B, 64, C)
        q = self.q(gelu(self.norm(pooled + self.fc0(regrouped))))
        kv = self.kv(tokens)
        out = self.core(_heads(q, self.heads), _heads(kv[..., :c], self.heads),
                        _heads(kv[..., c:], self.heads))
        out = self.linear2(gelu(self.linear1(out)))
        return out.transpose(1, 2).reshape(b, c, h // 2, w // 2)


class Pyramid(nn.Module):
    """`mid_model`: the pyramid [f8, f16, f32] from f16 and the image, and the
    global feature; its modules are the network's top-level ones."""

    def __init__(self, patch_embed: nn.Module, conv1: nn.Module, downsample: nn.Module):
        super().__init__()
        self.patch_embed, self.conv1, self.downsample = patch_embed, conv1, downsample

    def forward(self, f16, img):
        up = F.interpolate(f16, scale_factor=2, mode=UPSAMPLE)
        f32 = self.conv1(self.patch_embed(img) + up)
        return f16.mean(dim=(2, 3)), [self.downsample(f16), f16, f32]


class HandNet(nn.Module):
    """The whole network; `forward` takes uint8 NHWC images."""

    def __init__(self, c: dict):
        super().__init__()
        d = c["embed_dim"]
        if any(w != d for w in c["deconv_dims"][:len(c["verts_nums"])]):
            raise ValueError(f"the ViT wrapper has no mid projection: the decoder reads "
                             f"{d}-wide maps, the configuration states {c['deconv_dims']}")
        self.c = c
        self.encoder = ViT(c)
        self.patch_embed = PatchEmbed(8, d)
        self.conv1 = Conv(d, d, 1, 1, 0)
        self.downsample = Myattention(d, c["pool_heads"])
        self.mid_model = Pyramid(*(getattr(self, name) for name in PYRAMID))
        self.decoder = Decoder(c, d)
        self.precision = Precision()

    def state_dict(self, *args, **kwargs):
        """Upstream's layout: the pyramid's modules under their top-level names
        alone."""
        out = super().state_dict(*args, **kwargs)
        for key in [k for k in out if k.startswith("mid_model.")]:
            del out[key]
        return out

    def load_state_dict(self, state_dict, *args, **kwargs):
        full = dict(state_dict)
        full.update((f"mid_model.{k}", v) for k, v in state_dict.items()
                    if k.split(".")[0] in PYRAMID)
        return super().load_state_dict(full, *args, **kwargs)

    def set_precision(self, precision: Precision) -> None:
        self.precision = precision
        quant = fp8_round if precision.encoder == "fp8" else None
        for part in (self.encoder, self.mid_model):
            for mod in part.modules():
                if isinstance(mod, (Conv, Linear)):
                    mod.quant = quant

    def forward(self, img_u8: torch.Tensor, pe_left: torch.Tensor,
                pe_right: torch.Tensor) -> dict:
        x = img_u8.float() / 255.0
        mean = torch.tensor(IMAGENET_MEAN, device=x.device)
        std = torch.tensor(IMAGENET_STD, device=x.device)
        x = ((x - mean) / std).permute(0, 3, 1, 2)
        if self.precision.encoder == "bfloat16":
            x = x.to(torch.bfloat16)
        with _tf32(False):
            g, fmaps = self.mid_model(self.encoder(x), x)
            g, fmaps = g.float(), [f.float() for f in fmaps]
        return self.decode(g, fmaps, pe_left, pe_right)

    def decode(self, g: torch.Tensor, fmaps: list, pe_left: torch.Tensor,
               pe_right: torch.Tensor) -> dict:
        """The decoder alone on its inputs (the global feature and the feature
        maps, float32), in this model's decoder precision."""
        with _tf32(self.precision.decoder == "tf32"):
            return self.decoder(g, fmaps, pe_left, pe_right)


def build(config: dict, device: torch.device | str = "cpu") -> HandNet:
    """The reference for a configuration file's dict, its parameters empty
    (load a state dict into it), in eval mode."""
    with torch.device(device):
        return HandNet(config).eval()
