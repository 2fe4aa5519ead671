"""Auxiliary network zoo (counterpart of `renderih_tpu/models/aux_nets.py`,
reference `common/nets/`): an FPN, CBAM channel and spatial attention, an
hourglass joint-heatmap head, a cross-hand feature-injection block and the
pose discriminator of the GAN pose prior. The flagship path uses none.

Feature maps are NCHW here (the JAX modules take NHWC); every convolution
and product is a stock one, and `CrossHandInjection`'s attention is a
plain einsum, as in the JAX package (not its `_mha`). Parameter names are
the JAX modules' but for indexed families: `lateral{i}`/`smooth{i}` are
`lateral.{i}`/`smooth.{i}`, CBAM's `Dense_0`/`Dense_1` `mlp.0`/`mlp.2`,
the hourglass's `{block}_conv`/`{block}_gn` `blocks.{block}.conv`/`.gn`
(`utils/weights.py:aux_net_state_dict_from_jax`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from renderih_tpu_torch.models.layers import Conv2d, Linear

_GN_EPS = 1e-6  # flax nn.GroupNorm's default


def _up2(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 upsample of an NCHW map (each pixel repeated 2 x 2)."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class FPN(nn.Module):
    """Feature pyramid (`common/nets/backbone.py:10-66`): the coarsest-first
    pyramid projected to `out_dim` by 1x1 convs, top-down nearest-upsampled
    context added, 3x3 smoothing."""

    def __init__(self, in_dims: tuple, out_dim: int = 256):
        super().__init__()
        self.lateral = nn.ModuleList(Conv2d(c, out_dim, 1) for c in in_dims)
        self.smooth = nn.ModuleList(Conv2d(out_dim, out_dim, 3, padding=1) for _ in in_dims)

    def forward(self, pyramid: list) -> list:
        laterals = [conv(f) for conv, f in zip(self.lateral, pyramid)]
        outs = [laterals[0]]
        for lat in laterals[1:]:
            outs.append(lat + _up2(outs[-1]))
        return [conv(o) for conv, o in zip(self.smooth, outs)]


class CBAM(nn.Module):
    """Convolutional Block Attention Module (`common/nets/cbam.py`): a
    shared MLP over the avg- and max-pooled channels, then a 7x7 conv over
    the channel-mean and channel-max maps."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        hidden = max(channels // reduction, 1)
        self.mlp = nn.Sequential(Linear(channels, hidden), nn.ReLU(), Linear(hidden, channels))
        self.spatial = Conv2d(2, 1, 7, padding=3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ca = torch.sigmoid(self.mlp(x.mean((2, 3))) + self.mlp(x.amax((2, 3))))
        x = x * ca[:, :, None, None]
        s = torch.cat([x.mean(1, keepdim=True), x.amax(1, keepdim=True)], 1)
        return x * torch.sigmoid(self.spatial(s))


class _ConvBlock(nn.Module):
    def __init__(self, cin: int, width: int):
        super().__init__()
        self.conv = Conv2d(cin, width, 3, padding=1)
        self.gn = nn.GroupNorm(8, width, eps=_GN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.gn(self.conv(x)))


class HourglassHead(nn.Module):
    """Single-stack hourglass joint-heatmap head (`common/nets/hand_head.py`):
    (B, C, H, W) -> (B, num_joints, H, W); H and W divisible by 2^depth."""

    def __init__(self, in_dim: int, num_joints: int = 21, width: int = 256, depth: int = 2):
        super().__init__()
        self.depth = depth
        names = ["pre"] + [f"{kind}{d}{end}" for d in range(depth, 0, -1)
                           for kind, end in (("up", ""), ("low", "_in"), ("low", "_out"))]
        self.blocks = nn.ModuleDict(
            (name, _ConvBlock(in_dim if name == "pre" else width, width)) for name in names)
        self.hm_out = Conv2d(width, num_joints, 1)

    def _hourglass(self, h: torch.Tensor, d: int) -> torch.Tensor:
        up = self.blocks[f"up{d}"](h)
        low = self.blocks[f"low{d}_in"](F.avg_pool2d(h, 2))
        if d > 1:
            low = self._hourglass(low, d - 1)
        return up + _up2(self.blocks[f"low{d}_out"](low))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.hm_out(self._hourglass(self.blocks["pre"](x), self.depth))


class CrossHandInjection(nn.Module):
    """Cross-hand feature injection (`common/nets/transformer.py:6-35`):
    queries from one hand's map attend over the other's tokens; the result
    is added back. (B, C, H, W) x 2 -> (B, C, H, W)."""

    def __init__(self, in_dim: int, dim: int, n_heads: int = 4):
        super().__init__()
        self.n_heads = n_heads
        self.q = Linear(in_dim, dim)
        self.k = Linear(in_dim, dim)
        self.v = Linear(in_dim, dim)
        self.proj = Linear(dim, in_dim)

    def forward(self, feat_a: torch.Tensor, feat_b: torch.Tensor) -> torch.Tensor:
        b, c, h, w = feat_a.shape
        tokens = lambda f: f.flatten(2).transpose(1, 2)  # (B, HW, C), row-major
        split = lambda t: t.reshape(b, h * w, self.n_heads, -1)
        q, k, v = split(self.q(tokens(feat_a))), split(self.k(tokens(feat_b))), split(
            self.v(tokens(feat_b)))
        hd = q.shape[-1]
        attn = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", q, k) / hd ** 0.5, -1)
        out = self.proj(torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b, h * w, -1))
        return feat_a + out.transpose(1, 2).reshape(b, c, h, w)


class PoseDiscriminator(nn.Module):
    """Per-joint + global pose discriminator (`common/nets/discriminator.py`;
    the GAN pose prior of `pose_data_optimize/Ver2Code/Discriminator`):
    rotation matrices (B, J, 3, 3) -> (per-joint logits (B, J), overall
    logits (B,))."""

    def __init__(self, num_joints: int = 15, width: int = 32):
        super().__init__()
        self.fc1 = Linear(9, width)
        self.fc2 = Linear(width, width)
        self.joint_out = Linear(width, 1)
        self.gfc = Linear(num_joints * width, 4 * width)
        self.global_out = Linear(4 * width, 1)

    def forward(self, rotmats: torch.Tensor):
        b, j = rotmats.shape[:2]
        h = F.relu(self.fc2(F.relu(self.fc1(rotmats.reshape(b, j, 9)))))
        per_joint = self.joint_out(h)[..., 0]
        overall = self.global_out(F.relu(self.gfc(h.reshape(b, -1))))[..., 0]
        return per_joint, overall
