"""HRNet encoder family and its mid head (counterpart of
`renderih_tpu/models/hrnet.py`).

Stem (two stride-2 3x3 convs) -> 4 Bottlenecks -> three multi-resolution
stages of BasicBlock branches with full cross-resolution fusion; the
encoder returns the 4-branch pyramid coarsest first. `HRNetMid` adds the
per-scale projections and the classification-style head (incre
Bottlenecks, a stride-2 chain, a final 1x1 to 2048) whose mean is the
global feature. Widths w18 (18, 36, 72, 144), w32, w48, w64.

Logical NCHW in `channels_last` memory. Names are the upstream torch
HighResolutionNet's and `hrnet_mid`'s, the layout
`renderih_tpu/utils/checkpoint_convert.py:convert_reference_hrnet` reads:
`encoder.hrnet.{conv1, bn1, conv2, bn2, layer1.{i}, transition1.0.{0,1},
transition1.1.0.{0,1}, stage{s}.{m}.branches.{b}.{k},
stage{s}.{m}.fuse_layers.{i}.{j}.{0,1} (j > i) / .{k}.{0,1} (j < i),
transition{s}.{n}.0.{0,1}}` and `mid_model.{convs.{i}.{0,2},
incre_modules.{i}.0, downsamp_modules.{i}.{0,1}, final_layer.{0,1}}`.

Kernel B2 runs where the JAX package's `Conv3x3` sits: the stride-1
`conv1`/`conv2` of each BasicBlock and `conv2` of each Bottleneck
(`models/resnet.py`). Every other conv, the stride-1 3x3 `transition1.0`
included, is a stock convolution, as the JAX package leaves `nn.Conv` to
XLA. Only `downsamp_modules` and `final_layer` convs carry biases.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from renderih_tpu_torch.models.layers import BatchNorm2d, Conv2d
from renderih_tpu_torch.models.resnet import BasicBlock, Bottleneck, ResNetMid

_WIDTHS = {"hrnet_w18": 18, "hrnet_w32": 32, "hrnet_w48": 48, "hrnet_w64": 64}
# (num_modules, num_blocks) of stages 2..4, the standard recipe
_STAGES = ((1, 4), (4, 4), (3, 4))
_HEAD_WIDTHS = (32, 64, 128, 256)  # HRNetMid's incre Bottleneck widths


def _conv_bn(cin: int, cout: int, kernel: int, stride: int, relu: bool = True,
             bias: bool = False) -> nn.Sequential:
    layers = [Conv2d(cin, cout, kernel, stride, kernel // 2, bias=bias),
              BatchNorm2d(cout)]
    return nn.Sequential(*layers, nn.ReLU()) if relu else nn.Sequential(*layers)


class HRModule(nn.Module):
    """One multi-resolution module: `num_blocks` BasicBlocks a branch,
    then out_i = relu(sum_j fuse_{j->i}(y_j)): j > i a 1x1 conv + BN and a
    nearest 2^(j-i) upsample; j < i a chain of stride-2 3x3 conv + BN,
    ReLU on every link but the last, which alone takes width i."""

    def __init__(self, widths: tuple, num_blocks: int = 4):
        super().__init__()
        n = len(widths)
        self.branches = nn.ModuleList(
            nn.Sequential(*(BasicBlock(w, w) for _ in range(num_blocks))) for w in widths)
        fuse = []
        for i in range(n):
            row = []
            for j in range(n):
                if j > i:
                    row.append(_conv_bn(widths[j], widths[i], 1, 1, relu=False))
                elif j < i:
                    row.append(nn.Sequential(*(
                        _conv_bn(widths[j], widths[i] if k == i - j - 1 else widths[j],
                                 3, 2, relu=k < i - j - 1)
                        for k in range(i - j))))
                else:
                    row.append(None)
            fuse.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(fuse)

    def forward(self, xs: list) -> list:
        ys = [branch(x) for branch, x in zip(self.branches, xs)]
        outs = []
        for i, row in enumerate(self.fuse_layers):
            acc = None
            for j, fuse in enumerate(row):
                f = ys[j] if fuse is None else fuse(ys[j])
                if j > i:
                    f = F.interpolate(f, scale_factor=2 ** (j - i), mode="nearest")
                acc = f if acc is None else acc + f
            outs.append(F.relu(acc))
        return outs


class HRNet(nn.Module):
    """The trunk: (B, 3, H, W) -> [1/32, 1/16, 1/8, 1/4] maps of widths
    (8w, 4w, 2w, w), coarsest first."""

    def __init__(self, model_type: str = "hrnet_w32"):
        super().__init__()
        w = _WIDTHS[model_type]
        widths = [w, 2 * w, 4 * w, 8 * w]
        self.widths = tuple(widths)
        self.conv1 = Conv2d(3, 64, 3, 2, 1, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.conv2 = Conv2d(64, 64, 3, 2, 1, bias=False)
        self.bn2 = BatchNorm2d(64)
        self.layer1 = nn.Sequential(*(Bottleneck(64 if i == 0 else 256, 64)
                                      for i in range(4)))
        # upstream wraps every strided transition in one more Sequential
        self.transition1 = nn.ModuleList([
            _conv_bn(256, widths[0], 3, 1), nn.Sequential(_conv_bn(256, widths[1], 3, 2))])
        for stage, (num_modules, num_blocks) in enumerate(_STAGES):
            n = stage + 2
            self.add_module(f"stage{n}", nn.ModuleList(
                HRModule(tuple(widths[:n]), num_blocks) for _ in range(num_modules)))
            if n < 4:  # a new branch from the coarsest one
                self.add_module(f"transition{n}", nn.ModuleList(
                    [None] * n + [nn.Sequential(_conv_bn(widths[n - 1], widths[n], 3, 2))]))

    @property
    def pyramid_dims(self) -> tuple:
        return self.widths[::-1]

    def forward(self, x: torch.Tensor) -> list:
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.layer1(F.relu(self.bn2(self.conv2(h))))
        xs = [t(h) for t in self.transition1]
        for n in (2, 3, 4):
            for module in getattr(self, f"stage{n}"):
                xs = module(xs)
            if n < 4:
                xs = xs + [getattr(self, f"transition{n}")[n](xs[-1])]
        return xs[::-1]


class HRNetEncoder(nn.Module):
    """Holds the trunk as `hrnet`, the upstream `encoder.hrnet.*` layout."""

    def __init__(self, model_type: str = "hrnet_w32"):
        super().__init__()
        self.hrnet = HRNet(model_type)

    def forward(self, x: torch.Tensor) -> list:
        return self.hrnet(x)


class HRNetMid(ResNetMid):
    """`ResNetMid`'s per-scale projections (`convs`, conv1x1 -> ReLU -> BN)
    and a 2048-d global feature from the head over the raw pyramid,
    finest first: y = incre_0(p_3); y = incre_{i+1}(p_{2-i}) +
    relu(BN(down_i(y))); mean of relu(BN(final(y)))."""

    def __init__(self, in_dims: tuple, out_dims: tuple = (256, 256, 256, 256)):
        super().__init__(in_dims, out_dims)
        finest_first = in_dims[::-1]
        self.incre_modules = nn.ModuleList(
            nn.Sequential(Bottleneck(cin, hw)) for cin, hw in zip(finest_first, _HEAD_WIDTHS))
        self.downsamp_modules = nn.ModuleList(
            _conv_bn(4 * _HEAD_WIDTHS[i], 4 * _HEAD_WIDTHS[i + 1], 3, 2, bias=True)
            for i in range(3))
        self.final_layer = _conv_bn(4 * _HEAD_WIDTHS[-1], 2048, 1, 1, bias=True)

    def forward(self, pyramid: list, n_levels: int | None = None):
        fmaps = self.project(pyramid, n_levels)
        finest_first = pyramid[::-1]
        y = self.incre_modules[0](finest_first[0])
        for i in range(3):
            y = self.incre_modules[i + 1](finest_first[i + 1]) + self.downsamp_modules[i](y)
        return self.final_layer(y).mean(dim=(2, 3)), fmaps
