"""ResNet encoder family and the mid projection (counterpart of
`renderih_tpu/models/resnet.py`).

Logical NCHW in `channels_last` memory. Module and parameter names are
torchvision's (`conv1`, `bn1`, `layer{1..4}.{i}.conv{1,2,3}`,
`downsample.{0,1}`), the layout of the upstream `encoder.resnet.*`
state_dict. Every stride-1 3x3 conv goes through kernel B2
(`kernels/conv3x3.py:conv3x3_same`); strided and 1x1 convs are stock
convolutions, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from renderih_tpu_torch.kernels.conv3x3 import conv3x3_same
from renderih_tpu_torch.models.layers import BatchNorm2d, Conv2d

_STAGES = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
    "resnet152": ("bottleneck", (3, 8, 36, 3)),
}


class Conv3x3(Conv2d):
    """`Conv2d(cin, cout, 3, stride, padding=1, bias=False)`; at stride 1
    it runs kernel B2 on the NHWC view of the `channels_last` input."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__(cin, cout, 3, stride, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride != (1, 1):
            return super().forward(x)
        w = self.weight.to(x.dtype).permute(2, 3, 1, 0).contiguous()  # HWIO
        x = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        return conv3x3_same(x, w).permute(0, 3, 1, 2)


def _downsample(cin: int, cout: int, stride: int) -> nn.Sequential | None:
    if stride == 1 and cin == cout:
        return None
    return nn.Sequential(Conv2d(cin, cout, 1, stride, bias=False),
                         BatchNorm2d(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, width: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv3x3(cin, width, stride)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = Conv3x3(width, width)
        self.bn2 = BatchNorm2d(width)
        self.downsample = _downsample(cin, width, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(h + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, width: int, stride: int = 1):
        super().__init__()
        out_dim = width * self.expansion
        self.conv1 = Conv2d(cin, width, 1, bias=False)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = Conv3x3(width, width, stride)
        self.bn2 = BatchNorm2d(width)
        self.conv3 = Conv2d(width, out_dim, 1, bias=False)
        self.bn3 = BatchNorm2d(out_dim)
        self.downsample = _downsample(cin, out_dim, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(h + identity)


class ResNet(nn.Module):
    """ResNet trunk returning the 4-scale pyramid, coarsest first:
    [C5, C4, C3, C2] = 8², 16², 32², 64² maps for a 256² input."""

    def __init__(self, model_type: str = "resnet50"):
        super().__init__()
        kind, counts = _STAGES[model_type]
        block = Bottleneck if kind == "bottleneck" else BasicBlock
        self.expansion = block.expansion
        self.conv1 = Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        cin = 64
        for stage, num_blocks in enumerate(counts):
            width = 64 * 2**stage
            blocks = []
            for i in range(num_blocks):
                stride = 2 if (i == 0 and stage > 0) else 1
                blocks.append(block(cin, width, stride))
                cin = width * block.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))

    @property
    def pyramid_dims(self) -> tuple:
        e = self.expansion
        return (512 * e, 256 * e, 128 * e, 64 * e)

    def forward(self, x: torch.Tensor) -> list:
        h = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        feats = []
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            h = layer(h)
            feats.append(h)
        return feats[::-1]


class AuxDecoderHead(nn.Module):
    """Coarse map -> dense prediction (joint heatmaps, or mask + densepose):
    a 1x1 conv, then three rounds of bilinear x2 upsample and 3x3 conv, each
    conv followed by ReLU then BatchNorm, then a 1x1 projection with bias
    to `out_dim` (`ResNetSimple_decoder`, `models/encoder.py:16-59`; 8² ->
    64² for a 256² input). The convs are stock convolutions, as in the JAX
    package (flax `nn.Conv`, not its `Conv3x3`), so B2 runs none of them.
    Names follow the JAX module's: `flat_conv`, `flat_bn`, `up{i}_conv`,
    `up{i}_bn`, `final`."""

    def __init__(self, cin: int, out_dim: int):
        super().__init__()
        width = 256
        self.flat_conv = Conv2d(cin, width, 1, bias=False)
        self.flat_bn = BatchNorm2d(width)
        for i in range(3):
            self.add_module(f"up{i}_conv", Conv2d(width, width, 3, padding=1, bias=False))
            self.add_module(f"up{i}_bn", BatchNorm2d(width))
        self.final = Conv2d(width, out_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.flat_bn(F.relu(self.flat_conv(x)))
        for i in range(3):
            # jax.image.resize(..., "bilinear") at x2: half-pixel centres
            h = F.interpolate(h, scale_factor=2, mode="bilinear", align_corners=False)
            h = getattr(self, f"up{i}_bn")(F.relu(getattr(self, f"up{i}_conv")(h)))
        return self.final(h)


class ResNetMid(nn.Module):
    """Pyramid -> per-scale 1x1-projected maps + global feature.

    The global feature is the mean of the raw coarsest map; each scale
    goes conv1x1 -> ReLU -> BatchNorm (activation before BN, reference
    `models/model_zoo/__init__.py:56-62`), as `convs.{i}.{0,1,2}`.
    """

    def __init__(self, in_dims: tuple, out_dims: tuple = (256, 256, 256, 256)):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Sequential(Conv2d(cin, cout, 1, bias=False), nn.ReLU(),
                          BatchNorm2d(cout))
            for cin, cout in zip(in_dims, out_dims))

    def forward(self, pyramid: list, n_levels: int | None = None):
        """Projects the first `n_levels` scales (all by default): the
        decoder reads three of the four, and an unread map is not computed."""
        global_feature = pyramid[0].mean(dim=(2, 3))
        n = len(self.convs) if n_levels is None else n_levels
        fmaps = [self.convs[i](pyramid[i]) for i in range(n)]
        return global_feature, fmaps
