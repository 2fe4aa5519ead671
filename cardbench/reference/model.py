"""Plain PyTorch reference of the two-hand network: encoder -> mid -> dual-graph
decoder -> upsample -> orthographic projection.

It follows RenderIH's `load_graph_model` network (`misc/model/config.yaml`,
`utils/defaults.yaml`; `common/myhand/model_attn/DualGraph_lijun.py`,
`decoder_lijun_graph.py`, `encoder_lijun.py`) with stock torch layers only:
`F.conv2d` for every convolution, an einsum softmax for every attention
core, float32 throughout. It imports nothing of the program under test.
Module and parameter names are the upstream state_dict's, so one state dict
loads into this model and into the program alike.

`Precision` selects the arithmetic of the encoder and mid model (`float32`;
`bfloat16`: every op in bfloat16 on float32 parameters cast per op, as the
configuration states the encoder's precision; or `fp8`: float32 ops whose
convolution inputs and weights are first rounded to float8 e4m3 with a
per-tensor scale) and of the decoder (`float32`, or `tf32`: TF32 matmuls and
convolutions). The default is float32 everywhere; `bfloat16` measures how far
the configuration's own precision moves a seed's outputs; `fp8` with `tf32`
is the lower-precision control.

Layers, as the network has them (widths from the configuration file):
  * ResNet (bottleneck blocks) or HRNet (stem, 4 bottlenecks, three
    multi-resolution stages of basic blocks with full fusion), returning the
    four-scale pyramid coarsest first;
  * the mid model: 1x1 conv -> ReLU -> BatchNorm at each decoder scale, and
    the global feature (ResNet: the mean of the coarsest map; HRNet: the
    incre/downsample/final head to 2048, then the mean);
  * the decoder: per-hand vertex tokens from the global feature and the
    positional encoding, three stages of (MLP residual graph blocks, image
    grid attention, cross-hand attention) with x2 vertex upsampling between
    stages, the camera heads, the coordinate head, the learned upsample to
    the mesh and the orthographic projection.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6
FP8_MAX = 448.0  # largest finite float8 e4m3fn
HRNET_STAGES = ((1, 4), (4, 4), (3, 4))  # (modules, blocks) of stages 2..4
HRNET_HEAD_WIDTHS = (32, 64, 128, 256)
RESNET_BLOCKS = {"resnet50": (3, 4, 6, 3)}
HANDS = ("left", "right")
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclass(frozen=True)
class Precision:
    encoder: str = "float32"  # or "fp8"
    decoder: str = "float32"  # or "tf32"


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to the format's largest finite value, back in t's dtype."""
    scale = t.detach().abs().amax().clamp_min(1e-12) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


class Conv(nn.Conv2d):
    """`nn.Conv2d` in its input's dtype, whose inputs and weight may be rounded
    first (`quant`)."""

    quant = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        if self.quant is not None:
            x, w = self.quant(x), self.quant(w)
        return self._conv_forward(x, w, b)


class BlockConv3x3(Conv):
    """A residual block's 3x3 convolution (padding 1, no bias): at stride 1 it
    is the site of the program's hand-written 3x3 kernel, whose work
    `cardbench/harness/work.py` counts here."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__(cin, cout, 3, stride, 1, bias=False)


class AttentionCore(nn.Module):
    """softmax(q k^T / sqrt(D)) v over q (B, N, H, D), k and v (B, M, H, D),
    returned as (B, N, H*D): the site of the program's fused attention kernel."""

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        b, n, h, d = q.shape
        logits = torch.einsum("bnhd,bmhd->bhnm", q, k) / d ** 0.5
        out = torch.einsum("bhnm,bmhd->bnhd", torch.softmax(logits, dim=-1), v)
        return out.reshape(b, n, h * d)


def _conv_bn(cin: int, cout: int, kernel: int, stride: int, relu: bool = True,
             bias: bool = False) -> nn.Sequential:
    layers = [Conv(cin, cout, kernel, stride, kernel // 2, bias=bias), nn.BatchNorm2d(cout)]
    return nn.Sequential(*layers, nn.ReLU()) if relu else nn.Sequential(*layers)


def _downsample(cin: int, cout: int, stride: int):
    if stride == 1 and cin == cout:
        return None
    return nn.Sequential(Conv(cin, cout, 1, stride, bias=False), nn.BatchNorm2d(cout))


class BasicBlock(nn.Module):
    def __init__(self, cin: int, width: int, stride: int = 1):
        super().__init__()
        self.conv1 = BlockConv3x3(cin, width, stride)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = BlockConv3x3(width, width)
        self.bn2 = nn.BatchNorm2d(width)
        self.downsample = _downsample(cin, width, stride)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        return F.relu(h + (x if self.downsample is None else self.downsample(x)))


class Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv(cin, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = BlockConv3x3(width, width, stride)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = Conv(width, 4 * width, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(4 * width)
        self.downsample = _downsample(cin, 4 * width, stride)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        return F.relu(h + (x if self.downsample is None else self.downsample(x)))


class ResNet(nn.Module):
    def __init__(self, blocks: tuple):
        super().__init__()
        self.conv1 = Conv(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin = 64
        for stage, n in enumerate(blocks):
            width = 64 * 2 ** stage
            layers = []
            for i in range(n):
                layers.append(Bottleneck(cin, width, 2 if (i == 0 and stage > 0) else 1))
                cin = 4 * width
            self.add_module(f"layer{stage + 1}", nn.Sequential(*layers))
        self.pyramid_dims = (2048, 1024, 512, 256)

    def forward(self, x):
        h = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        feats = []
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            h = layer(h)
            feats.append(h)
        return feats[::-1]


class HRModule(nn.Module):
    def __init__(self, widths: tuple, num_blocks: int):
        super().__init__()
        n = len(widths)
        self.branches = nn.ModuleList(
            nn.Sequential(*(BasicBlock(w, w) for _ in range(num_blocks))) for w in widths)
        rows = []
        for i in range(n):
            row = []
            for j in range(n):
                if j > i:
                    row.append(_conv_bn(widths[j], widths[i], 1, 1, relu=False))
                elif j < i:
                    row.append(nn.Sequential(*(
                        _conv_bn(widths[j], widths[i] if k == i - j - 1 else widths[j], 3, 2,
                                 relu=k < i - j - 1) for k in range(i - j))))
                else:
                    row.append(None)
            rows.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(rows)

    def forward(self, xs):
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
    def __init__(self, width: int):
        super().__init__()
        widths = [width, 2 * width, 4 * width, 8 * width]
        self.conv1 = Conv(3, 64, 3, 2, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.conv2 = Conv(64, 64, 3, 2, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(64)
        self.layer1 = nn.Sequential(*(Bottleneck(64 if i == 0 else 256, 64) for i in range(4)))
        self.transition1 = nn.ModuleList([
            _conv_bn(256, widths[0], 3, 1), nn.Sequential(_conv_bn(256, widths[1], 3, 2))])
        for stage, (modules, blocks) in enumerate(HRNET_STAGES):
            n = stage + 2
            self.add_module(f"stage{n}", nn.ModuleList(
                HRModule(tuple(widths[:n]), blocks) for _ in range(modules)))
            if n < 4:
                self.add_module(f"transition{n}", nn.ModuleList(
                    [None] * n + [nn.Sequential(_conv_bn(widths[n - 1], widths[n], 3, 2))]))
        self.pyramid_dims = tuple(widths[::-1])

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.layer1(F.relu(self.bn2(self.conv2(h))))
        xs = [t(h) for t in self.transition1]
        for n in (2, 3, 4):
            for module in getattr(self, f"stage{n}"):
                xs = module(xs)
            if n < 4:
                xs = xs + [getattr(self, f"transition{n}")[n](xs[-1])]
        return xs[::-1]


class Encoder(nn.Module):
    """`encoder.resnet.*` or `encoder.hrnet.*`, as upstream nests them."""

    def __init__(self, name: str):
        super().__init__()
        if name.startswith("resnet"):
            self.resnet = ResNet(RESNET_BLOCKS[name])
        elif name.startswith("hrnet_w"):
            self.hrnet = HRNet(int(name[len("hrnet_w"):]))
        else:
            raise ValueError(f"the reference has no encoder {name}")

    @property
    def trunk(self) -> nn.Module:
        return self.resnet if hasattr(self, "resnet") else self.hrnet

    def forward(self, x):
        return self.trunk(x)


class Mid(nn.Module):
    """Per-scale 1x1 conv -> ReLU -> BatchNorm (`convs.{i}.{0,2}`) and the
    global feature; with `hrnet_head` the HRNet classification head."""

    def __init__(self, in_dims: tuple, out_dims: tuple, hrnet_head: bool):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Sequential(Conv(cin, cout, 1, bias=False), nn.ReLU(), nn.BatchNorm2d(cout))
            for cin, cout in zip(in_dims, out_dims))
        self.hrnet_head = hrnet_head
        if hrnet_head:
            self.incre_modules = nn.ModuleList(
                nn.Sequential(Bottleneck(cin, hw))
                for cin, hw in zip(in_dims[::-1], HRNET_HEAD_WIDTHS))
            self.downsamp_modules = nn.ModuleList(
                _conv_bn(4 * HRNET_HEAD_WIDTHS[i], 4 * HRNET_HEAD_WIDTHS[i + 1], 3, 2, bias=True)
                for i in range(3))
            self.final_layer = _conv_bn(4 * HRNET_HEAD_WIDTHS[-1], 2048, 1, 1, bias=True)

    def forward(self, pyramid: list, n_levels: int):
        fmaps = [self.convs[i](pyramid[i]) for i in range(n_levels)]
        if not self.hrnet_head:
            return pyramid[0].mean(dim=(2, 3)), fmaps
        finest = pyramid[::-1]
        y = self.incre_modules[0](finest[0])
        for i in range(3):
            y = self.incre_modules[i + 1](finest[i + 1]) + self.downsamp_modules[i](y)
        return self.final_layer(y).mean(dim=(2, 3)), fmaps


def _ln(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


class MlpResBlock(nn.Module):
    def __init__(self, dim: int, hid: int):
        super().__init__()
        self.layer_norm = _ln(dim)
        self.fc1 = nn.Linear(dim, hid)
        self.fc2 = nn.Linear(hid, dim)

    def forward(self, x):
        return x + self.fc2(F.relu(self.fc1(self.layer_norm(x))))


class SelfAttn(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.layer_norm = _ln(dim)
        self.w_qs, self.w_ks, self.w_vs = (nn.Linear(dim, dim) for _ in range(3))
        self.fc = nn.Linear(dim, dim)
        self.ff = MlpResBlock(dim, dim)
        self.core = AttentionCore()

    def forward(self, x):
        h = self.layer_norm(x)
        out = self.core(*(_heads(f(h), self.heads) for f in (self.w_qs, self.w_ks, self.w_vs)))
        return self.ff(x + self.fc(out))


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    return t.reshape(t.shape[0], t.shape[1], heads, -1)


class InterAttn(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.L_self_attn_layer = SelfAttn(dim, heads)
        self.R_self_attn_layer = SelfAttn(dim, heads)
        self.w_qs, self.w_ks, self.w_vs = (nn.Linear(dim, dim) for _ in range(3))
        self.fc = nn.Linear(dim, dim)
        self.layer_norm1 = _ln(dim)
        self.layer_norm2 = _ln(dim)
        self.ffL = MlpResBlock(dim, dim)
        self.ffR = MlpResBlock(dim, dim)
        self.core = AttentionCore()

    def _cross(self, qk, v):
        return self.fc(self.core(_heads(self.w_qs(qk), self.heads),
                                 _heads(self.w_ks(qk), self.heads),
                                 _heads(self.w_vs(v), self.heads)))

    def forward(self, lf, rf):
        lf = self.L_self_attn_layer(lf)
        rf = self.R_self_attn_layer(rf)
        lf2 = self.layer_norm1(lf + rf)
        rf2 = self.layer_norm2(rf + lf)
        return self.ffL(lf + self._cross(lf2, rf2)), self.ffR(rf + self._cross(rf2, lf2))


class GcnResBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = _ln(cin)
        self.fc1 = nn.Linear(cin, cout)
        self.norm2 = _ln(cout)
        self.fc2 = nn.Linear(cout, cout)
        self.shortcut = nn.Linear(cin, cout)
        self.norm3 = _ln(cout)

    def forward(self, x):
        h = self.fc2(F.relu(self.norm2(self.fc1(F.relu(self.norm1(x))))))
        return self.norm3(h + self.shortcut(x))


class GraphLayer(nn.Module):
    def __init__(self, cin: int, cout: int, blocks: int):
        super().__init__()
        self.GCN_blocks = nn.ModuleList(
            GcnResBlock(cin if i == 0 else cout, cout) for i in range(blocks))

    def forward(self, x):
        for i, block in enumerate(self.GCN_blocks):
            x = block(x)
            if i != len(self.GCN_blocks) - 1:
                x = F.relu(x)
        return x


class ImgFeatToGrid(nn.Module):
    def __init__(self, img_size: int, grid: int, cin: int, dim: int, heads: int):
        super().__init__()
        patch = img_size // grid
        self.proj = nn.Conv2d(cin, dim, patch, patch)
        self.position_embeddings = nn.Embedding(grid * grid, dim)
        self.self_attn = SelfAttn(dim, heads)

    def forward(self, img):
        x = F.relu(self.proj(img)).flatten(2).transpose(1, 2)
        return self.self_attn(x + self.position_embeddings.weight)


class ImgAttn(nn.Module):
    def __init__(self, grid_dim: int, verts_dim: int, heads: int):
        super().__init__()
        self.fc = nn.Linear(grid_dim, verts_dim)
        self.Attn = SelfAttn(verts_dim, heads)

    def forward(self, verts, grid):
        return self.Attn(torch.cat([verts, self.fc(grid)], dim=1))[:, :verts.shape[1]]


class ImgEx(nn.Module):
    def __init__(self, img_size, grid, cin, grid_dim, verts_dim, heads):
        super().__init__()
        self.encoder = ImgFeatToGrid(img_size, grid, cin, grid_dim, heads)
        self.attn = ImgAttn(grid_dim, verts_dim, heads)

    def forward(self, img, verts):
        return self.attn(verts, self.encoder(img))


class DualGraphLayer(nn.Module):
    def __init__(self, verts: int, cin: int, cout: int, blocks: int, img_size: int,
                 grid: int, img_dim: int, grid_dim: int, heads: int):
        super().__init__()
        self.position_embeddings = nn.Embedding(verts, cin)
        self.graph_left = GraphLayer(cin, cout, blocks)
        self.graph_right = GraphLayer(cin, cout, blocks)
        args = (img_size, grid, img_dim, grid_dim, cout, heads)
        self.img_ex_left = ImgEx(*args)
        self.img_ex_right = ImgEx(*args)
        self.attn = InterAttn(cout, heads)

    def forward(self, lf, rf, img_f):
        pos = self.position_embeddings.weight
        lf = self.img_ex_left(img_f, self.graph_left(lf + pos))
        rf = self.img_ex_right(img_f, self.graph_right(rf + pos))
        return self.attn(lf, rf)


class DualGraph(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        n = len(c["gcn_in_dims"])
        sizes = [c["img_size"] // 32 * 2 ** i for i in range(n)]
        self.layers = nn.ModuleList(
            DualGraphLayer(c["verts_nums"][i], c["gcn_in_dims"][i], c["gcn_out_dims"][i],
                           c["graph_layer_num"], sizes[i], c["grid_size"], c["deconv_dims"][i],
                           c["img_dims"][i], c["num_attn_heads"])
            for i in range(n))

    def forward(self, lf, rf, fmaps):
        for i, layer in enumerate(self.layers):
            lf, rf = layer(lf, rf, fmaps[i])
            if i != len(self.layers) - 1:
                lf, rf = lf.repeat_interleave(2, dim=1), rf.repeat_interleave(2, dim=1)
        return lf, rf


class Decoder(nn.Module):
    def __init__(self, c: dict, global_dim: int):
        super().__init__()
        self.img_size = c["img_size"]
        self.verts_in = c["verts_nums"][0]
        d0 = c["gcn_in_dims"][0] - 3
        self.gf_layer_left = nn.Sequential(nn.Linear(global_dim, d0), _ln(d0))
        self.gf_layer_right = nn.Sequential(nn.Linear(global_dim, d0), _ln(d0))
        self.dual_gcn = DualGraph(c)
        c_out, v_out = c["gcn_out_dims"][-1], c["verts_nums"][-1]
        self.avg_head = nn.Linear(v_out, 1)
        self.params_head = nn.Linear(c_out, 3)
        self.coord_head = nn.Linear(c_out, 3)
        self.unsample_layer = nn.Linear(v_out, c["num_verts"], bias=False)

    def _tokens(self, layer, g, pe):
        h = layer(g)
        b = h.shape[0]
        return torch.cat([h[:, None].expand(b, self.verts_in, h.shape[-1]),
                          pe[None].expand(b, self.verts_in, 3)], dim=-1)

    def forward(self, g, fmaps, pe_left, pe_right) -> dict:
        lf, rf = self.dual_gcn(self._tokens(self.gf_layer_left, g, pe_left),
                               self._tokens(self.gf_layer_right, g, pe_right), fmaps)
        out = {}
        size = float(self.img_size)
        for hand, feat in zip(HANDS, (lf, rf)):
            p = self.params_head(self.avg_head(feat.transpose(1, 2))[..., 0])
            scale, trans = p[:, 0], p[:, 1:]
            verts = self.unsample_layer(self.coord_head(feat).transpose(1, 2)).transpose(1, 2)
            offset = (trans * size / 2.0 + size / 2.0)[:, None, :]
            out[f"verts3d_{hand}"] = verts
            out[f"verts2d_{hand}"] = (scale * size)[:, None, None] * verts[..., :2] + offset
            out[f"scale_{hand}"] = scale
            out[f"trans2d_{hand}"] = trans
        return out


class HandNet(nn.Module):
    """The whole network; `forward` takes uint8 NHWC images."""

    def __init__(self, c: dict):
        super().__init__()
        self.c = c
        self.encoder = Encoder(c["encoder"])
        dims = self.encoder.trunk.pyramid_dims
        hrnet = c["encoder"].startswith("hrnet")
        self.mid_model = Mid(dims, tuple(c["deconv_dims"]), hrnet)
        self.decoder = Decoder(c, 2048 if hrnet else dims[0])
        self.precision = Precision()

    def set_precision(self, precision: Precision) -> None:
        self.precision = precision
        quant = fp8_round if precision.encoder == "fp8" else None
        for part in (self.encoder, self.mid_model):
            for mod in part.modules():
                if isinstance(mod, Conv):
                    mod.quant = quant

    def forward(self, img_u8: torch.Tensor, pe_left: torch.Tensor,
                pe_right: torch.Tensor) -> dict:
        x = img_u8.float() / 255.0
        mean = torch.tensor(IMAGENET_MEAN, device=x.device)
        std = torch.tensor(IMAGENET_STD, device=x.device)
        x = ((x - mean) / std).permute(0, 3, 1, 2)
        if self.precision.encoder == "bfloat16":
            x = x.to(torch.bfloat16)
        n_levels = len(self.c["verts_nums"])
        with _tf32(False):
            g, fmaps = self.mid_model(self.encoder(x), n_levels)
            g, fmaps = g.float(), [f.float() for f in fmaps]
        return self.decode(g, fmaps, pe_left, pe_right)

    def decode(self, g: torch.Tensor, fmaps: list, pe_left: torch.Tensor,
               pe_right: torch.Tensor) -> dict:
        """The decoder alone on its inputs (the global feature and the feature
        maps, float32), in this model's decoder precision."""
        with _tf32(self.precision.decoder == "tf32"):
            return self.decoder(g, fmaps, pe_left, pe_right)


@contextlib.contextmanager
def _tf32(on: bool):
    """TF32 for matmuls and cuDNN convolutions inside the block, as asked."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def build(config: dict, device: torch.device | str = "cpu") -> HandNet:
    """The reference for a configuration file's dict, its parameters empty
    (load a state dict into it), in eval mode."""
    with torch.device(device):
        return HandNet(config).eval()
