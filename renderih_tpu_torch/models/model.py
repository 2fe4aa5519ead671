"""Top-level two-hand network: encoder -> mid -> dual-graph decoder
(counterpart of `renderih_tpu/models/model.py`).

`HandNet.forward` takes NHWC `(B, H, W, 3)` normalised images, like the
JAX package; the encoder runs on the NCHW view of that tensor, which is
`channels_last` in memory. The encoder is a ResNet (`models/resnet.py`),
a ViT (`models/vit.py`) or an HRNet (`models/hrnet.py`), as
`model.encoder` names it; the decoder and the aux heads take that
encoder's widths. Parameter names are the upstream torch state_dict's
(`encoder.resnet.*` / `encoder.hrnet.*` / the ViT wrapper's `encoder.*`,
`patch_embed.*`, `conv1.*`, `downsample.*`; `mid_model.*`, `decoder.*`),
the layout `utils/weights.py:state_dict_from_jax` produces.

Precision policy, as in the JAX package: the encoder runs in bf16 under
`train.precision="bf16"`, the decoder trunk in f32 unless
`model.decoder_f32=False`, the heads always in f32; parameters are f32.

With `model.with_aux_heads` the network also holds the joint-heatmap
head `hms_head` (42 = 21 joints x 2 hands) and the mask + densepose head
`dp_head` (7 = 1 + 3 x 2) on the raw coarsest trunk map. They run only
when `forward` is asked for them (`aux=True`, the train step): the JAX
package's serve and eval steps drop the heads' outputs, and XLA then
drops the heads; an eager forward would compute them (about as many
FLOPs again as the ResNet-50 trunk at 256²).
"""

from __future__ import annotations

import torch
from torch import nn

from renderih_tpu_torch.assets import Assets
from renderih_tpu_torch.config import Config
from renderih_tpu_torch.models.decoder import DecoderOutput, GraphDecoder
from renderih_tpu_torch.models.dual_graph import GcnResBlock
from renderih_tpu_torch.models.hrnet import HRNetEncoder, HRNetMid
from renderih_tpu_torch.models.layers import lecun_normal_
from renderih_tpu_torch.models.resnet import AuxDecoderHead, ResNet, ResNetMid
from renderih_tpu_torch.models.vit import ViTEncoder, ViTMid, vit_head
from renderih_tpu_torch.utils import trace


class ResNetEncoder(nn.Module):
    """Holds the trunk as `resnet`, the upstream `encoder.resnet.*` layout."""

    def __init__(self, model_type: str):
        super().__init__()
        self.resnet = ResNet(model_type)

    def forward(self, x: torch.Tensor) -> list:
        return self.resnet(x)


def _check_supported(cfg: Config) -> None:
    m = cfg.model
    if not m.encoder.startswith(("resnet", "vit", "hrnet")):
        raise ValueError(f"unknown encoder {m.encoder}")
    if m.encoder.startswith("vit") and m.img_size != 256:
        raise ValueError(f"the ViT encoders need model.img_size 256 (a 16x16 "
                         f"token grid for PooledKVAttention), got {m.img_size}")
    if m.decoder not in ("graph", "mano"):
        raise ValueError(f"unknown decoder {m.decoder} (graph or mano)")


class HandNet(nn.Module):
    """Encoder + mid projection + two-hand graph decoder. `laplacians`
    (left, right; each the three coarsest, coarsest first) feed the
    `use_cheby` trunk."""

    def __init__(self, cfg: Config, verts_nums: tuple, bbox_dim: int = 0,
                 laplacians: tuple | None = None):
        super().__init__()
        _check_supported(cfg)
        m = cfg.model
        self.dtype = torch.bfloat16 if cfg.train.precision == "bf16" else torch.float32
        self.vit = m.encoder.startswith("vit")
        img_dims = tuple(m.deconv_dims)
        if self.vit:
            # the upstream wrapper keeps the trunk as `encoder` and the
            # pyramid's modules beside it: `patch_embed`, `conv1`, `downsample`
            for name, child in ViTEncoder(m.encoder).named_children():
                self.add_module(name, child)
            pyramid_dims = img_dims = (self.encoder.embed_dim,) * 3
            global_dim = pyramid_dims[0]
            self.mid_model = ViTMid()
        elif m.encoder.startswith("hrnet"):
            self.encoder = HRNetEncoder(m.encoder)
            pyramid_dims = self.encoder.hrnet.pyramid_dims
            global_dim = 2048
            self.mid_model = HRNetMid(pyramid_dims, img_dims)
        else:
            self.encoder = ResNetEncoder(m.encoder)
            pyramid_dims = self.encoder.resnet.pyramid_dims
            global_dim = pyramid_dims[0]
            self.mid_model = ResNetMid(pyramid_dims, img_dims)
        self.decoder = GraphDecoder(
            verts_nums=tuple(verts_nums),
            global_dim=global_dim,
            img_dims=img_dims,
            gcn_in_dims=tuple(m.gcn_in_dims),
            gcn_out_dims=tuple(m.gcn_out_dims),
            img_sizes=(m.img_size // 32, m.img_size // 16, m.img_size // 8),
            grid_f_dims=tuple(m.img_dims),
            grid_size=m.grid_size,
            graph_layer_num=m.graph_layer_num,
            n_heads=m.num_attn_heads,
            dropout=m.dropout,
            img_size=m.img_size,
            bbox_dim=bbox_dim,
            with_mano_head=m.decoder == "mano",
            dtype=torch.float32 if m.decoder_f32 else self.dtype,
            use_cheby=m.use_cheby,
            graph_k=m.graph_k,
            laplacians=laplacians,
        )
        self.hms_head = self.dp_head = None
        if m.with_aux_heads:
            self.hms_head = AuxDecoderHead(pyramid_dims[0], 42)
            self.dp_head = AuxDecoderHead(pyramid_dims[0], 7)

    def vit_head(self, f16: torch.Tensor, x: torch.Tensor) -> list:
        """The ViT wrapper's pyramid head on the trunk's f16 and the image
        (`models/vit.py:vit_head`): a method of the network, whose top level
        holds the head's modules, so that the serving engine can graph it as
        one call."""
        return vit_head(self, f16, x)

    def forward(self, img: torch.Tensor, pe_left: torch.Tensor,
                pe_right: torch.Tensor,
                bbox_info: torch.Tensor | None = None, aux: bool = False) -> DecoderOutput:
        """img: (B, H, W, 3) ImageNet-normalised RGB. With `aux` (and the
        aux heads built) the output's `aux` holds the heads' float32
        predictions, NHWC: 'hms' (B, S, S, 42), 'mask' (B, S, S) and
        'dense' (B, S, S, 6), S = img_size / 4."""
        x = img.to(self.dtype).permute(0, 3, 1, 2)  # NCHW view, channels_last
        # each span holds its child's call alone, the casts between them outside
        with trace.span("model.encoder"):
            if self.vit:
                with trace.span("model.vit.trunk"):
                    f16 = self.encoder(x)
                with trace.span("model.vit.pyramid"):
                    pyramid = self.vit_head(f16, x)
            else:
                pyramid = self.encoder(x)
        # The decoder reads the first len(verts_nums) maps. Training projects
        # all of them, as the JAX package does: the unread map's BatchNorm
        # still updates its running statistics there.
        n_levels = None if self.training else len(self.decoder.verts_nums)
        with trace.span("model.mid_model"):
            global_feature, fmaps = self.mid_model(pyramid, n_levels)
        global_feature = global_feature.float()
        used = [f.float() for f in fmaps[:len(self.decoder.verts_nums)]]
        with trace.span("model.decoder"):
            out = self.decoder(global_feature, used, pe_left, pe_right, bbox_info)
        if aux and self.hms_head is not None:
            nhwc = lambda head: head(pyramid[0]).float().permute(0, 2, 3, 1)
            hms = nhwc(self.hms_head)
            dp = nhwc(self.dp_head)
            out = out._replace(aux={"hms": hms, "mask": dp[..., 0], "dense": dp[..., 1:]})
        return out


def build_model(cfg: Config, assets: Assets, bbox_dim: int = 0) -> HandNet:
    """The network for `cfg` on these assets' graph sizes (default init;
    `init_model` draws the parameters from a generator)."""
    if assets.left.verts_nums != assets.right.verts_nums:
        raise ValueError("left/right graphs must coarsen to identical level "
                         f"sizes ({assets.left.verts_nums} vs "
                         f"{assets.right.verts_nums})")
    laps = ((assets.left.laplacians_coarse, assets.right.laplacians_coarse)
            if cfg.model.use_cheby else None)
    return HandNet(cfg, assets.left.verts_nums, bbox_dim, laps)


def model_call_kwargs(assets: Assets, device: torch.device | str = "cpu") -> dict:
    """The static-asset arguments of `HandNet.forward`, on `device`."""
    return dict(pe_left=assets.left.pe.to(device),
                pe_right=assets.right.pe.to(device))


@torch.no_grad()
def _init_params(model: HandNet, cfg: Config, assets: Assets,
                 generator: torch.Generator) -> None:
    """Draw every parameter from `generator` with the JAX package's init
    rules (flax defaults): conv and linear weights flax's `lecun_normal`
    (a normal cut at ±2σ, σ rescaled so the variance is 1/fan_in), biases
    0, norms at identity, BN statistics (0, 1), position embeddings
    normal(0, 0.02), the upsample from the assets' initializer and, under
    `zero_init_heads`, zero coord/params head weights; the Chebyshev
    blocks' fc1/fc2 `xavier_uniform`, as JAX draws `cheby{1,2}_kernel`. The
    aux heads, the MANO regressor and the ViT and HRNet encoders follow
    the same rules (`zero_init_heads` leaves the heads as drawn)."""
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            lecun_normal_(mod, generator)
        elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm2d)):
            mod.reset_parameters()
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, 0.02, generator=generator)
    for mod in model.modules():
        if isinstance(mod, GcnResBlock) and mod.use_cheby:
            for fc in (mod.fc1, mod.fc2):
                nn.init.xavier_uniform_(fc.weight, generator=generator)
    dec = model.decoder
    dec.unsample_layer.weight.copy_(assets.left.upsample_init)
    if cfg.model.zero_init_heads:
        dec.params_head.weight.zero_()
        dec.coord_head.weight.zero_()


def init_model(cfg: Config, assets: Assets,
               generator: torch.Generator | None = None,
               bbox_dim: int = 0) -> HandNet:
    """A `HandNet` whose parameters are drawn from `generator` (seed 0 when
    none is given), on the CPU in float32."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = build_model(cfg, assets, bbox_dim)
    _init_params(model, cfg, assets, generator)
    return model
