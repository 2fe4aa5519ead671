"""Top-level two-hand network: encoder -> mid -> dual-graph decoder
(counterpart of `renderih_tpu/models/model.py`).

`HandNet.forward` takes NHWC `(B, H, W, 3)` normalised images, like the
JAX package; the encoder runs on the NCHW view of that tensor, which is
`channels_last` in memory. Parameter names are the upstream torch
state_dict's (`encoder.resnet.*`, `mid_model.convs.*`, `decoder.*`), the
layout `utils/weights.py:state_dict_from_jax` produces.

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
from renderih_tpu_torch.models.resnet import AuxDecoderHead, ResNet, ResNetMid


class ResNetEncoder(nn.Module):
    """Holds the trunk as `resnet`, the upstream `encoder.resnet.*` layout."""

    def __init__(self, model_type: str):
        super().__init__()
        self.resnet = ResNet(model_type)

    def forward(self, x: torch.Tensor) -> list:
        return self.resnet(x)


def _check_supported(cfg: Config) -> None:
    m = cfg.model
    missing = [name for name, on in (
        (f"encoder={m.encoder}", not m.encoder.startswith("resnet")),
        ("paired_lr", m.paired_lr),
        ("use_cheby", m.use_cheby),
        (f"decoder={m.decoder}", m.decoder not in ("graph", "mano")),
    ) if on]
    if missing:
        raise NotImplementedError(
            f"not ported yet: {', '.join(missing)} (the port runs the ResNet "
            "encoders with the MLP graph or mano decoder; see ROADMAP.md)")


class HandNet(nn.Module):
    """Encoder + mid projection + two-hand graph decoder."""

    def __init__(self, cfg: Config, verts_nums: tuple, bbox_dim: int = 0):
        super().__init__()
        _check_supported(cfg)
        m = cfg.model
        self.dtype = torch.bfloat16 if cfg.train.precision == "bf16" else torch.float32
        self.encoder = ResNetEncoder(m.encoder)
        pyramid_dims = self.encoder.resnet.pyramid_dims
        self.mid_model = ResNetMid(pyramid_dims, tuple(m.deconv_dims))
        self.decoder = GraphDecoder(
            verts_nums=tuple(verts_nums),
            global_dim=pyramid_dims[0],
            img_dims=tuple(m.deconv_dims),
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
        )
        self.hms_head = self.dp_head = None
        if m.with_aux_heads:
            self.hms_head = AuxDecoderHead(pyramid_dims[0], 42)
            self.dp_head = AuxDecoderHead(pyramid_dims[0], 7)

    def forward(self, img: torch.Tensor, pe_left: torch.Tensor,
                pe_right: torch.Tensor,
                bbox_info: torch.Tensor | None = None, aux: bool = False) -> DecoderOutput:
        """img: (B, H, W, 3) ImageNet-normalised RGB. With `aux` (and the
        aux heads built) the output's `aux` holds the heads' float32
        predictions, NHWC: 'hms' (B, S, S, 42), 'mask' (B, S, S) and
        'dense' (B, S, S, 6), S = img_size / 4."""
        x = img.to(self.dtype).permute(0, 3, 1, 2)  # NCHW view, channels_last
        pyramid = self.encoder(x)
        # The decoder reads the first len(verts_nums) maps. Training projects
        # all of them, as the JAX package does: the unread map's BatchNorm
        # still updates its running statistics there.
        n_levels = None if self.training else len(self.decoder.verts_nums)
        global_feature, fmaps = self.mid_model(pyramid, n_levels)
        used = fmaps[:len(self.decoder.verts_nums)]
        out = self.decoder(global_feature.float(), [f.float() for f in used],
                           pe_left, pe_right, bbox_info)
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
    return HandNet(cfg, assets.left.verts_nums, bbox_dim)


def model_call_kwargs(assets: Assets, device: torch.device | str = "cpu") -> dict:
    """The static-asset arguments of `HandNet.forward`, on `device`."""
    return dict(pe_left=assets.left.pe.to(device),
                pe_right=assets.right.pe.to(device))


# std of a unit normal cut at ±2: flax's `variance_scaling` divides by it
# so that the cut draw keeps the asked-for variance
_TRUNC_NORMAL_STD = 0.87962566103423978


@torch.no_grad()
def _init_params(model: HandNet, cfg: Config, assets: Assets,
                 generator: torch.Generator) -> None:
    """Draw every parameter from `generator` with the JAX package's init
    rules (flax defaults): conv and linear weights flax's `lecun_normal`
    (a normal cut at ±2σ, σ rescaled so the variance is 1/fan_in), biases
    0, norms at identity, BN statistics (0, 1), position embeddings
    normal(0, 0.02), the upsample from the assets' initializer and, under
    `zero_init_heads`, zero coord/params head weights. The aux heads and
    the MANO regressor follow the same rules (`zero_init_heads` leaves
    them as drawn)."""
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            fan_in = mod.weight[0].numel()
            std = fan_in ** -0.5 / _TRUNC_NORMAL_STD
            nn.init.trunc_normal_(mod.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm2d)):
            mod.reset_parameters()
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, 0.02, generator=generator)
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
