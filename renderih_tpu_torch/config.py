"""Single typed configuration for the PyTorch port.

The port's own copy of `renderih_tpu/config.py`: the same dataclass tree
and YAML layout, so one config file drives either package. The port has
no kernel switch (its kernels are the path on the card), so the JAX
package's `model.pallas_conv` is not a field here; YAML keys that name no
field are ignored by `load_config`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

import yaml


@dataclass
class ModelConfig:
    # Encoder: resnet18/34/50/101/152, vit_base, vit_large, hrnet_w*.
    encoder: str = "resnet50"
    # Per-scale channel width the encoder pyramid is projected to
    # (reference `DECONV_DIMS`, `utils/defaults.yaml:14`).
    deconv_dims: tuple = (256, 256, 256, 256)
    # Grid-token widths per decoder stage (reference `IMG_DIMS`).
    img_dims: tuple = (256, 128, 64)
    gcn_in_dims: tuple = (512, 256, 128)
    gcn_out_dims: tuple = (256, 128, 64)
    graph_k: int = 2
    graph_layer_num: int = 4
    num_attn_heads: int = 4
    dropout: float = 0.05
    # Dual-graph block flavour: False = MLP res-blocks (the flagship,
    # reference `DualGraph_lijun.py`), True = Chebyshev conv blocks
    # (legacy `models/model_attn/gcn.py`).
    use_cheby: bool = False
    # Decoder head: "graph" regresses verts directly
    # (`decoder_lijun_graph.py`); "mano" adds the MANO parameter regressor
    # (`decoder_lijun_newgraph.py` / `decoder_lijun_mano.py`).
    decoder: str = "graph"
    # Image-grid cross-attention token grid per stage.
    grid_size: int = 8
    img_size: int = 256
    freeze_upsample: bool = True
    # Auxiliary heatmap/mask/densepose heads (off in the flagship recipe,
    # matching `core/Loss.py:210-211`).
    with_aux_heads: bool = False
    # Paired L/R decoder execution: the JAX package's hand-stacked trunk.
    # The port builds the unpaired trunk under it (the same function and
    # checkpoint layout); a paired JAX tree loads into it.
    paired_lr: bool = False
    # Keep the dual-graph decoder in float32 even under the bf16 precision
    # policy. The decoder is a small fraction of the FLOPs (encoder convs
    # dominate) and regresses metric coordinates with sub-mm targets;
    # set False to run the decoder trunk in bf16 too (the coord/camera
    # heads always stay f32).
    decoder_f32: bool = True
    # Zero-initialize the coord/camera output heads so the decoder
    # starts AT the mean prediction instead of ~50x the target scale
    # (default head init gives |verts3d| ~ 2.5 m at step 0 vs
    # 0.05 m targets; the resulting shrink-everything transient floods
    # Adam's second moments). The reference uses xavier heads
    # (`decoder_lijun_graph.py:93-101`); keep False for init parity,
    # True is a training-dynamics lever (round-5 convergence work).
    zero_init_heads: bool = False


@dataclass
class DataConfig:
    interhand_path: str = ""
    syn_path: str = ""
    data_type: int = 0
    img_size: int = 256
    bone_length: float = 0.095  # reference `dataset/dataset_utils.py:9`
    # Augmentation ranges (reference `utils/defaults.yaml:34-37` +
    # `core/loader.py:31`).
    theta_range: tuple = (-90.0, 90.0)
    scale_range: tuple = (0.9, 1.1)
    uv_range: tuple = (0.0, 0.0)
    flip: bool = True
    noise: float = 0.0
    num_workers: int = 4


@dataclass
class TrainConfig:
    batch_size: int = 64  # per chip
    epochs: int = 200
    lr: float = 3.0e-4
    weight_decay: float = 1.0e-2
    warmup_epochs: int = 3
    lr_decay_step: int = 80
    lr_decay_gamma: float = 0.1
    optimizer: str = "adamw"
    seed: int = 88
    # Precision policy: "bf16" computes conv/attention in bfloat16 with
    # f32 params and f32 loss; "f32" is full float32.
    precision: str = "bf16"
    # ZeRO-1: shard optimizer state over the data axis.
    zero1: bool = True
    # Rematerialize encoder residual blocks in the backward pass
    # (memory-for-FLOPs; measured SLOWER at the flagship batch sizes
    # where memory is not binding — A/B knob, off by default).
    remat_encoder: bool = False
    # Gradient accumulation: split each per-step batch into this many
    # sequential micro-batches and apply the averaged
    # gradient once. Peak activation memory scales with the micro-batch;
    # step/LR/EMA/NaN-guard semantics are identical to one big batch
    # (BN statistics are chained through the micro-batches, the usual
    # accumulation-loop convention). batch_size % grad_accum == 0.
    grad_accum: int = 1
    # Skip (don't apply) any update whose loss is non-finite instead of
    # poisoning params/optimizer/BN state; reported per step as
    # `skipped_nonfinite`.
    nan_guard: bool = True
    # Exponential moving average of params (0 = off), checkpointed with
    # the state. The reference has no equivalent.
    ema_decay: float = 0.0
    save_gap: int = 10
    log_every: int = 50
    eval_every: int = 10
    # Device-resident training-data cache budget (MB) for single-device
    # runs; 0 disables.
    data_device_cache_mb: int = 2048
    # Render pred-vs-GT mesh overlays (PNG under {checkpoint_dir}/vis +
    # TensorBoard image when available) at every in-train eval — the
    # reference's render-to-TB scaffolding (`utils/tb_utils.py:48-111`).
    vis_every_eval: bool = True
    checkpoint_dir: str = "checkpoints"
    # Device mesh: data x model. model > 1 shards attention/MLP weights.
    mesh_data: int = -1  # -1 = all devices
    mesh_model: int = 1


@dataclass
class LossConfig:
    label_3d: float = 100.0
    label_2d: float = 50.0
    normal: float = 10.0
    edge: float = 2000.0
    norm_epoch: int = 50  # edge loss enabled from this epoch
    # Normal loss enabled from this epoch (0 = always on = reference
    # parity; see GraphLossWeights.normal_epoch for why a from-scratch
    # run wants this gated).
    normal_epoch: int = 0
    # Direct camera supervision weight (0 = off = reference parity).
    # GT (scale, trans2d) is refit per sample from the labels in closed
    # form (losses/graph_loss.py:fit_orthographic_cam) - the lever
    # against the scale->0 attractor (runs/convergence_r5/RECEIPT.md).
    camera: float = 0.0
    upsample: float = 1.0
    mano_pose: float = 0.5
    mano_shape: float = 0.01
    mano_rel: float = 1.0
    # Aux-head weights (reference `core/Loss.py:180-198`); only applied
    # when `model.with_aux_heads` is on AND the batch carries targets —
    # the flagship recipe has the heads off (`core/Loss.py:210-211`).
    mask: float = 500.0
    dense: float = 30.0
    hms: float = 100.0


@dataclass
class AssetConfig:
    # Converted npz assets (from tools/convert_assets.py). Empty string =>
    # deterministic synthetic assets (tests/benchmarks).
    mano_left: str = ""
    mano_right: str = ""
    graph_left: str = ""
    graph_right: str = ""
    upsample: str = ""
    dense_color: str = ""


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    assets: AssetConfig = field(default_factory=AssetConfig)


def _update(dc: Any, d: dict) -> Any:
    kwargs = {}
    for f in dataclasses.fields(dc):
        if f.name not in d:
            kwargs[f.name] = getattr(dc, f.name)
        elif dataclasses.is_dataclass(getattr(dc, f.name)):
            kwargs[f.name] = _update(getattr(dc, f.name), d[f.name])
        else:
            val = d[f.name]
            if isinstance(getattr(dc, f.name), tuple) and isinstance(val, list):
                val = tuple(val)
            kwargs[f.name] = val
    return type(dc)(**kwargs)


def load_config(path: str | None = None, overrides: dict | None = None) -> Config:
    cfg = Config()
    if path:
        with open(path) as f:
            cfg = _update(cfg, yaml.safe_load(f) or {})
    if overrides:
        cfg = _update(cfg, overrides)
    return cfg


def dump_config(cfg: Config, path: str) -> None:
    with open(path, "w") as f:
        yaml.safe_dump(dataclasses.asdict(cfg), f, sort_keys=False)
