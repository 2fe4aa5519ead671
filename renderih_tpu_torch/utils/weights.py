"""JAX-package variables -> the port's state_dict.

`state_dict_from_jax(params, batch_stats)` takes `HandNet`'s flax
variables as nested dicts of numpy arrays and returns the port's
state_dict (torch tensors, upstream torch key layout). It is the port's
own copy of the inverse mapping in
`renderih_tpu/utils/checkpoint_convert.py` (`_inv_*`,
`export_reference_checkpoint`), MLP decoder flavour:

  * flax Dense kernel (in, out)        -> Linear weight (out, in)
  * flax Conv kernel (kh, kw, in, out) -> Conv2d weight (out, in, kh, kw)
  * LayerNorm/BatchNorm scale, bias    -> weight, bias
  * BatchNorm stats mean, var          -> running_mean, running_var
  * MLP sub-blocks' auto names `LayerNorm_0`, `Dense_0`, `Dense_1`
    -> `layer_norm`, `fc1`, `fc2`

Each BatchNorm also gets `num_batches_tracked = 0`, so the result loads
with a strict `load_state_dict`.

The aux heads (`hms_head.*`, `dp_head.*`) and the MANO-parameter head
(`decoder.param_regressor.*`) have no upstream counterpart:
`export_reference_checkpoint` maps neither. Their names here are the JAX
modules': `{flat,up0,up1,up2}_{conv,bn}` and `final` in a head;
`dense.{0,1}` (flax's `Dense_0`/`Dense_1`), `{pose,shape}_fc{1,2}` in the
regressor.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _linear(sub, prefix, out):
    out[f"{prefix}.weight"] = _t(np.asarray(sub["kernel"]).T)
    if "bias" in sub:
        out[f"{prefix}.bias"] = _t(sub["bias"])


def _conv(sub, prefix, out):
    out[f"{prefix}.weight"] = _t(np.asarray(sub["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in sub:
        out[f"{prefix}.bias"] = _t(sub["bias"])


def _ln(sub, prefix, out):
    out[f"{prefix}.weight"] = _t(sub["scale"])
    out[f"{prefix}.bias"] = _t(sub["bias"])


def _bn(sub, stats, prefix, out):
    _ln(sub, prefix, out)
    out[f"{prefix}.running_mean"] = _t(stats["mean"])
    out[f"{prefix}.running_var"] = _t(stats["var"])
    out[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _mlp_res(sub, prefix, out):
    _ln(sub["LayerNorm_0"], f"{prefix}.layer_norm", out)
    _linear(sub["Dense_0"], f"{prefix}.fc1", out)
    _linear(sub["Dense_1"], f"{prefix}.fc2", out)


def _self_attn(sub, prefix, out):
    _ln(sub["LayerNorm_0"], f"{prefix}.layer_norm", out)
    for name in ("w_qs", "w_ks", "w_vs", "fc"):
        _linear(sub[name], f"{prefix}.{name}", out)
    _mlp_res(sub["ff"], f"{prefix}.ff", out)


def _img_ex(sub, prefix, out):
    enc = sub["encoder"]
    out[f"{prefix}.encoder.position_embeddings.weight"] = _t(enc["position_embeddings"])
    _conv(enc["proj"], f"{prefix}.encoder.proj", out)
    _self_attn(enc["self_attn"], f"{prefix}.encoder.self_attn", out)
    _linear(sub["grid_to_verts"], f"{prefix}.attn.fc", out)
    _self_attn(sub["attn"], f"{prefix}.attn.Attn", out)


def _inter_attn(sub, prefix, out):
    _self_attn(sub["L_self_attn"], f"{prefix}.L_self_attn_layer", out)
    _self_attn(sub["R_self_attn"], f"{prefix}.R_self_attn_layer", out)
    for name in ("w_qs", "w_ks", "w_vs", "fc"):
        _linear(sub[name], f"{prefix}.{name}", out)
    _ln(sub["norm1"], f"{prefix}.layer_norm1", out)
    _ln(sub["norm2"], f"{prefix}.layer_norm2", out)
    _mlp_res(sub["ffL"], f"{prefix}.ffL", out)
    _mlp_res(sub["ffR"], f"{prefix}.ffR", out)


def _gcn_block(sub, prefix, out):
    for name in ("norm1", "norm2", "norm3"):
        _ln(sub[name], f"{prefix}.{name}", out)
    for name in ("fc1", "fc2", "shortcut"):
        _linear(sub[name], f"{prefix}.{name}", out)


def _resnet(enc, stats, prefix, out):
    """flax `ResNet` subtree -> torchvision names under `prefix`."""
    _conv(enc["conv1"], f"{prefix}.conv1", out)
    _bn(enc["bn1"], stats["bn1"], f"{prefix}.bn1", out)
    for name, sub in enc.items():
        if not name.startswith("layer"):
            continue
        stage, idx = name[len("layer"):].split("_")
        tp = f"{prefix}.layer{stage}.{idx}"
        for i in (1, 2, 3):
            if f"conv{i}" in sub:
                _conv(sub[f"conv{i}"], f"{tp}.conv{i}", out)
                _bn(sub[f"bn{i}"], stats[name][f"bn{i}"], f"{tp}.bn{i}", out)
        if "downsample_conv" in sub:
            _conv(sub["downsample_conv"], f"{tp}.downsample.0", out)
            _bn(sub["downsample_bn"], stats[name]["downsample_bn"],
                f"{tp}.downsample.1", out)


def _mid(mid, stats, prefix, out):
    """flax `ResNetMid` subtree -> `{prefix}.convs.{i}.{0,2}`."""
    i = 0
    while f"proj{i}_conv" in mid:
        _conv(mid[f"proj{i}_conv"], f"{prefix}.convs.{i}.0", out)
        _bn(mid[f"proj{i}_bn"], stats[f"proj{i}_bn"], f"{prefix}.convs.{i}.2", out)
        i += 1


def _param_regressor(reg, prefix, out):
    """flax `ParamRegressor` subtree -> the port's names under `prefix`."""
    for i in (0, 1):
        _linear(reg[f"Dense_{i}"], f"{prefix}.dense.{i}", out)
    for name in ("pose_fc1", "pose_fc2", "shape_fc1", "shape_fc2"):
        _linear(reg[name], f"{prefix}.{name}", out)


def _decoder(dec, prefix, out):
    """flax `GraphDecoder` subtree -> upstream decoder names under `prefix`."""
    for side in ("left", "right"):
        _linear(dec[f"gf_layer_{side}_fc"], f"{prefix}.gf_layer_{side}.0", out)
        _ln(dec[f"gf_layer_{side}_ln"], f"{prefix}.gf_layer_{side}.1", out)
    for name in ("coord_head", "avg_head", "params_head"):
        _linear(dec[name], f"{prefix}.{name}", out)
    out[f"{prefix}.unsample_layer.weight"] = _t(dec["upsample_weight"])
    if "param_regressor" in dec:
        _param_regressor(dec["param_regressor"], f"{prefix}.param_regressor", out)
    for lname, layer in dec["dual_gcn"].items():
        lp = f"{prefix}.dual_gcn.layers.{lname.split('_')[1]}"
        out[f"{lp}.position_embeddings.weight"] = _t(layer["position_embeddings"])
        for side in ("left", "right"):
            _img_ex(layer[f"img_ex_{side}"], f"{lp}.img_ex_{side}", out)
            for bname, block in layer[f"graph_{side}"].items():
                _gcn_block(block,
                           f"{lp}.graph_{side}.GCN_blocks.{bname.split('_')[1]}",
                           out)
        _inter_attn(layer["inter_attn"], f"{lp}.attn", out)


def _aux_head(head, stats, prefix, out):
    """flax `AuxDecoderHead` subtree -> the port's names under `prefix`."""
    for name in ("flat", "up0", "up1", "up2"):
        _conv(head[f"{name}_conv"], f"{prefix}.{name}_conv", out)
        _bn(head[f"{name}_bn"], stats[f"{name}_bn"], f"{prefix}.{name}_bn", out)
    _conv(head["final"], f"{prefix}.final", out)


def state_dict_from_jax(params: dict, batch_stats: dict) -> dict:
    """flax (params, batch_stats) of `HandNet` -> the port's state_dict."""
    out: dict = {}
    _resnet(params["encoder"], batch_stats["encoder"], "encoder.resnet", out)
    _mid(params["mid"], batch_stats["mid"], "mid_model", out)
    _decoder(params["decoder"], "decoder", out)
    for head in ("hms_head", "dp_head"):
        if head in params:
            _aux_head(params[head], batch_stats[head], head, out)
    return out
