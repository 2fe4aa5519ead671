"""JAX-package variables -> the port's state_dict.

`state_dict_from_jax(params, batch_stats)` takes `HandNet`'s flax
variables as nested dicts of numpy arrays and returns the port's
state_dict (torch tensors, upstream torch key layout). It is the port's
own copy of the inverse mapping in
`renderih_tpu/utils/checkpoint_convert.py` (`_inv_*`,
`export_reference_checkpoint`), both decoder flavours (`use_cheby`), and
of `convert_reference_hrnet` and `convert_vit_wrapper` for the HRNet and
ViT encoders. A paired JAX tree (`paired_lr`: `graph_pair`,
`img_ex_pair`, `LR_self_attn`, leaves stacked [left, right]) is unstacked
into the upstream left/right keys, which the port's model (paired or
not: one trunk) reads:

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

The library modules outside `HandNet` (`models/{ktd,experimental_attn,
aux_nets}.py`, `losses/adapt.py`'s discriminator, the GAN pose prior's
`PoseDiscriminator`) keep the JAX modules' names; `flax_module_state_dict`
maps any of them, `ktd_state_dict_from_jax` and
`aux_net_state_dict_from_jax` with their indexed families renamed.
"""

from __future__ import annotations

import re

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


def _hand(tree, i: int):
    """Hand i of a paired (hand-stacked) JAX subtree: every leaf's [i]."""
    if isinstance(tree, dict):
        return {k: _hand(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _sides(layer, left: str, right: str, pair: str) -> dict:
    """{left name: subtree, right name: subtree} of a stage, unstacked from
    its paired subtree (`paired_lr`: leaves (2, ...), [left, right]) when
    it has one."""
    if pair in layer:
        return {left: _hand(layer[pair], 0), right: _hand(layer[pair], 1)}
    return {left: layer[left], right: layer[right]}


def _inter_attn(sub, prefix, out):
    pair = _sides(sub, "L_self_attn", "R_self_attn", "LR_self_attn")
    _self_attn(pair["L_self_attn"], f"{prefix}.L_self_attn_layer", out)
    _self_attn(pair["R_self_attn"], f"{prefix}.R_self_attn_layer", out)
    for name in ("w_qs", "w_ks", "w_vs", "fc"):
        _linear(sub[name], f"{prefix}.{name}", out)
    _ln(sub["norm1"], f"{prefix}.layer_norm1", out)
    _ln(sub["norm2"], f"{prefix}.layer_norm2", out)
    _mlp_res(sub["ffL"], f"{prefix}.ffL", out)
    _mlp_res(sub["ffR"], f"{prefix}.ffR", out)


def _gcn_block(sub, prefix, out):
    """MLP or Chebyshev block; a Chebyshev kernel (in * K, out) is upstream's
    `fc{1,2}` Linear transposed (`checkpoint_convert.py:_inv_gcn_block`)."""
    for name in ("norm1", "norm2", "norm3"):
        _ln(sub[name], f"{prefix}.{name}", out)
    _linear(sub["shortcut"], f"{prefix}.shortcut", out)
    for i in (1, 2):
        if f"cheby{i}_kernel" in sub:
            _linear({"kernel": sub[f"cheby{i}_kernel"], "bias": sub[f"cheby{i}_bias"]},
                    f"{prefix}.fc{i}", out)
        else:
            _linear(sub[f"fc{i}"], f"{prefix}.fc{i}", out)


def _block(sub, stats, prefix, out):
    """flax `BasicBlock`/`Bottleneck` -> torchvision names under `prefix`."""
    for i in (1, 2, 3):
        if f"conv{i}" in sub:
            _conv(sub[f"conv{i}"], f"{prefix}.conv{i}", out)
            _bn(sub[f"bn{i}"], stats[f"bn{i}"], f"{prefix}.bn{i}", out)
    if "downsample_conv" in sub:
        _conv(sub["downsample_conv"], f"{prefix}.downsample.0", out)
        _bn(sub["downsample_bn"], stats["downsample_bn"], f"{prefix}.downsample.1", out)


def _resnet(enc, stats, prefix, out):
    """flax `ResNet` subtree -> torchvision names under `prefix`."""
    _conv(enc["conv1"], f"{prefix}.conv1", out)
    _bn(enc["bn1"], stats["bn1"], f"{prefix}.bn1", out)
    for name, sub in enc.items():
        if name.startswith("layer"):
            stage, idx = name[len("layer"):].split("_")
            _block(sub, stats[name], f"{prefix}.layer{stage}.{idx}", out)


def _hrnet(enc, stats, prefix, out):
    """flax `HRNetEncoder` subtree -> upstream HighResolutionNet names
    under `prefix`: stem{1,2} -> conv/bn{1,2}; trans{s}_{n} ->
    transition{s}.{n}[.0] (every transition but the first wraps its conv
    in one more Sequential); branch{b}_block{k} -> branches.{b}.{k};
    fuse{j}to{i}_conv[{k}] -> fuse_layers.{i}.{j}[.{k}].0 with its BN at .1."""
    for i in (1, 2):
        _conv(enc[f"stem{i}"]["conv"], f"{prefix}.conv{i}", out)
        _bn(enc[f"stem{i}"]["bn"], stats[f"stem{i}"]["bn"], f"{prefix}.bn{i}", out)
    for name, sub in enc.items():
        st = stats[name]
        if name.startswith("layer1_"):
            _block(sub, st, f"{prefix}.layer1.{name[len('layer1_'):]}", out)
        elif name.startswith("trans"):
            stage, n = name[len("trans"):].split("_")
            tp = f"{prefix}.transition{stage}.{n}" + ("" if n == "0" else ".0")
            _conv(sub["conv"], f"{tp}.0", out)
            _bn(sub["bn"], st["bn"], f"{tp}.1", out)
        elif name.startswith("stage"):
            stage, m = name[len("stage"):].split("_m")
            mp = f"{prefix}.stage{stage}.{m}"
            for key, part in sub.items():
                if key.startswith("branch"):
                    b, k = key[len("branch"):].split("_block")
                    _block(part, st[key], f"{mp}.branches.{b}.{k}", out)
                elif "_conv" in key:
                    j, rest = key[len("fuse"):].split("to")
                    i, k = rest.split("_conv")
                    fp = f"{mp}.fuse_layers.{i}.{j}" + (f".{k}" if k else "")
                    bn = key.replace("_conv", "_bn")
                    _conv(part, f"{fp}.0", out)
                    _bn(sub[bn], st[bn], f"{fp}.1", out)


def _hrnet_mid(mid, stats, prefix, out):
    """flax `HRNetMid` subtree -> upstream `hrnet_mid` names under `prefix`."""
    _mid(mid, stats, prefix, out)
    for i in range(4):
        _block(mid[f"incre{i}"], stats[f"incre{i}"], f"{prefix}.incre_modules.{i}.0", out)
    for i in range(3):
        _conv(mid[f"down{i}_conv"], f"{prefix}.downsamp_modules.{i}.0", out)
        _bn(mid[f"down{i}_bn"], stats[f"down{i}_bn"], f"{prefix}.downsamp_modules.{i}.1", out)
    _conv(mid["final_conv"], f"{prefix}.final_layer.0", out)
    _bn(mid["final_bn"], stats["final_bn"], f"{prefix}.final_layer.1", out)


def _vit_block(blk, prefix, out):
    """flax `ViTBlock` -> timm's block names under `prefix`."""
    _ln(blk["norm1"], f"{prefix}.norm1", out)
    _linear(blk["qkv"], f"{prefix}.attn.qkv", out)
    _linear(blk["proj"], f"{prefix}.attn.proj", out)
    _ln(blk["norm2"], f"{prefix}.norm2", out)
    _linear(blk["mlp_fc1"], f"{prefix}.mlp.fc1", out)
    _linear(blk["mlp_fc2"], f"{prefix}.mlp.fc2", out)


def _pooled_kv(ds, prefix, out):
    """flax `PooledKVAttention` -> `Myattention`'s names under `prefix`."""
    for name in ("fc0", "q", "kv", "linear1", "linear2"):
        _linear(ds[name], f"{prefix}.{name}", out)
    _conv(ds["sr"], f"{prefix}.sr", out)
    _ln(ds["norm"], f"{prefix}.norm", out)


def _vit(enc, out):
    """flax `ViTEncoder` subtree -> the upstream ViT wrapper's names: the
    trunk under `encoder.`, its stride-8 `patch_embed`, `conv1` and
    `downsample` at the top level."""
    _conv(enc["patch_embed"]["proj"], "encoder.patch_embed.proj", out)
    i = 0
    while f"block_{i}" in enc:
        _vit_block(enc[f"block_{i}"], f"encoder.blocks.{i}", out)
        i += 1
    _ln(enc["last_norm"], "encoder.last_norm", out)
    _conv(enc["patch_embed8"]["proj"], "patch_embed.proj", out)
    _conv(enc["conv1"], "conv1", out)
    _pooled_kv(enc["downsample"], "downsample", out)


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
        img_ex = _sides(layer, "img_ex_left", "img_ex_right", "img_ex_pair")
        graph = _sides(layer, "graph_left", "graph_right", "graph_pair")
        for side in ("left", "right"):
            _img_ex(img_ex[f"img_ex_{side}"], f"{lp}.img_ex_{side}", out)
            for bname, block in graph[f"graph_{side}"].items():
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
    enc = params["encoder"]
    if "block_0" in enc:  # ViT: no BatchNorm, no mid parameters
        _vit(enc, out)
    elif "stem1" in enc:
        _hrnet(enc, batch_stats["encoder"], "encoder.hrnet", out)
        _hrnet_mid(params["mid"], batch_stats["mid"], "mid_model", out)
    else:
        _resnet(enc, batch_stats["encoder"], "encoder.resnet", out)
        _mid(params["mid"], batch_stats["mid"], "mid_model", out)
    _decoder(params["decoder"], "decoder", out)
    for head in ("hms_head", "dp_head"):
        if head in params:
            _aux_head(params[head], batch_stats[head], head, out)
    return out


def flax_module_state_dict(params: dict, rename=None) -> dict:
    """A flax module's params (nested numpy) -> the state_dict of the port's
    module of the same names: a Dense {kernel (in, out), bias} -> Linear, a
    Conv {kernel (kh, kw, in, out), bias} -> Conv2d, a norm {scale, bias} ->
    weight, bias, a `SelfAttn` or `MlpResBlock` subtree -> the decoder's
    names (`_self_attn`, `_mlp_res`), any other leaf as it is. `rename`
    maps a flax module name to the port's (an indexed family to a
    ModuleList's entry, say)."""
    rename = rename or (lambda name: name)
    out: dict = {}

    def walk(tree, prefix):
        for name, sub in tree.items():
            key = f"{prefix}{rename(name)}"
            if not isinstance(sub, dict):
                out[key] = _t(sub)
            elif "kernel" in sub:
                (_linear if np.ndim(sub["kernel"]) == 2 else _conv)(sub, key, out)
            elif "scale" in sub:
                _ln(sub, key, out)
            elif "w_qs" in sub and "ff" in sub:
                _self_attn(sub, key, out)
            elif set(sub) == {"LayerNorm_0", "Dense_0", "Dense_1"}:
                _mlp_res(sub, key, out)
            else:
                walk(sub, key + ".")

    walk(params, "")
    return out


def _indexed(*families: str):
    """rename for flax's `{family}{i}` names -> a ModuleList's `{family}.{i}`."""
    pattern = re.compile(rf"^({'|'.join(families)})(\d+)$")
    return lambda name: pattern.sub(r"\1.\2", name)


def ktd_state_dict_from_jax(params: dict) -> dict:
    """flax `KTDHead` params -> `models/ktd.py:KTDHead`'s state_dict."""
    return flax_module_state_dict(params, _indexed("joint_reg"))


def aux_net_state_dict_from_jax(params: dict) -> dict:
    """flax params of an `aux_nets` module (FPN, CBAM, HourglassHead,
    CrossHandInjection, PoseDiscriminator) -> the port module's state_dict."""
    fpn = _indexed("lateral", "smooth")
    cbam = {"Dense_0": "mlp.0", "Dense_1": "mlp.2"}
    block = re.compile(r"^(\w+)_(conv|gn)$")
    return flax_module_state_dict(
        params, lambda name: cbam.get(name) or block.sub(r"blocks.\1.\2", fpn(name)))
