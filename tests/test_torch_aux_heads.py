"""The aux heads (`with_aux_heads`) of the port against the JAX package on
the CPU: `AuxDecoderHead` alone, `HandNet` with its heads (and the MANO
regressor of `decoder="mano"`), `aux_losses`, `synthetic_aux_targets`, the
weight converter and the `--torch_ckpt` loader. Config: resnet18 at 128²,
grid 4, f32; the same weights (carried
with `state_dict_from_jax`) and seeded numpy inputs through both; JAX at
`highest` matmul precision (tests/conftest.py).

Tolerances: outputs within 1e-4 of their largest |value| (the slice's bar,
PARITY.md:14); BatchNorm running statistics within 1e-5 of each buffer's
largest value; loss terms within 1e-5 relative; heatmap targets within
1e-5; rendered masks and densepose targets as the rasteriser's own test
holds them (tests/test_torch_render.py: coverage equal on >= 99.9% of the
pixels, values within 1e-4 where it is)."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderih_tpu.assets import make_synthetic_assets as jax_assets
from renderih_tpu.config import load_config as jax_load_config
from renderih_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from renderih_tpu.losses.graph_loss import aux_losses as jax_aux_losses
from renderih_tpu.models import build_model as jax_build_model
from renderih_tpu.models import model_call_kwargs as jax_call_kwargs
from renderih_tpu.models.resnet import AuxDecoderHead as JaxAuxDecoderHead
from renderih_tpu_torch.apps.weights import add_weight_args, load_eval_weights
from renderih_tpu_torch.assets import make_synthetic_assets
from renderih_tpu_torch.config import load_config
from renderih_tpu_torch.data.interhand import make_synthetic_packed
from renderih_tpu_torch.data.synthetic import synthetic_aux_targets
from renderih_tpu_torch.eval.evaluator import evaluate_packed
from renderih_tpu_torch.losses.graph_loss import aux_losses
from renderih_tpu_torch.models import build_model, init_model, model_call_kwargs
from renderih_tpu_torch.models.resnet import AuxDecoderHead
from renderih_tpu_torch.serve import InferenceEngine
from renderih_tpu_torch.utils import weights
from renderih_tpu_torch.utils.weights import state_dict_from_jax

SIZE = 128
SMALL = {
    "model": {"encoder": "resnet18", "img_size": SIZE, "grid_size": 4,
              "gcn_in_dims": [64, 32, 16], "gcn_out_dims": [32, 16, 8],
              "img_dims": [32, 16, 8], "deconv_dims": [32, 32, 32, 32],
              "graph_layer_num": 2, "with_aux_heads": True, "decoder": "mano"},
    "train": {"precision": "f32"},
}
BN_BUFFERS = (".running_mean", ".running_var")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _random_stats(tree, seed: int):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 1.5, a.shape) if path[-1].key == "var"
                         else rng.normal(0.0, 0.1, a.shape)).astype(np.float32), tree)


def _assert_close(got: torch.Tensor, want, rel: float = 1e-4):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert np.abs(got.detach().numpy() - want).max() <= rel * np.abs(want).max()


@pytest.fixture(scope="module")
def small():
    """JAX `HandNet` with aux heads and the MANO regressor at the small config, its variables
    (random BatchNorm statistics), and the port's model on the same weights."""
    jcfg = jax_load_config(overrides=SMALL)
    jassets = jax_assets(0)
    jmodel = jax_build_model(jcfg, jassets)
    variables = jax.jit(lambda key: jmodel.init(
        key, jnp.zeros((1, SIZE, SIZE, 3)), train=False,
        **jax_call_kwargs(jcfg, jassets)))(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = _random_stats(variables["batch_stats"], 0)
    cfg = load_config(overrides=SMALL)
    assets = make_synthetic_assets(0)
    model = build_model(cfg, assets)
    model.load_state_dict(state_dict_from_jax(params, stats))
    return dict(jcfg=jcfg, jassets=jassets, jmodel=jmodel, params=params, stats=stats,
                cfg=cfg, assets=assets, model=model.eval())


@pytest.mark.parametrize("out_dim", [42, 7])
@pytest.mark.parametrize("train", [False, True])
def test_aux_decoder_head_matches_jax(out_dim, train):
    """The head alone on a (2, 4, 4, 512) map (resnet18's C5 at 128²), in
    eval mode on random running statistics and in train mode: outputs, and
    in train mode the running statistics after the update."""
    x = np.random.default_rng(out_dim).normal(size=(2, 4, 4, 512)).astype(np.float32)
    jhead = JaxAuxDecoderHead(out_dim=out_dim)
    variables = jhead.init(jax.random.PRNGKey(out_dim), jnp.asarray(x))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = _random_stats(variables["batch_stats"], out_dim)
    want, mutated = jhead.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                                train=train, mutable=["batch_stats"])
    sd = {}
    weights._aux_head(params, stats, "head", sd)
    head = AuxDecoderHead(512, out_dim)
    head.load_state_dict({k.removeprefix("head."): v for k, v in sd.items()})
    head.train(train)
    with torch.no_grad():
        got = head(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == (2, 32, 32, out_dim)
    _assert_close(got, want)
    new = {}
    weights._aux_head(params, jax.tree_util.tree_map(np.asarray, mutated["batch_stats"]),
                      "head", new)
    for k, v in head.state_dict().items():
        if k.endswith(BN_BUFFERS):
            ref = new[f"head.{k}"].numpy()
            assert np.abs(v.numpy() - ref).max() <= 1e-5 * np.abs(ref).max(), k
            if not train:
                np.testing.assert_array_equal(v.numpy(), sd[f"head.{k}"].numpy())


@pytest.mark.parametrize("out_dim", [42, 7])
@pytest.mark.parametrize("train", [False, True])
def test_aux_decoder_head_backward_matches_jax(out_dim, train, monkeypatch):
    """The head's backward alone, each side on its own ReLU branches: both
    in float64 (JAX under `enable_x64`, the head's dtype float64), where
    every ReLU input of the port's forward lies >= 1e-10 from 0, far
    beyond the two sides' rounding. The gradients of sum(out · r) with
    respect to the input and to every parameter within 1e-6 of each
    tensor's largest |value| (the parameters' come through the float32
    converter)."""
    rng = np.random.default_rng(10 + out_dim)
    x = rng.normal(size=(2, 4, 4, 512))
    r = rng.normal(size=(2, 32, 32, out_dim))
    with jax.enable_x64(True):
        jhead = JaxAuxDecoderHead(out_dim=out_dim, dtype=jnp.float64)
        variables = jhead.init(jax.random.PRNGKey(out_dim), jnp.asarray(x))
        params = jax.tree_util.tree_map(np.asarray, variables["params"])  # float32 values
        stats = _random_stats(variables["batch_stats"], out_dim)
        wide = lambda tree: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)

        def loss(p, xx):
            out = jhead.apply({"params": p, "batch_stats": wide(stats)}, xx, train=train,
                              mutable=["batch_stats"] if train else False)
            return jnp.sum((out[0] if train else out) * r)

        g_params, g_x = jax.grad(loss, argnums=(0, 1))(wide(params), jnp.asarray(x))
        g_params = jax.tree_util.tree_map(np.asarray, g_params)
        g_x = np.asarray(g_x)
    sd, want = {}, {}
    weights._aux_head(params, stats, "head", sd)
    weights._aux_head(g_params, stats, "head", want)
    head = AuxDecoderHead(512, out_dim).double()
    head.load_state_dict({k.removeprefix("head."): v for k, v in sd.items()})
    head.train(train)
    relu_gap = []
    relu = torch.nn.functional.relu

    def traced_relu(h, inplace=False):
        relu_gap.append(float(h.detach().abs().min()))
        return relu(h, inplace=inplace)

    monkeypatch.setattr(torch.nn.functional, "relu", traced_relu)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    out = head(xt).permute(0, 2, 3, 1)
    (out * torch.from_numpy(r)).sum().backward()
    assert len(relu_gap) == 4 and min(relu_gap) >= 1e-10, relu_gap
    _assert_close(xt.grad.permute(0, 2, 3, 1), g_x, rel=1e-6)
    for name, p in head.named_parameters():
        _assert_close(p.grad.float(), want[f"head.{name}"].numpy(), rel=1e-6)


def test_handnet_with_aux_heads_matches_jax(small):
    img = np.random.default_rng(1).normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: small["jmodel"].apply(
        v, x, train=False, **jax_call_kwargs(small["jcfg"], small["jassets"])))(
        {"params": small["params"], "batch_stats": small["stats"]}, img)
    with torch.no_grad():
        out = small["model"](torch.from_numpy(img), aux=True,
                             **model_call_kwargs(small["assets"]))
    s = SIZE // 4
    assert out.aux["hms"].shape == (2, s, s, 42) and out.aux["dense"].shape == (2, s, s, 6)
    for key in ("hms", "mask", "dense"):
        _assert_close(out.aux[key], want.aux[key])
    for key in ("verts3d", "verts2d", "scale", "trans2d", "mano_pose", "mano_shape"):
        for hand in ("left", "right"):
            _assert_close(getattr(out, key)[hand], getattr(want, key)[hand])


def test_forward_runs_the_aux_heads_only_when_asked(small):
    model = small["model"]
    img = torch.from_numpy(np.random.default_rng(2).normal(
        size=(1, SIZE, SIZE, 3)).astype(np.float32))
    calls = []
    hooks = [getattr(model, h).register_forward_hook(lambda *a, h=h: calls.append(h))
             for h in ("hms_head", "dp_head")]
    try:
        with torch.no_grad():
            plain = model(img, **model_call_kwargs(small["assets"]))
            assert plain.aux is None and not calls
            with_aux = model(img, aux=True, **model_call_kwargs(small["assets"]))
    finally:
        for hook in hooks:
            hook.remove()
    assert calls == ["hms_head", "dp_head"]
    torch.testing.assert_close(plain.verts3d["left"], with_aux.verts3d["left"], rtol=0, atol=0)


def test_serve_and_eval_run_no_aux_head(small, tmp_path):
    """`InferenceEngine` and `evaluate_packed` on the aux config never run a
    head, and the engine's outputs equal those of an engine without heads
    on the same trunk and decoder weights."""
    sd = state_dict_from_jax(small["params"], small["stats"])
    engine = InferenceEngine(small["cfg"], assets=small["assets"], state_dict=sd,
                             buckets=(2,), device="cpu")
    calls = []
    for h in ("hms_head", "dp_head"):
        getattr(engine.model, h).register_forward_hook(lambda *a, h=h: calls.append(h))
    cfg_off = load_config(overrides={**SMALL, "model": {**SMALL["model"],
                                                        "with_aux_heads": False}})
    plain = InferenceEngine(cfg_off, assets=small["assets"], buckets=(2,), device="cpu",
                            state_dict={k: v for k, v in sd.items()
                                        if not k.startswith(("hms_head.", "dp_head."))})
    imgs = np.random.default_rng(3).integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    got, want = engine.predict(imgs), plain.predict(imgs)
    for key, ref in want.items():
        np.testing.assert_array_equal(got[key], ref, err_msg=key)
    split = make_synthetic_packed(str(tmp_path), "test", small["assets"], n=2, seed=0)
    cfg256 = load_config(overrides={**SMALL, "model": {**SMALL["model"], "img_size": 256}})
    model = init_model(cfg256, small["assets"])
    for h in ("hms_head", "dp_head"):
        getattr(model, h).register_forward_hook(lambda *a, h=h: calls.append(h))
    summary = evaluate_packed(cfg256, model, small["assets"], split, batch_size=2,
                              device="cpu")
    assert np.isfinite(summary["mpjpe_mm"])
    assert not calls


def _aux_inputs(seed: int, s: int = 16) -> tuple[dict, dict]:
    rng = np.random.default_rng(seed)
    aux = {"hms": rng.normal(0, 0.3, (2, s, s, 42)), "mask": rng.normal(0.5, 0.5, (2, s, s)),
           "dense": rng.normal(0.5, 0.2, (2, s, s, 6))}
    mask_l = (rng.uniform(size=(2, s, s)) < 0.3).astype(np.float32)
    mask_r = (rng.uniform(size=(2, s, s)) < 0.3).astype(np.float32)
    batch = {"hms": rng.uniform(0, 1, (2, s, s, 42)), "mask": np.maximum(mask_l, mask_r),
             "mask_left": mask_l, "mask_right": mask_r,
             "dense": rng.uniform(0, 1, (2, s, s, 6)) * np.maximum(mask_l, mask_r)[..., None]}
    f32 = lambda d: {k: np.asarray(v, np.float32) for k, v in d.items()}
    return f32(aux), f32(batch)


@pytest.mark.parametrize("targets", [
    ("hms", "mask", "dense", "mask_left", "mask_right"),  # per-hand gating
    ("mask", "dense"),  # dense gated by the union silhouette
    ("dense",),  # ungated
    ("hms",)])
def test_aux_losses_match_jax(targets):
    aux, full = _aux_inputs(len(targets))
    batch = {k: full[k] for k in targets}
    w = dict(w_mask=500.0, w_dense=30.0, w_hms=100.0)
    got = aux_losses({k: torch.from_numpy(v) for k, v in aux.items()},
                     {k: torch.from_numpy(v) for k, v in batch.items()}, **w)
    want = jax_aux_losses({k: jnp.asarray(v) for k, v in aux.items()},
                          {k: jnp.asarray(v) for k, v in batch.items()}, **w)
    assert set(got) == set(want) == {k for k in ("hms", "mask", "dense") if k in targets} | {
        "total"}
    for k, ref in want.items():
        assert abs(float(got[k]) - float(ref)) <= 1e-5 * abs(float(ref)), k


def test_synthetic_aux_targets_match_jax(small):
    """The JAX synthetic batch's cameras, vertices and joints (two hands in
    one scene, which fill most of the frame) through both target makers
    (S = 32)."""
    jb = jax_synthetic_batch(small["jassets"], jax.random.PRNGKey(4), batch_size=3,
                             img_size=SIZE, with_aux=True, with_cam=True, scene=True)
    t = lambda k: torch.from_numpy(np.array(jb[k]))
    got = synthetic_aux_targets(
        small["assets"], SIZE, {h: t(f"cam_scale_{h}") for h in ("left", "right")},
        {h: t(f"cam_trans_{h}") for h in ("left", "right")},
        {h: t(f"v3d_{h}") for h in ("left", "right")},
        {h: t(f"j2d_{h}") for h in ("left", "right")})
    assert set(got) == {"hms", "mask", "mask_left", "mask_right", "dense"}
    s = SIZE // 4
    np.testing.assert_allclose(got["hms"].numpy(), np.asarray(jb["hms"]), atol=1e-5)
    for key in ("mask", "mask_left", "mask_right"):
        mask, want = got[key].numpy(), np.asarray(jb[key])
        assert mask.shape == (3, s, s) and set(np.unique(mask)) <= {0.0, 1.0}
        assert (mask == want).mean() >= 0.999, key
        assert 0.01 < want.mean() < 0.9
    agree = (got["mask_left"].numpy() == np.asarray(jb["mask_left"]))[..., None] & (
        got["mask_right"].numpy() == np.asarray(jb["mask_right"]))[..., None]
    agree = np.broadcast_to(agree, got["dense"].shape)
    np.testing.assert_allclose(got["dense"].numpy()[agree], np.asarray(jb["dense"])[agree],
                               atol=1e-4)


def test_state_dict_from_jax_maps_every_new_parameter(small):
    """Aux heads and the MANO regressor: the converter's keys are exactly
    the port's (a strict load) and carry JAX's values."""
    sd = state_dict_from_jax(small["params"], small["stats"])
    model = build_model(small["cfg"], small["assets"])
    missing, unexpected = model.load_state_dict(sd, strict=True)
    assert not missing and not unexpected
    new = [k for k in sd if k.startswith(("hms_head.", "dp_head.", "decoder.param_regressor."))]
    # a head: 5 conv weights, the final bias, 4 BatchNorms of 5 entries; 6 Dense layers
    assert len(new) == 2 * (5 + 1 + 4 * 5) + 6 * 2
    p = small["params"]
    np.testing.assert_array_equal(sd["hms_head.final.bias"], p["hms_head"]["final"]["bias"])
    np.testing.assert_array_equal(sd["decoder.param_regressor.dense.1.weight"],
                                  p["decoder"]["param_regressor"]["Dense_1"]["kernel"].T)
    np.testing.assert_array_equal(sd["dp_head.up2_bn.running_var"],
                                  small["stats"]["dp_head"]["up2_bn"]["var"])


def test_torch_ckpt_round_trip_with_aux_heads(small, tmp_path):
    """A reference-layout .pth of the aux model ({'epoch', 'network'} with
    DDP prefixes) through `--torch_ckpt` into a freshly drawn model."""
    sd = small["model"].state_dict()
    path = tmp_path / "ref.pth"
    torch.save({"epoch": 3, "network": {f"module.{k}": v for k, v in sd.items()}}, path)
    parser = argparse.ArgumentParser()
    add_weight_args(parser)
    model = init_model(small["cfg"], small["assets"], torch.Generator().manual_seed(9))
    load_eval_weights(model, parser.parse_args(["--torch_ckpt", str(path)]))
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(v, sd[k], rtol=0, atol=0, msg=k)
    assert any(k.startswith("hms_head.") for k in sd)
