"""The decoder variants of the port against the JAX package on the CPU:
`cheby_conv`, the Chebyshev `GcnResBlock`, `HandNet` with `use_cheby`
(forward, and one AdamW step against JAX's `make_train_step`), JAX's
paired (hand-stacked) model of both flavours against the port's
`paired_lr` model loaded from its tree (the port builds the unpaired trunk
under `paired_lr`), the port's paired model against its unpaired one on
one upstream state_dict, and a paired run's EMA loaded into an unpaired
model.
The small config (resnet18, 128², narrow widths, 2 blocks), f32, JAX at
`highest` matmul precision (tests/conftest.py); max|Δ| ≤ 1e-4."""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderih_tpu.assets import make_synthetic_assets as jax_assets
from renderih_tpu.config import load_config as jax_load_config
from renderih_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from renderih_tpu.graph.ops import cheby_conv as jax_cheby_conv
from renderih_tpu.models import build_model as jax_build_model
from renderih_tpu.models import init_model as jax_init_model
from renderih_tpu.models import model_call_kwargs as jax_call_kwargs
from renderih_tpu.models.dual_graph import GcnResBlock as JaxGcnResBlock
from renderih_tpu.train.state import create_train_state as jax_create_train_state
from renderih_tpu.train.trainer import make_train_step as jax_make_train_step
from renderih_tpu.utils.pair_params import pair_params
from renderih_tpu_torch.apps.weights import load_eval_weights
from renderih_tpu_torch.assets import make_synthetic_assets
from renderih_tpu_torch.config import load_config
from renderih_tpu_torch.data.pipeline import device_augment
from renderih_tpu_torch.data.synthetic import synthetic_batch
from renderih_tpu_torch.graph.ops import cheby_conv
from renderih_tpu_torch.models import build_model, init_model, model_call_kwargs
from renderih_tpu_torch.models.dual_graph import GcnResBlock
from renderih_tpu_torch.train.state import create_train_state, save_checkpoint
from renderih_tpu_torch.train.trainer import make_train_step
from renderih_tpu_torch.utils import weights
from renderih_tpu_torch.utils.weights import state_dict_from_jax

B, SPE = 2, 10
SMALL = {
    "model": {"encoder": "resnet18", "img_size": 128, "grid_size": 4,
              "gcn_in_dims": [64, 32, 16], "gcn_out_dims": [32, 16, 8],
              "img_dims": [32, 16, 8], "deconv_dims": [32, 32, 32, 32],
              "graph_layer_num": 2, "dropout": 0.0},
    "train": {"precision": "f32", "batch_size": B, "warmup_epochs": 0},
    "loss": {"norm_epoch": 0, "camera": 1.0},
}
OUTPUTS = ("verts3d", "verts2d", "scale", "trans2d")


def _over(**model):
    return {**SMALL, "model": {**SMALL["model"], **model}}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jassets():
    return jax_assets(0)


@pytest.fixture(scope="module")
def assets():
    return make_synthetic_assets(0)


def _jax_init(jassets, **model):
    """JAX init of the small config with `model` overrides, random
    BatchNorm statistics; (jcfg, jmodel, params, stats) as numpy."""
    jcfg = jax_load_config(overrides=_over(**model))
    jmodel, variables = jax_init_model(jcfg, jassets, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 1.5, a.shape) if path[-1].key == "var"
                         else rng.normal(0.0, 0.1, a.shape)).astype(np.float32),
        variables["batch_stats"])
    return jcfg, jmodel, jax.tree_util.tree_map(np.asarray, variables["params"]), stats


@pytest.fixture(scope="module")
def cheby(jassets):
    return _jax_init(jassets, use_cheby=True)


@pytest.fixture(scope="module")
def mlp(jassets):
    return _jax_init(jassets)


def _image(seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(B, 128, 128, 3)).astype(np.float32)


def _jax_forward(jcfg, jassets, params, stats, img) -> dict:
    model = jax_build_model(jcfg, jassets)
    out = jax.jit(lambda v, x: model.apply(v, x, train=False,
                                           **jax_call_kwargs(jcfg, jassets)))(
        {"params": params, "batch_stats": stats}, jnp.asarray(img))
    return {f"{k}_{h}": np.asarray(getattr(out, k)[h]) for k in OUTPUTS
            for h in ("left", "right")}


def _port_forward(model, assets, img) -> dict:
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(img), **model_call_kwargs(assets))
    return {f"{k}_{h}": getattr(out, k)[h].numpy() for k in OUTPUTS
            for h in ("left", "right")}


def _assert_close(got: dict, want: dict):
    """max|Δ| ≤ 1e-4; verts2d (pixels) relative to its largest value."""
    for key, ref in want.items():
        err = np.abs(got[key] - ref).max()
        limit = 1e-4 * max(np.abs(ref).max(), 1.0) if "verts2d" in key else 1e-4
        assert err <= limit, f"{key}: max|Δ| {err:.3e} > {limit:.3e}"


@pytest.mark.parametrize("k", [1, 2, 3])
def test_cheby_conv_matches_jax(jassets, assets, k):
    lap_j = np.asarray(jassets.left.laplacians_coarse[1])
    lap = torch.tensor(lap_j)
    rng = np.random.default_rng(k)
    x = rng.normal(size=(3, lap.shape[0], 5)).astype(np.float32)
    w = rng.normal(size=(5 * k, 7)).astype(np.float32)
    b = rng.normal(size=(7,)).astype(np.float32)
    want = np.asarray(jax_cheby_conv(jnp.asarray(x), jnp.asarray(lap_j), jnp.asarray(w),
                                     jnp.asarray(b), k=k))
    got = cheby_conv(torch.from_numpy(x), lap, torch.from_numpy(w), torch.from_numpy(b), k=k)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_laplacians_coarse_match_jax(jassets, assets):
    """Coarsest first, one a stage. Not bit-equal: both packages rescale by
    the largest eigenvalue from ARPACK (`eigsh`), whose random start moves
    it by ~1e-7 relative from one build to the next."""
    for hand in ("left", "right"):
        ours, theirs = (getattr(a, hand).laplacians_coarse for a in (assets, jassets))
        assert [t.shape[0] for t in ours] == list(getattr(assets, hand).verts_nums)
        for a, b in zip(ours, theirs):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)


def test_cheby_block_matches_jax(assets):
    lap = assets.left.laplacians_coarse[0]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, lap.shape[0], 12)).astype(np.float32)
    jblock = JaxGcnResBlock(12, 16, graph_k=3, use_cheby=True)
    jparams = jax.tree_util.tree_map(np.asarray, jblock.init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(lap.numpy()))["params"])
    jparams["norm2"]["scale"] = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    want = np.asarray(jblock.apply({"params": jparams}, jnp.asarray(x),
                                   jnp.asarray(lap.numpy())))
    sd = {}
    weights._gcn_block(jparams, "b", sd)
    block = GcnResBlock(12, 16, use_cheby=True, graph_k=3)
    block.load_state_dict({k[2:]: v for k, v in sd.items()})
    assert block.fc1.weight.shape == (16, 36) and block.fc2.weight.shape == (16, 48)
    with torch.no_grad():
        got = block.eval()(torch.from_numpy(x), lap)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_cheby_handnet_matches_jax(cheby, jassets, assets):
    jcfg, _, params, stats = cheby
    img = _image()
    model = build_model(load_config(overrides=_over(use_cheby=True)), assets)
    model.load_state_dict(state_dict_from_jax(params, stats))
    _assert_close(_port_forward(model, assets, img),
                  _jax_forward(jcfg, jassets, params, stats, img))


@pytest.mark.parametrize("use_cheby", [False, True])
def test_paired_matches_jax_paired(mlp, cheby, jassets, assets, use_cheby):
    """JAX's paired model (its parameters `pair_params` of the unpaired
    init) against the port's paired model loaded from the same JAX tree,
    whose leaves `state_dict_from_jax` unstacks into the upstream keys."""
    jcfg, _, params, stats = cheby if use_cheby else mlp
    jcfg_p = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, paired_lr=True))
    paired = pair_params(params)
    assert "graph_pair" in paired["decoder"]["dual_gcn"]["layer_0"]
    img = _image(2)
    model = build_model(load_config(overrides=_over(use_cheby=use_cheby, paired_lr=True)),
                        assets)
    sd = state_dict_from_jax(paired, stats)
    assert set(sd) == set(state_dict_from_jax(params, stats))
    model.load_state_dict(sd)
    _assert_close(_port_forward(model, assets, img),
                  _jax_forward(jcfg_p, jassets, paired, stats, img))


@pytest.mark.parametrize("use_cheby", [False, True])
def test_paired_matches_unpaired_on_one_state_dict(assets, use_cheby):
    """The port's paired and unpaired models from one upstream-layout
    state_dict compute the same outputs, and the paired one writes that
    state_dict back unchanged; a paired model's `init_model` draws the
    unpaired one's parameters."""
    cfg = load_config(overrides=_over(use_cheby=use_cheby))
    cfg_p = load_config(overrides=_over(use_cheby=use_cheby, paired_lr=True))
    unpaired = init_model(cfg, assets, torch.Generator().manual_seed(4))
    sd = unpaired.state_dict()
    paired = build_model(cfg_p, assets)
    paired.load_state_dict(sd)
    back = paired.state_dict()
    assert list(back) != [] and set(back) == set(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    drawn = init_model(cfg_p, assets, torch.Generator().manual_seed(4)).state_dict()
    assert all(torch.equal(drawn[k], sd[k]) for k in sd)
    img = _image(5)
    _assert_close(_port_forward(paired, assets, img), _port_forward(unpaired, assets, img))


def test_paired_run_ema_loads_into_unpaired_model(assets, tmp_path):
    """One training step of a `paired_lr` model with an EMA, checkpointed:
    the eval CLIs' `--ckpt --ema` loads it into an unpaired model, which
    then holds the EMA parameters."""
    train = {**SMALL["train"], "ema_decay": 0.9, "lr": 1e-3}
    cfg_p = load_config(overrides={**_over(use_cheby=True, paired_lr=True), "train": train})
    cfg = load_config(overrides={**_over(use_cheby=True), "train": train})
    state = create_train_state(cfg_p, init_model(cfg_p, assets), SPE)
    raw = synthetic_batch(assets, torch.Generator().manual_seed(6), B, 128, with_img=False)
    raw["img_u8"] = torch.randint(0, 256, (B, 128, 128, 3), dtype=torch.uint8,
                                  generator=torch.Generator().manual_seed(6))
    batch = device_augment(raw, torch.Generator().manual_seed(7), img_size=128)
    make_train_step(cfg_p, assets, SPE, "cpu")(state, batch)
    assert state.steps_taken == 1
    save_checkpoint(str(tmp_path / "final"), state)
    model = build_model(cfg, assets)
    load_eval_weights(model, argparse.Namespace(ckpt=str(tmp_path / "final"), ema=True,
                                                torch_ckpt=None))
    params = dict(model.named_parameters())
    assert set(params) == set(state.ema)
    moved = 0
    for name, value in state.ema.items():
        assert torch.equal(params[name], value), name
        moved += not torch.equal(value, state.model.state_dict()[name])
    assert moved  # the EMA is not the trained parameters


def test_cheby_adamw_step_matches_jax(cheby, jassets, assets):
    """One AdamW step of `use_cheby` against JAX's train step: the loss
    terms within 1e-4 relative, 99.9% of the parameters within 0.05·lr of
    JAX's and all within 2·lr (test_torch_train.py says why: Adam's first
    step moves an element by ~lr·sign(g)), and every block's norm1, which
    no gradient reaches, moved by weight decay alone, as JAX moves it."""
    jcfg_tree = _over(use_cheby=True)
    jcfg_tree = {**jcfg_tree, "train": {**jcfg_tree["train"], "optimizer": "adamw",
                                         "lr": 1e-3}}
    jcfg = jax_load_config(overrides=jcfg_tree)
    _, jmodel, params, stats = cheby
    batch = {k: np.asarray(v) for k, v in jax_synthetic_batch(
        jassets, jax.random.PRNGKey(1), batch_size=B, img_size=128).items()}
    batch["img"] = _image(3)
    state0 = jax_create_train_state(jcfg, {"params": params, "batch_stats": stats}, SPE)
    jstep, _ = jax_make_train_step(jcfg, jmodel, jassets, SPE, params_template=params)
    jstate1, jterms = jstep(jax.tree_util.tree_map(jnp.array, state0),
                            {k: jnp.asarray(v) for k, v in batch.items()},
                            jax.random.PRNGKey(2))
    want = {k: v.numpy() for k, v in state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate1.params),
        jax.tree_util.tree_map(np.asarray, jstate1.batch_stats)).items()}

    cfg = load_config(overrides=jcfg_tree)
    model = build_model(cfg, assets)
    sd0 = state_dict_from_jax(params, stats)
    model.load_state_dict(sd0)
    state = create_train_state(cfg, model, SPE)
    terms = make_train_step(cfg, assets, SPE, "cpu")(
        state, {k: torch.tensor(v) for k, v in batch.items()})
    for k, ref in jterms.items():
        assert abs(float(terms[k]) - float(ref)) <= 1e-4 * abs(float(ref)) + 1e-7, k

    lr, wd = 1e-3, cfg.train.weight_decay
    n_close = n_all = 0
    norm1 = 0
    for name, p in model.named_parameters():
        got = p.detach().numpy()
        diff = np.abs(got - want[name])
        assert diff.max() <= 2.01 * lr, (name, diff.max())
        n_close += int((diff <= 0.05 * lr).sum())
        n_all += diff.size
        if ".norm1." in name and ".GCN_blocks." in name:
            norm1 += 1
            assert p.grad is not None and not p.grad.any(), name
            decayed = sd0[name].numpy() * (1.0 - lr * wd)
            np.testing.assert_allclose(got, decayed, rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(want[name], decayed, rtol=1e-6, atol=1e-9)
    assert norm1 == 2 * 2 * 3 * 2  # weight, bias x 2 blocks x 3 stages x 2 hands
    assert n_close / n_all >= 0.999, n_close / n_all
