"""The port's evaluator (`renderih_tpu_torch/eval/evaluator.py`) and eval
CLI against `renderih_tpu/eval/evaluator.py` on the CPU.

One packed split, written once by JAX's `make_synthetic_packed(n=10,
seed=3)` with the right hand of samples 0-4 moved onto the left (so that
CDev has contact and no-contact samples), is read by both packages'
`PackedInterHand.load`. resnet18 at 256² with the small decoder, f32,
JAX's init with random BatchNorm statistics carried to the port by
`state_dict_from_jax`; batch 4, so the tail batch is padded. JAX's eval
compiles once, in the module fixture. Every per-sample metric vector of
the port is held within 1e-4·max|verts3d| of JAX's (the forward's bar,
PARITY.md:14), with the same NaN pattern in cdev."""

import argparse

import jax
import numpy as np
import pytest
import torch

from renderih_tpu.assets import make_synthetic_assets as jax_assets
from renderih_tpu.config import load_config as jax_load_config
from renderih_tpu.data.interhand import PackedInterHand as JaxPacked
from renderih_tpu.data.interhand import make_synthetic_packed as jax_synthetic_packed
from renderih_tpu.eval import evaluator as jax_evaluator
from renderih_tpu.models import init_model as jax_init_model
from renderih_tpu.utils.checkpoint_convert import export_reference_checkpoint
from renderih_tpu_torch.apps import eval_interhand
from renderih_tpu_torch.apps.weights import load_eval_weights
from renderih_tpu_torch.assets import make_synthetic_assets
from renderih_tpu_torch.config import dump_config, load_config
from renderih_tpu_torch.data.interhand import PackedInterHand
from renderih_tpu_torch.eval.evaluator import evaluate_packed, evaluate_vectors, summarize
from renderih_tpu_torch.models import build_model, model_call_kwargs
from renderih_tpu_torch.ops.image import normalize_imagenet
from renderih_tpu_torch.utils.weights import state_dict_from_jax

OVERRIDES = {
    "model": {"encoder": "resnet18", "img_size": 256, "grid_size": 4,
              "gcn_in_dims": [64, 32, 16], "gcn_out_dims": [32, 16, 8],
              "img_dims": [32, 16, 8], "deconv_dims": [32, 32, 32, 32],
              "graph_layer_num": 2},
    "train": {"precision": "f32"},
}
N, BS = 10, 4
TIMING = ("images_per_sec", "cache_upload_s", "device_cache", "num_samples")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("packed"))
    jcfg = jax_load_config(overrides=OVERRIDES)
    jassets = jax_assets(0)
    jax_synthetic_packed(root, "test", jassets, n=N, seed=3)
    labels = dict(np.load(f"{root}/test_labels.npz"))
    rng = np.random.default_rng(0)
    labels["v3d_right"][:5] = (labels["v3d_left"][:5] + [0.002, 0.0, 0.0]
                               + rng.normal(0, 0.001, (5, 778, 3))).astype(np.float32)
    np.savez(f"{root}/test_labels.npz", **labels)

    jmodel, variables = jax_init_model(jcfg, jassets, jax.random.PRNGKey(0))
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 1.5, a.shape) if path[-1].key == "var"
                         else rng.normal(0.0, 0.1, a.shape)).astype(np.float32),
        variables["batch_stats"])
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    captured = {}
    summarize_jax = jax_evaluator.summarize

    def capture(vectors, iou=None):
        captured.update(vectors)
        return summarize_jax(vectors, iou)

    jax_evaluator.summarize = capture  # JAX returns the summary only
    try:
        jsummary = jax_evaluator.evaluate_packed(
            jcfg, jmodel, {"params": params, "batch_stats": stats}, jassets,
            JaxPacked.load(root, "test"), batch_size=BS)
    finally:
        jax_evaluator.summarize = summarize_jax

    cfg = load_config(overrides=OVERRIDES)
    assets = make_synthetic_assets(0)
    model = build_model(cfg, assets)
    model.load_state_dict(state_dict_from_jax(params, stats))
    model = model.to(memory_format=torch.channels_last)
    dataset = PackedInterHand.load(root, "test")
    with torch.no_grad():
        img = normalize_imagenet(torch.from_numpy(np.array(dataset.images)).float() / 255.0)
        out = model.eval()(img, **model_call_kwargs(assets))
    scale = max(float(v.abs().max()) for v in out.verts3d.values())
    return dict(root=root, cfg=cfg, assets=assets, model=model, dataset=dataset,
                params=params, stats=stats, jvectors=captured, jsummary=jsummary,
                scale=scale)


def test_evaluate_packed_matches_jax(setup):
    vectors, stats = evaluate_vectors(setup["cfg"], setup["model"], setup["assets"],
                                      setup["dataset"], batch_size=BS, device="cpu")
    want = setup["jvectors"]
    assert vectors.keys() == want.keys() and stats["num_samples"] == N
    tol = 1e-4 * setup["scale"]
    for k, w in want.items():
        g, w = vectors[k], np.asarray(w)
        assert g.shape == w.shape == (N,), k
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=k)
        ok = ~np.isnan(w)
        assert np.abs(g[ok] - w[ok]).max() <= tol, (k, np.abs(g[ok] - w[ok]).max(), tol)
    cdev = vectors["cdev"]  # contact where the right hand was moved, not everywhere else
    assert np.isfinite(cdev[:5]).all() and np.isnan(cdev[5:]).any()
    # the summary is numpy over the vectors: the JAX vectors give JAX's summary
    ours = summarize({k: np.asarray(v) for k, v in want.items()})
    for k, v in ours.items():
        np.testing.assert_allclose(v, setup["jsummary"][k], rtol=1e-12, err_msg=k)


def test_device_cache_and_streaming_give_equal_results(setup):
    runs = [evaluate_packed(setup["cfg"], setup["model"], setup["assets"], setup["dataset"],
                            batch_size=BS, device="cpu", device_cache=cached)
            for cached in (True, False)]
    assert runs[0]["device_cache"] and not runs[1]["device_cache"]
    assert runs[0]["cache_upload_s"] >= 0 and runs[1]["cache_upload_s"] == 0
    for k, v in runs[0].items():
        if k not in TIMING:
            np.testing.assert_array_equal(runs[1][k], v, err_msg=k)


def test_eval_keeps_the_model_mode_and_rejects_a_mesh(setup):
    """The model's mode is kept; a mesh that is not a `parallel.mesh.Mesh`
    is rejected (data-parallel eval itself: tests/test_torch_parallel_serve.py)."""
    model = setup["model"].train()
    try:
        with pytest.raises(TypeError, match="Mesh"):
            evaluate_packed(setup["cfg"], model, setup["assets"], setup["dataset"],
                            device="cpu", mesh=object())
        evaluate_vectors(setup["cfg"], model, setup["assets"], setup["dataset"],
                         batch_size=8, device="cpu")
        assert model.training
    finally:
        model.eval()


def test_cli_with_a_reference_checkpoint_equals_a_direct_eval(setup, tmp_path):
    sd = export_reference_checkpoint(setup["params"], setup["stats"])
    pth = tmp_path / "reference.pth"
    torch.save({"epoch": 7, "network": {f"module.{k}": torch.from_numpy(np.array(v))
                                        for k, v in sd.items()}}, pth)
    dump_config(setup["cfg"], str(tmp_path / "cfg.yaml"))
    got = eval_interhand.main(["--cfg", str(tmp_path / "cfg.yaml"), "--torch_ckpt", str(pth),
                               "--data", setup["root"], "--bs", str(BS), "--device", "cpu",
                               "--json"])
    want = evaluate_packed(setup["cfg"], setup["model"], setup["assets"], setup["dataset"],
                           batch_size=BS, device="cpu")
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k not in TIMING:
            np.testing.assert_array_equal(got[k], v, err_msg=k)

    # a key too many or too few is an error, not a warning
    bad = {k: v for k, v in torch.load(pth, weights_only=True)["network"].items()
           if not k.endswith("fc2.bias")}
    torch.save(dict(bad, extra=torch.zeros(1)), tmp_path / "bad.pth")
    model = build_model(setup["cfg"], setup["assets"])
    args = argparse.Namespace(ckpt=None, ema=False, torch_ckpt=str(tmp_path / "bad.pth"))
    with pytest.raises(ValueError, match="missing .*fc2.bias.*unexpected .*extra"):
        load_eval_weights(model, args)
    with pytest.raises(SystemExit, match="--ema requires --ckpt"):
        load_eval_weights(model, argparse.Namespace(ckpt=None, ema=True, torch_ckpt=None))


def test_overlay_blend_matches_jax():
    from renderih_tpu.render.renderer import TwoHandRenderer as JaxRenderer
    from renderih_tpu_torch.render.renderer import TwoHandRenderer

    rng = np.random.default_rng(4)
    img, rgb = (rng.random((2, 8, 8, 3)).astype(np.float32) for _ in range(2))
    mask = (rng.random((2, 8, 8)) > 0.5).astype(np.float32)
    got = TwoHandRenderer.overlay(*(torch.from_numpy(a) for a in (img, rgb, mask)))
    want = JaxRenderer.overlay(None, img, rgb, mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-7)
