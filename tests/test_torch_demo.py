"""The port's demo (`renderih_tpu_torch/apps/demo.py`) against the JAX
package's (`renderih_tpu/apps/demo.py`) on the CPU: the padding and the
smoother exactly, the model's outputs within 1e-4, and the rendered
overlay and novel view within 1 grey level on >= 99.9% of pixels, at a
small config (resnet18, grid 4, f32, 128² in and out: the rasteriser is
the cost on the CPU) with the JAX weights carried across
(`utils/weights.py:state_dict_from_jax`). Then the CLI on a JPEG and a PNG
and `live_loop` on three frames."""

import os
from types import SimpleNamespace
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderih_tpu.apps import demo as jax_demo
from renderih_tpu.apps.demo import ConstantAccelSmoother as JaxSmoother
from renderih_tpu.apps.demo import InterRender as JaxInterRender
from renderih_tpu.apps.demo import pad_to_square as jax_pad_to_square
from renderih_tpu.assets import make_synthetic_assets as jax_make_assets
from renderih_tpu.config import load_config as jax_load_config
from renderih_tpu.models import build_model as jax_build_model
from renderih_tpu.models import model_call_kwargs as jax_call_kwargs
from renderih_tpu_torch.apps import demo
from renderih_tpu_torch.assets import make_synthetic_assets
from renderih_tpu_torch.config import dump_config, load_config
from renderih_tpu_torch.data.image_io import imread_rgb, imwrite
from renderih_tpu_torch.utils.weights import state_dict_from_jax

OVERRIDES = {
    "model": {"encoder": "resnet18", "img_size": 128, "grid_size": 4,
              "gcn_in_dims": [64, 32, 16], "gcn_out_dims": [32, 16, 8],
              "img_dims": [32, 16, 8], "deconv_dims": [32, 32, 32, 32],
              "graph_layer_num": 2},
    "train": {"precision": "f32"},
}


def _close_images(got, want, share=0.999):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    within = np.abs(got.astype(np.int16) - want).max(-1) <= 1
    assert within.mean() >= share, within.mean()


def test_pad_to_square_and_smoother_equal_jax():
    rng = np.random.default_rng(0)
    for shape in ((30, 50, 3), (51, 20, 3), (16, 16, 3), (7, 8, 1)):
        img = rng.integers(0, 256, shape, np.uint8)
        assert np.array_equal(demo.pad_to_square(img), jax_pad_to_square(img))
    for blend in (0.3, 0.5, 1.0):
        s, js = demo.ConstantAccelSmoother(blend), JaxSmoother(blend)
        for _ in range(20):
            x = rng.normal(size=(1, 778, 3)).astype(np.float32)
            assert np.array_equal(s(x), js(x))


@pytest.fixture(scope="module")
def runners():
    """The JAX demo's runner at the small config and the port's on the
    same weights: drawn with numpy at the shapes JAX's init traces (not
    run: flax's init is eager and slow here), kernels N(0, 1/fan_in),
    BatchNorm statistics drawn too, the upsampling from the assets."""
    jcfg = jax_load_config(overrides=OVERRIDES)
    jassets = jax_make_assets(0)
    jmodel = jax_build_model(jcfg, jassets)
    shapes = jax.eval_shape(lambda key: jmodel.init(
        {"params": key, "dropout": key}, jnp.zeros((1, 128, 128, 3)), train=False,
        **jax_call_kwargs(jcfg, jassets)), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            a = rng.normal(0, np.prod(shape[:-1]) ** -0.5, shape)
        elif name == "var":
            a = rng.uniform(0.5, 1.5, shape)
        else:
            a = (name == "scale") + rng.normal(0, 0.05, shape)
        return a.astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes["params"])
    params["decoder"]["upsample_weight"] = np.asarray(jassets.left.upsample_init)
    stats = jax.tree_util.tree_map_with_path(draw, shapes["batch_stats"])
    with mock.patch.object(jax_demo, "init_model", lambda cfg, assets, key: (jmodel, None)):
        jrunner = JaxInterRender(jcfg, jassets, {"params": params, "batch_stats": stats},
                                 img_size=128)
    cfg = load_config(overrides=OVERRIDES)
    runner = demo.InterRender(cfg, make_synthetic_assets(0),
                              state_dict=state_dict_from_jax(params, stats), img_size=128,
                              device="cpu")
    return runner, jrunner, cfg


def _image(seed, shape):
    y, x = np.mgrid[0:shape[0], 0:shape[1]]
    rng = np.random.default_rng(seed)
    img = np.stack([128 + 90 * np.sin(x / (7.0 + k) + seed) * np.cos(y / 11.0) for k in range(3)],
                   -1) + rng.normal(0, 10, shape + (3,))
    return np.clip(img, 0, 255).astype(np.uint8)


def test_inter_render_matches_jax(runners):
    runner, jrunner, _ = runners
    img = _image(1, (200, 300))
    params, jparams = runner.run_model(img), jrunner.run_model(img)
    assert np.array_equal(params["input"], jparams["input"])
    for key in ("verts_left", "verts_right"):
        np.testing.assert_allclose(params[key], np.asarray(jparams[key]), atol=1e-4)
    for d in ("scale", "trans2d"):
        for h in ("left", "right"):
            np.testing.assert_allclose(params[d][h], np.asarray(jparams[d][h]), atol=1e-4)
    _close_images(runner.render(params), jrunner.render(jparams))
    # the seed-0 model's meshes are crumpled and mostly off the frame: the
    # overlay and the novel view again with the template hands framed
    mano = runner.engine.assets
    for p in (params, jparams):
        p["verts_left"] = mano.left.mano.v_template.numpy()[None]
        p["verts_right"] = mano.right.mano.v_template.numpy()[None] + np.float32([0.05, 0.02, 0.01])
        p["scale"] = {h: np.full((1,), 2.0, np.float32) for h in ("left", "right")}
        p["trans2d"] = {"left": np.float32([[-0.2, 0.0]]), "right": np.float32([[0.2, 0.1]])}
    _close_images(runner.render_other_view(params, 30.0), jrunner.render_other_view(jparams, 30.0))
    over, jover = runner.render(params), jrunner.render(jparams)
    assert (over != params["input"]).any(-1).mean() > 0.05
    _close_images(over, jover)


def test_demo_cli_on_a_jpeg_and_a_png(runners, tmp_path, monkeypatch):
    """Non-square inputs, one JPEG and one PNG, `--other_view 45`: four
    outputs named after the inputs, each what the runner renders (the
    JPEG through the port's encoder)."""
    runner, _, cfg = runners
    dump_config(cfg, str(tmp_path / "cfg.yaml"))
    src = tmp_path / "in"
    src.mkdir()
    imgs = {"a.jpg": _image(1, (120, 90)), "b.png": _image(2, (64, 100))}
    for name, img in imgs.items():
        imwrite(src / name, img)
    rendered = []  # what the CLI rendered, in order: overlay, novel view, per image
    spy = SimpleNamespace(
        engine=runner.engine, device=runner.device, run_model=runner.run_model,
        render=lambda p: rendered.append(runner.render(p)) or rendered[-1],
        render_other_view=lambda p, theta: rendered.append(
            runner.render_other_view(p, theta)) or rendered[-1])
    monkeypatch.setattr(demo, "InterRender", lambda cfg, assets, device: spy)
    out = demo.main(["--cfg", str(tmp_path / "cfg.yaml"), "--img_path", str(src), "--save_path",
                     str(tmp_path / "out"), "--other_view", "45", "--device", "cpu"])
    names = ["a.jpg", "a_rot.jpg", "b.png", "b_rot.png"]
    assert out["images"] == 2 and [os.path.basename(p) for p in out["outputs"]] == names
    assert len(rendered) == 4
    for name, want in zip(names, rendered):
        if name.endswith(".png"):
            assert np.array_equal(imread_rgb(tmp_path / "out" / name), want)
        else:
            imwrite(tmp_path / "want.jpg", want)
            assert (tmp_path / "out" / name).read_bytes() == (tmp_path / "want.jpg").read_bytes()


def test_live_demo_is_refused_with_its_reason():
    with pytest.raises(SystemExit, match="camera and a window"):
        demo.main(["--live_demo", "--device", "cpu"])


def test_live_loop_smooths_and_renders_three_frames(runners):
    """Each frame's meshes are smoothed over the frames before (one
    smoother a hand) and the render of the smoothed meshes is shown."""
    runner, _, _ = runners
    frames = [_image(10 + i, (100, 140)) for i in range(3)]
    drawn, shown = [], []
    spy = SimpleNamespace(run_model=runner.run_model,
                          render=lambda p: drawn.append(p) or runner.render(p))
    assert demo.live_loop(frames, shown.append, spy) == 3
    assert len(shown) == 3 and all(s.shape == (128, 128, 3) for s in shown)
    sm = {k: demo.ConstantAccelSmoother() for k in ("verts_left", "verts_right")}
    for frame, params in zip(frames, drawn):
        raw = runner.run_model(frame)
        for k in sm:
            assert np.array_equal(params[k], sm[k](raw[k]))
    assert not np.array_equal(drawn[2]["verts_left"], runner.run_model(frames[2])["verts_left"])
    assert demo.live_loop(frames, lambda img: True, spy) == 1  # 'q' on the first frame
