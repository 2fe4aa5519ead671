"""The port's trainer on its own, on the CPU at the small config: the NaN
guard, EMA, checkpoints and resume, the checkpoint naming, the step
guard, seeded dropout, serving a checkpoint, and the training app end to
end (`python -m renderih_tpu_torch.apps.train --synthetic --device cpu`)."""

import json
import os
import time

import numpy as np
import pytest
import torch

from renderih_tpu_torch.apps import train as train_app
from renderih_tpu_torch.assets import make_synthetic_assets
from renderih_tpu_torch.config import dump_config, load_config
from renderih_tpu_torch.data.pipeline import device_augment
from renderih_tpu_torch.data.synthetic import synthetic_batch
from renderih_tpu_torch.kernels import conv3x3
from renderih_tpu_torch.models import init_model
from renderih_tpu_torch.ops.dropout import dropout, dropout_generator
from renderih_tpu_torch.serve import InferenceEngine
from renderih_tpu_torch.train import resilience
from renderih_tpu_torch.train.state import (
    create_train_state,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from renderih_tpu_torch.data.interhand import make_synthetic_packed
from renderih_tpu_torch.models import model_call_kwargs
from renderih_tpu_torch.train.trainer import make_eval_step, make_train_step
from renderih_tpu_torch.utils.metrics_writer import MetricsWriter

SMALL = {
    "model": {"encoder": "resnet18", "img_size": 128, "grid_size": 4,
              "gcn_in_dims": [64, 32, 16], "gcn_out_dims": [32, 16, 8],
              "img_dims": [32, 16, 8], "deconv_dims": [32, 32, 32, 32],
              "graph_layer_num": 2},
    "train": {"precision": "f32", "batch_size": 2, "warmup_epochs": 0, "lr": 1e-3,
              "ema_decay": 0.9, "log_every": 1},
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def assets():
    return make_synthetic_assets(0)


def _cfg(**train):
    return load_config(overrides={**SMALL, "train": {**SMALL["train"], **train}})


def _batch(assets, seed=0, b=2):
    raw = synthetic_batch(assets, torch.Generator().manual_seed(seed), b, 128, with_img=False)
    raw["img_u8"] = torch.randint(0, 256, (b, 128, 128, 3), dtype=torch.uint8,
                                  generator=torch.Generator().manual_seed(seed))
    return device_augment(raw, torch.Generator().manual_seed(seed + 1), img_size=128)


def _state(cfg, assets, seed=0):
    return create_train_state(cfg, init_model(cfg, assets, torch.Generator().manual_seed(seed)),
                              steps_per_epoch=10)


def _assert_same_state(a, b):
    for (k, v), w in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        torch.testing.assert_close(v, w, rtol=0, atol=0, msg=k)
    assert a.step == b.step
    for k in a.ema:
        torch.testing.assert_close(a.ema[k], b.ema[k], rtol=0, atol=0, msg=k)


def test_nan_batch_leaves_the_state_and_ema(assets):
    cfg = _cfg()
    state = _state(cfg, assets)
    step = make_train_step(cfg, assets, 10, "cpu")
    good = _batch(assets)
    step(state, good)  # one applied update: optimizer moments exist
    model0 = {k: v.clone() for k, v in state.model.state_dict().items()}
    opt0 = {id(p): {k: v.clone() for k, v in s.items()} for p, s in state.optimizer.state.items()}
    ema0 = {k: v.clone() for k, v in state.ema.items()}
    terms = step(state, dict(good, img=torch.full_like(good["img"], float("nan"))))
    assert float(terms["skipped_nonfinite"]) == 1.0 and state.step == 1
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(v, model0[k], rtol=0, atol=0, msg=k)
    for p, s in state.optimizer.state.items():
        for k, v in s.items():
            torch.testing.assert_close(v, opt0[id(p)][k], rtol=0, atol=0)
    for k, v in state.ema.items():
        torch.testing.assert_close(v, ema0[k], rtol=0, atol=0, msg=k)
    terms = step(state, good)
    assert float(terms["skipped_nonfinite"]) == 0.0 and state.step == 2


def test_ema_follows_applied_updates(assets):
    cfg = _cfg()
    state = _state(cfg, assets)
    before = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    make_train_step(cfg, assets, 10, "cpu")(state, _batch(assets))
    for k, p in state.model.named_parameters():
        torch.testing.assert_close(state.ema[k], 0.9 * before[k] + 0.1 * p.detach(),
                                   rtol=1e-6, atol=1e-7, msg=k)


def test_without_the_nan_guard_every_update_is_applied(assets):
    cfg = _cfg(nan_guard=False)
    state = _state(cfg, assets)
    good = _batch(assets)
    terms = make_train_step(cfg, assets, 10, "cpu")(
        state, dict(good, img=torch.full_like(good["img"], float("nan"))))
    assert "skipped_nonfinite" not in terms and state.step == 1
    assert torch.isnan(state.model.decoder.coord_head.weight).all()


def test_eval_step_is_the_model_in_eval_mode(assets):
    cfg = _cfg()
    model = init_model(cfg, assets).train()
    img = _batch(assets)["img"]
    out = make_eval_step(cfg, assets, "cpu")(model, img)
    assert not model.training
    with torch.no_grad():
        want = model(img, **model_call_kwargs(assets))
    torch.testing.assert_close(out.verts3d["left"], want.verts3d["left"], rtol=0, atol=0)


def test_synthetic_packed_renders_its_images(assets, tmp_path):
    """`render_images`: the labelled hands over procedural backgrounds, on
    the CPU; written once and reused while (n, seed, mode) hold."""
    ds = make_synthetic_packed(str(tmp_path), "train", assets, n=1, seed=0,
                               render_images=True)
    noise = make_synthetic_packed(str(tmp_path / "noise"), "train", assets, n=1, seed=0)
    b, bn = ds.batch(np.arange(1)), noise.batch(np.arange(1))
    assert b["img_u8"].shape == (1, 256, 256, 3) and b["img_u8"].std() > 1
    assert not np.array_equal(b["img_u8"], bn["img_u8"])
    # the scene layout places the right hand beside the left under one camera
    for k in ("v3d_right", "v2d_left"):
        assert np.isfinite(b[k]).all() and not np.array_equal(b[k], bn[k])
    mtime = os.path.getmtime(tmp_path / "train_images.u8")
    make_synthetic_packed(str(tmp_path), "train", assets, n=1, seed=0, render_images=True)
    assert os.path.getmtime(tmp_path / "train_images.u8") == mtime


def test_frozen_upsample_is_out_of_the_optimizer(assets):
    state = _state(_cfg(), assets)
    w = state.model.decoder.unsample_layer.weight
    assert not w.requires_grad
    assert all(p is not w for g in state.optimizer.param_groups for p in g["params"])


def test_grad_accum_needs_a_divisible_batch(assets):
    cfg = _cfg(grad_accum=3)
    state = _state(cfg, assets)
    with pytest.raises(ValueError, match="not divisible"):
        make_train_step(cfg, assets, 10, "cpu")(state, _batch(assets))


def test_checkpoint_restore_then_step_equals_an_uninterrupted_step(assets, tmp_path):
    cfg = _cfg()
    step = make_train_step(cfg, assets, 10, "cpu")
    b1, b2 = _batch(assets, 1), _batch(assets, 2)
    straight = _state(cfg, assets)
    gen = lambda: torch.Generator().manual_seed(9)  # the step's dropout draws
    step(straight, b1, gen())
    save_checkpoint(str(tmp_path / "epoch_1"), straight)
    step(straight, b2, gen())
    resumed = _state(cfg, assets, seed=5)  # other weights: all must come from the file
    restore_checkpoint(str(tmp_path / "epoch_1"), resumed)
    assert resumed.step == 1
    step(resumed, b2, gen())
    _assert_same_state(straight, resumed)


def test_latest_checkpoint_naming(tmp_path):
    assert latest_checkpoint(str(tmp_path / "none")) is None
    assert latest_checkpoint(str(tmp_path)) is None
    for name in ("epoch_2", "epoch_10", "epoch_9"):
        (tmp_path / name).mkdir()
    (tmp_path / "epoch_11").write_text("a file, not a checkpoint")
    assert latest_checkpoint(str(tmp_path)) == str(tmp_path / "epoch_10")
    for i, name in enumerate(("final", "preempt")):
        (tmp_path / name).mkdir()
        os.utime(tmp_path / name, (time.time() + 10 * (i + 1),) * 2)
    assert latest_checkpoint(str(tmp_path)) == str(tmp_path / "preempt")
    os.utime(tmp_path / "epoch_10", (time.time() + 100,) * 2)
    assert latest_checkpoint(str(tmp_path)) == str(tmp_path / "epoch_10")


def test_run_step_guarded_retries_then_saves_a_crash_checkpoint(tmp_path):
    calls, saved, waits = [], [], []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return "done"

    save = lambda path, state: saved.append((path, state))
    assert resilience.run_step_guarded(flaky, "S", str(tmp_path), save_fn=save,
                                       sleep=waits.append) == "done"
    assert len(calls) == 2 and waits == [10.0] and not saved

    def broken():
        raise ValueError("a bug")

    with pytest.raises(ValueError, match="a bug"):
        resilience.run_step_guarded(broken, "S", str(tmp_path), save_fn=save,
                                    sleep=waits.append)
    assert saved == [(os.path.abspath(tmp_path / "crash"), "S")]


def test_a_failure_inside_the_update_is_neither_retried_nor_saved(tmp_path, assets):
    """An out-of-memory error raised by the optimizer may leave part of the
    update applied: the step raises UpdateFailed, which the guard
    re-raises at once, with no retry and no crash checkpoint."""
    cfg = _cfg()
    state = _state(cfg, assets)
    step = make_train_step(cfg, assets, 10, "cpu")
    batch = _batch(assets)

    def oom(*args, **kwargs):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    state.optimizer.step = oom
    saved, waits = [], []
    with pytest.raises(resilience.UpdateFailed) as info:
        resilience.run_step_guarded(lambda: step(state, batch), state, str(tmp_path),
                                    save_fn=lambda path, s: saved.append(path),
                                    sleep=waits.append)
    assert isinstance(info.value.__cause__, torch.cuda.OutOfMemoryError)
    assert not saved and not waits and state.step == 0


def test_dropout_repeats_with_its_generator():
    x = torch.ones(1000)
    masks = []
    for seed in (3, 3, 4):
        with dropout_generator(torch.Generator().manual_seed(seed)):
            masks.append(dropout(x, 0.25, training=True))
    torch.testing.assert_close(masks[0], masks[1], rtol=0, atol=0)
    assert not torch.equal(masks[0], masks[2])
    assert set(masks[0].unique().tolist()) == {0.0, float(torch.tensor(1.0 / 0.75))}
    assert dropout(x, 0.25, training=False) is x


def test_conv3x3_on_the_cpu_takes_the_plain_autograd():
    x = torch.randn(1, 6, 6, 8, requires_grad=True)
    w = torch.randn(3, 3, 8, 8, requires_grad=True)
    n = conv3x3.launches.value
    conv3x3.conv3x3_same(x, w).sum().backward()
    assert x.grad is not None and w.grad is not None and conv3x3.launches.value == n


def test_metrics_writer_writes_json_lines(tmp_path):
    with MetricsWriter(str(tmp_path)) as w:
        w.write(3, {"loss": torch.tensor(1.5), "name": "skip"}, prefix="train/")
    rec = json.loads((tmp_path / "metrics.jsonl").read_text())
    assert rec["step"] == 3 and rec["train/loss"] == 1.5 and "train/name" not in rec


@pytest.fixture(scope="module")
def app_runs(tmp_path_factory):
    """The app on the CPU: 3 steps straight; 2 steps, then `--resume auto`
    to 3."""
    root = tmp_path_factory.mktemp("app")
    runs = {}
    for name, steps in (("straight", [3]), ("resumed", [2, 3])):
        cfg = _cfg(checkpoint_dir=str(root / name), seed=3)
        path = root / f"{name}.yaml"
        dump_config(cfg, str(path))
        runs[name] = [train_app.main(
            ["--cfg", str(path), "--synthetic", "--synth_n", "8", "--steps", str(n),
             "--device", "cpu"] + (["--resume", "auto"] if i else []))
            for i, n in enumerate(steps)]
    return root, runs


def test_app_trains_and_writes_its_checkpoints(app_runs):
    root, runs = app_runs
    (out,) = runs["straight"]
    assert out["final_step"] == 3 and out["checkpoint"] == str(root / "straight" / "final")
    assert len(out["step_seconds"]) == 3 and out["images_per_s"] > 0
    assert [s for s, _ in out["logged"]] == [1, 2, 3]
    for _, terms in out["logged"]:
        assert np.isfinite(list(terms.values())).all() and terms["skipped_nonfinite"] == 0
    lines = (root / "straight" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 6  # terms and images/s for each logged step
    assert (root / "straight" / "_synth_data" / "test_meta.json").exists()


def test_app_resume_auto_continues_as_the_uninterrupted_run(app_runs):
    root, runs = app_runs
    first, second = runs["resumed"]
    assert first["final_step"] == 2 and second["final_step"] == 3
    assert second["logged"][0][0] == 3
    torch.testing.assert_close(second["logged"][0][1], runs["straight"][0]["logged"][2][1],
                               rtol=0, atol=0)
    a = torch.load(os.path.join(runs["straight"][0]["checkpoint"], "state.pt"),
                   weights_only=True)
    b = torch.load(os.path.join(second["checkpoint"], "state.pt"), weights_only=True)
    for k, v in a["model"].items():
        torch.testing.assert_close(b["model"][k], v, rtol=0, atol=0, msg=k)


def test_engine_serves_a_training_checkpoint(app_runs, assets):
    root, runs = app_runs
    ckpt = runs["straight"][0]["checkpoint"]
    cfg = load_config(str(root / "straight.yaml"))
    engine = InferenceEngine(cfg, assets=assets, checkpoint=ckpt, buckets=(2,), device="cpu")
    model = init_model(cfg, assets)
    model.load_state_dict(torch.load(os.path.join(ckpt, "state.pt"),
                                     weights_only=True)["model"])
    img = np.random.default_rng(0).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    got = engine.predict(img)
    with torch.no_grad():
        from renderih_tpu_torch.ops.image import normalize_imagenet
        want = model.eval()(normalize_imagenet(torch.from_numpy(img).float() / 255.0),
                            **model_call_kwargs(assets))
    np.testing.assert_allclose(got["verts3d_left"], want.verts3d["left"].numpy(), atol=1e-5)


def test_app_refuses_a_run_that_reaches_eval(tmp_path):
    cfg = _cfg(checkpoint_dir=str(tmp_path), eval_every=1)
    dump_config(cfg, str(tmp_path / "c.yaml"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_app.main(["--cfg", str(tmp_path / "c.yaml"), "--synthetic", "--synth_n", "8",
                        "--steps", "4", "--device", "cpu"])
    assert train_app.eval_epochs(0, 40, 4, 10) == [10]
    assert train_app.eval_epochs(40, 80, 4, 10) == [20]
    assert train_app.eval_epochs(0, 39, 4, 10) == []


def test_app_rejects_a_train_seed_in_the_held_out_space(tmp_path):
    cfg = _cfg(checkpoint_dir=str(tmp_path))
    dump_config(cfg, str(tmp_path / "c.yaml"))
    with pytest.raises(ValueError, match="synth_seed"):
        train_app.main(["--cfg", str(tmp_path / "c.yaml"), "--synthetic", "--synth_n", "8",
                        "--steps", "1", "--device", "cpu", "--synth_seed",
                        str(train_app.HELD_OUT_SEED)])


def test_app_without_device_runs_on_the_card_or_raises(tmp_path):
    if torch.cuda.is_available():
        assert train_app.build_parser().parse_args([]).device == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_app.main(["--synthetic", "--steps", "1"])
