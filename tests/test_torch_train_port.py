"""The port's trainer on its own, on the CPU at the small config: the NaN
guard, EMA, checkpoints and resume, the checkpoint naming, the step
guard, seeded dropout, serving a checkpoint, and the training app end to
end (`python -m renderih_tpu_torch.apps.train --synthetic --device cpu`)."""

import argparse
import json
import os
import time

import numpy as np
import pytest
import torch

from renderih_tpu_torch.apps import train as train_app
from renderih_tpu_torch.apps.weights import load_eval_weights
from renderih_tpu_torch.assets import make_synthetic_assets
from renderih_tpu_torch.config import dump_config, load_config
from renderih_tpu_torch.data.pipeline import device_augment
from renderih_tpu_torch.data.synthetic import synthetic_batch
from renderih_tpu_torch.kernels import conv3x3
from renderih_tpu_torch.models import init_model
from renderih_tpu_torch.ops.dropout import dropout, dropout_generator
from renderih_tpu_torch.ops.projection import orthographic_project
from renderih_tpu_torch.render.renderer import TwoHandRenderer
from renderih_tpu_torch.serve import InferenceEngine
from renderih_tpu_torch.train import resilience
from renderih_tpu_torch.train.state import (
    create_train_state,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from renderih_tpu_torch.data.interhand import PackedInterHand, make_synthetic_packed
from renderih_tpu_torch.eval.evaluator import evaluate_packed
from renderih_tpu_torch.models import model_call_kwargs
from renderih_tpu_torch.train.trainer import make_eval_step, make_train_step
from renderih_tpu_torch.utils.metrics_writer import MetricsWriter, png_bytes

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


def _read_png(data: bytes) -> np.ndarray:
    """The pixels of an 8-bit RGB PNG with filter 0 rows (what png_bytes
    writes), decoded with the standard library."""
    import struct
    import zlib

    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        assert struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] == zlib.crc32(tag + body)
        chunks[tag] = chunks.get(tag, b"") + body
        pos += 12 + n
    w, h, depth, colour = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, colour) == (8, 2) and b"IEND" in chunks
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + 3 * w)
    assert not rows[:, 0].any()
    return rows[:, 1:].reshape(h, w, 3)


def test_metrics_writer_writes_png_images(tmp_path):
    img = np.random.default_rng(0).random((5, 7, 3)).astype(np.float32)
    with MetricsWriter(str(tmp_path)) as w:
        path = w.write_image(12, "eval/overlay_0", img)
    assert path == str(tmp_path / "vis" / "eval_overlay_0_step0000012.png")
    with open(path, "rb") as f:
        np.testing.assert_array_equal(_read_png(f.read()),
                                      (np.clip(img, 0, 1) * 255).astype(np.uint8))
    with pytest.raises(ValueError, match="uint8"):
        png_bytes(np.zeros((2, 2, 4), np.uint8))


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
    """A run that reaches eval runs it (see the in-training eval tests);
    the app refuses only an eval period below one epoch."""
    cfg = _cfg(checkpoint_dir=str(tmp_path), eval_every=0)
    dump_config(cfg, str(tmp_path / "c.yaml"))
    with pytest.raises(ValueError, match="eval_every"):
        train_app.main(["--cfg", str(tmp_path / "c.yaml"), "--synthetic", "--synth_n", "8",
                        "--steps", "4", "--device", "cpu"])


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


def _app(root, name: str, args: list, **train) -> dict:
    cfg = _cfg(checkpoint_dir=str(root / name), **train)
    dump_config(cfg, str(root / f"{name}.yaml"))
    return train_app.main(["--cfg", str(root / f"{name}.yaml"), "--synthetic", "--device",
                           "cpu", *args])


def test_resume_after_a_skipped_step_equals_the_uninterrupted_run(tmp_path, monkeypatch):
    """A non-finite batch at step 2 of epoch 1, skipped by the NaN guard;
    the run cut at the epoch_1 checkpoint (step 4, 3 updates applied) and
    resumed from it to step 6 equals the uninterrupted 6 steps: the
    batches drawn after the cut, the terms, the parameters, the step
    counters."""
    drawn, run = {}, [None]
    augmented = train_app.make_augmented_step

    def planted(cfg, step_fn, seed, device):
        fn = augmented(cfg, step_fn, seed, device)

        def step(state, raw, i):
            drawn.setdefault(run[0], []).append((i, raw["v3d_left"].clone()))
            if i == 1:
                raw = dict(raw, v3d_left=raw["v3d_left"] * float("nan"))
            return fn(state, raw, i)

        return step

    monkeypatch.setattr(train_app, "make_augmented_step", planted)
    args = ["--synth_n", "8", "--steps", "6"]
    run[0] = "straight"
    straight = _app(tmp_path, "straight", args, save_gap=1, seed=4)
    run[0] = "cut"
    cut = _app(tmp_path, "cut", ["--synth_n", "8", "--steps", "4"], save_gap=1, seed=4)
    assert dict(straight["logged"])[2]["skipped_nonfinite"] == 1.0
    assert (cut["final_step"], cut["steps_taken"]) == (3, 4)
    run[0] = "resumed"
    resumed = _app(tmp_path, "cut", [*args, "--resume", str(tmp_path / "cut" / "epoch_1")],
                   save_gap=1, seed=4)
    assert [i for i, _ in drawn["resumed"]] == [4, 5]
    for (i, got), (j, want) in zip(drawn["resumed"], drawn["straight"][4:]):
        assert i == j
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert resumed["logged"] == straight["logged"][4:]
    assert (resumed["final_step"], resumed["steps_taken"]) == (5, 6)
    assert (straight["final_step"], straight["steps_taken"]) == (5, 6)
    a, b = (torch.load(os.path.join(r["checkpoint"], "state.pt"), weights_only=True)
            for r in (straight, resumed))
    assert (a["step"], a["steps_taken"]) == (b["step"], b["steps_taken"]) == (5, 6)
    for k, v in a["model"].items():
        torch.testing.assert_close(b["model"][k], v, rtol=0, atol=0, msg=k)


def test_a_checkpoint_without_steps_taken_resumes_at_its_step(assets, tmp_path):
    state = _state(_cfg(), assets)
    state.step, state.steps_taken = 3, 5
    save_checkpoint(str(tmp_path / "new"), state)
    blob = torch.load(tmp_path / "new" / "state.pt", weights_only=True)
    del blob["steps_taken"]
    os.makedirs(tmp_path / "old")
    torch.save(blob, tmp_path / "old" / "state.pt")
    for name, taken in (("new", 5), ("old", 3)):
        other = restore_checkpoint(str(tmp_path / name), _state(_cfg(), assets, seed=1))
        assert (other.step, other.steps_taken) == (3, taken)


@pytest.fixture(scope="module")
def eval_runs(tmp_path_factory):
    """The app on the CPU with the held-out split evaluated every epoch
    (EMA on), at 256² (eval feeds the packed images unresized): 2 epochs
    of 2 steps with eval, the same without eval, then one more epoch with
    eval in a new run of the same process."""
    root = tmp_path_factory.mktemp("eval")
    model = {**SMALL["model"], "img_size": 256}

    def run(name: str, epochs: int, **train) -> dict:
        cfg = load_config(overrides={**SMALL, "model": model, "train": {
            **SMALL["train"], "checkpoint_dir": str(root / name), "seed": 2, "save_gap": 1,
            **train}})
        dump_config(cfg, str(root / f"{name}.yaml"))
        return train_app.main(["--cfg", str(root / f"{name}.yaml"), "--synthetic", "--synth_n",
                               "4", "--synth_eval_n", "3", "--epochs", str(epochs),
                               "--device", "cpu"])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TwoHandRenderer, "render_rgb_orth", _splat_render)
        runs = {"eval": run("eval", 2, eval_every=1), "plain": run("plain", 2, eval_every=100),
                "again": run("again", 1, eval_every=1)}
    return root, runs


def _splat_render(self, scale, trans2d, verts_left, verts_right):
    """A stand-in for `TwoHandRenderer.render_rgb_orth` in the app tests
    (the rasteriser tests every pixel against every face, ~15 s an image
    at 256² on one CPU thread; tests/test_torch_render.py holds it against
    JAX): each projected vertex lights its pixel in its hand's colour."""
    n, b = self.img_size, verts_left.shape[0]
    rgb, mask = torch.zeros(b, n * n, 3), torch.zeros(b, n * n)
    for colour, hand, verts in ((0.3, "left", verts_left), (0.8, "right", verts_right)):
        uv = orthographic_project(scale[hand], trans2d[hand], verts, n).round().long()
        idx = uv.clamp(0, n - 1) @ torch.tensor([1, n])
        mask.scatter_(1, idx, 1.0)
        rgb[torch.arange(b)[:, None], idx] = colour
    return rgb.reshape(b, n, n, 3), mask.reshape(b, n, n)


def _records(path) -> list:
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_in_training_eval_logs_eval_and_ema_summaries(eval_runs):
    root, runs = eval_runs
    evals = runs["eval"]["evals"]
    assert [(e["step"], e["prefix"]) for e in evals] == [
        (2, "eval/"), (2, "eval_ema/"), (4, "eval/"), (4, "eval_ema/")]
    keys = {k for rec in _records(root / "eval" / "metrics.jsonl") for k in rec}
    for prefix in ("eval/", "eval_ema/"):
        assert {f"{prefix}{k}" for k in ("mpjpe_mm", "pa_mpjpe_mm", "cdev_mm", "mrrpe_mm",
                                         "double_mpjpe_mm", "num_samples")} <= keys
    assert evals[0]["summary"]["num_samples"] == 3 and not runs["plain"]["evals"]


def test_in_training_eval_equals_an_eval_of_its_checkpoint(eval_runs):
    """The epoch-1 summaries equal `evaluate_packed` on the epoch_1
    checkpoint, its parameters and (`--ema`) its EMA parameters."""
    root, runs = eval_runs
    cfg = load_config(str(root / "eval.yaml"))
    assets = make_synthetic_assets(0)
    held_out = PackedInterHand.load(str(root / "eval" / "_synth_data"), "test")
    for ema, run in zip((False, True), runs["eval"]["evals"][:2]):
        model = init_model(cfg, assets)
        load_eval_weights(model, argparse.Namespace(ckpt=str(root / "eval" / "epoch_1"),
                                                    ema=ema, torch_ckpt=None))
        model = model.to(memory_format=torch.channels_last)
        want = evaluate_packed(cfg, model, assets, held_out, batch_size=2, device="cpu")
        for k, v in want.items():
            if k not in ("images_per_sec", "cache_upload_s"):
                assert run["summary"][k] == v or (np.isnan(v) and np.isnan(run["summary"][k])), k


def test_in_training_eval_leaves_training_unchanged(eval_runs):
    _, runs = eval_runs
    assert runs["eval"]["logged"] == runs["plain"]["logged"]
    a, b = (torch.load(os.path.join(runs[n]["checkpoint"], "state.pt"), weights_only=True)
            for n in ("eval", "plain"))
    assert (a["step"], a["steps_taken"]) == (b["step"], b["steps_taken"]) == (4, 4)
    for k, v in a["model"].items():
        torch.testing.assert_close(b["model"][k], v, rtol=0, atol=0, msg=k)
    for k, v in a["ema"].items():
        torch.testing.assert_close(b["ema"][k], v, rtol=0, atol=0, msg=k)


def test_in_training_eval_writes_overlays_with_a_cache_per_run(eval_runs):
    root, _ = eval_runs
    for step in (2, 4):
        for k in (0, 1):
            with open(root / "eval" / "vis" / f"eval_overlay_{k}_step{step:07d}.png", "rb") as f:
                img = _read_png(f.read())
            assert img.shape == (256, 512, 3) and img.std() > 0
    deltas = {rec["step"]: rec for rec in _records(root / "eval" / "metrics.jsonl")
              if "eval/overlay_0_delta" in rec}
    assert list(deltas) == [4] and deltas[4]["eval/overlay_0_delta"] > 0
    # the next run in this process starts with no overlays of its own
    again = _records(root / "again" / "metrics.jsonl")
    assert any("eval/mpjpe_mm" in rec for rec in again)
    assert not any("eval/overlay_0_delta" in rec for rec in again)
