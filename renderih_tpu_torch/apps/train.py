"""Training CLI (counterpart of `renderih_tpu/apps/train.py`; reference
`apps/train.py` + `core/lijun_trainer.py:train_gcn`), on one device or
data-parallel over several.

    python -m renderih_tpu_torch.apps.train [--cfg configs/flagship.yaml] \
        [--data /path/to/packed | --synthetic] [--epochs N] [--steps N] \
        [--resume auto|PATH] [--device cuda|cpu]
    torchrun --standalone --nproc_per_node 8 -m renderih_tpu_torch.apps.train \
        --multihost [the same arguments]

Runs on the card (`--device cuda`, the default; raises without one) or,
when asked, on the CPU with the kernels' plain versions. A packed split
that fits `train.data_device_cache_mb` is uploaded once and each step's
batch is gathered, augmented and trained on the device; a larger one is
streamed from the host memmap. Checkpoints (full state) go to
`train.checkpoint_dir`: `epoch_<N>` every `save_gap` epochs, `preempt` on
SIGTERM, `crash` when a step fails, `final` at the end; `--resume auto`
picks the newest and continues with the batches and random draws the
uninterrupted run would have had (each step's generator is seeded from
`train.seed` and the step; the loop resumes at the steps taken, skipped
ones included). Every `eval_every` epochs, after the epoch's checkpoint,
the held-out split is evaluated (`evaluate_packed`, at the train batch
size) and logged under `eval/` in `metrics.jsonl`; with `ema_decay > 0`
also the EMA parameters, under `eval_ema/`; with `vis_every_eval`,
prediction and ground-truth overlays of the first samples are written
under `vis/`. Eval changes nothing of training and its time stays out of
the training images/s. The from-scratch recipes (`configs/convergence_r5*.yaml`,
`configs/probe_aux.yaml`: the aux heads) and `decoder: mano` configs run
as they are; their `aux_*` and `mano_*` loss terms are logged with the others.

`--multihost` joins the process group from torchrun's environment
(`parallel/dist.py`; JAX's `jax.distributed.initialize()`): one process a
card, `cuda:LOCAL_RANK` (with `--device cpu`, gloo on the CPU). The run is
JAX's data mesh over the W ranks (`train.mesh_data` must be -1 or W): the
global batch is `train.batch_size × W`, steps per epoch and images/s come
from it; every rank draws the same global batch and keeps its rows
(`dist.rank_rows`); the step averages gradients and loss terms over the
ranks, with global BatchNorm statistics, and shards the optimizer under
`train.zero1`. The device data cache is used at world 1 only, as in JAX.
Only rank 0 writes metrics, images and checkpoints (in the one-device
format: a checkpoint resumes at any world size). SIGTERM on any rank
saves `preempt` on all (the flag is all-reduced every step). The
in-training eval runs on rank 0 at the global batch, as JAX's unsharded
eval does, while the others wait. A step failure on any rank ends every
rank with a non-zero exit: at world > 1 a step is neither retried nor
followed by a crash checkpoint, since the other ranks are inside the
step's collectives, which a retry on one rank would not meet, and a
checkpoint is itself a collective; the failed rank ends and the others'
next collective fails with it. The last line printed (rank 0) is a JSON
object with the updates applied, images/s and the kernels' launches over
the steps of this run (the counters are set to 0 before the first).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import signal
import statistics
import time

import numpy as np
import torch

from renderih_tpu_torch.assets import load_assets
from renderih_tpu_torch.config import load_config
from renderih_tpu_torch.data.interhand import PackedInterHand, make_synthetic_packed
from renderih_tpu_torch.data.pipeline import DataProvider
from renderih_tpu_torch.eval.evaluator import eval_mode, evaluate_packed
from renderih_tpu_torch.kernels import conv3x3, fused_attention, sdf
from renderih_tpu_torch.losses.graph_loss import fit_orthographic_cam
from renderih_tpu_torch.models import init_model, model_call_kwargs
from renderih_tpu_torch.ops.image import normalize_imagenet
from renderih_tpu_torch.parallel import dist
from renderih_tpu_torch.render.renderer import TwoHandRenderer
from renderih_tpu_torch.serve import resolve_device
from renderih_tpu_torch.train.resilience import run_step_guarded
from renderih_tpu_torch.train.state import (
    create_train_state,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from renderih_tpu_torch.train.trainer import make_augmented_step, make_train_step
from renderih_tpu_torch.utils.metrics_writer import MetricsWriter

log = logging.getLogger("renderih_tpu_torch.train")

# The held-out synthetic split is generated from HELD_OUT_SEED + synth_seed,
# a space no train seed (0 <= synth_seed < HELD_OUT_SEED) reaches.
HELD_OUT_SEED = 1 << 30
WARMUP_STEPS = 3  # steps left out of the images/s median (allocator, cuDNN plans)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cfg", default=None, help="YAML config (default: Config())")
    p.add_argument("--data", default=None, help="packed dataset dir")
    p.add_argument("--synthetic", action="store_true",
                   help="train on a synthetic packed dataset")
    p.add_argument("--synth_n", type=int, default=256, help="synthetic train-split size")
    p.add_argument("--synth_eval_n", type=int, default=None,
                   help="held-out synthetic split size (default max(synth_n // 4, 16))")
    p.add_argument("--synth_seed", type=int, default=0,
                   help=f"train-split generator seed, in [0, {HELD_OUT_SEED})")
    p.add_argument("--synth_render", action="store_true",
                   help="render the labelled hands into the synthetic images "
                        "(a learnable image->pose task) instead of noise")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--steps", type=int, default=None, help="hard cap on total steps")
    p.add_argument("--resume", default=None,
                   help="checkpoint dir, or 'auto': the newest in train.checkpoint_dir")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--multihost", action="store_true",
                   help="join the process group from torchrun's environment "
                        "(data-parallel over its ranks)")
    return p


class _NoWriter:
    """The metrics writer of a rank other than 0: writes nothing."""

    def write(self, *args, **kwargs) -> None:
        pass


def _kernel_counters() -> dict:
    return {"conv3x3": conv3x3.launches,
            **{f"conv3x3_{k}": c for k, c in conv3x3.routes.items()},
            "fused_mha": fused_attention.launches, "sdf_grid": sdf.launches}


@contextlib.contextmanager
def _params_swapped(model: torch.nn.Module, params: dict | None):
    """`model` with `params` (name -> tensor) in place of its parameters,
    restored bit for bit after; None leaves it as it is."""
    if params is None:
        yield model
        return
    named = dict(model.named_parameters())
    mine = [named[k] for k in params]
    with torch.no_grad():
        saved = [p.clone() for p in mine]
        torch._foreach_copy_(mine, list(params.values()))
    try:
        yield model
    finally:
        with torch.no_grad():
            torch._foreach_copy_(mine, saved)


def _write_eval_overlays(writer, step: int, cfg, model, assets, eval_dataset, device,
                         prev: dict, n: int = 2) -> dict:
    """Prediction and ground-truth mesh overlays of the first `n` held-out
    samples, side by side, as PNGs (`MetricsWriter.write_image`; the
    reference's render-to-TensorBoard scaffolding, `utils/tb_utils.py:48-111`):
    the prediction rendered with its own orthographic camera, the ground
    truth with a camera fit to its 2-D labels. `prev` (one per run) holds
    the last overlays: the mean absolute pixel change against them is
    logged as `eval/overlay_{k}_delta`, so a model whose prediction stalls
    shows as 0. Returns those deltas."""
    n = min(n, len(eval_dataset))
    b = {k: torch.from_numpy(v).to(device)
         for k, v in eval_dataset.batch(np.arange(n)).items()}
    img01 = b["img_u8"].float() / 255.0
    renderer = TwoHandRenderer(assets, img_size=cfg.model.img_size, device=device)
    with eval_mode(model):
        out = model(normalize_imagenet(img01), **model_call_kwargs(assets, device))
        pred = renderer.overlay(img01, *renderer.render_rgb_orth(
            out.scale, out.trans2d, out.verts3d["left"], out.verts3d["right"]))
        cams = {h: fit_orthographic_cam(b[f"v3d_{h}"], b[f"v2d_{h}"], float(cfg.model.img_size))
                for h in ("left", "right")}
        gt = renderer.overlay(img01, *renderer.render_rgb_orth(
            {h: c[0] for h, c in cams.items()}, {h: c[1] for h, c in cams.items()},
            b["v3d_left"], b["v3d_right"]))
    sides = torch.cat([pred, gt], dim=2).cpu().numpy()  # (n, H, 2W, 3)
    deltas = {}
    for k, side in enumerate(sides):
        writer.write_image(step, f"eval/overlay_{k}", side)
        side = side.astype(np.float32)
        if k in prev:
            deltas[f"overlay_{k}_delta"] = float(np.abs(side - prev[k]).mean())
        prev[k] = side
    if deltas:
        writer.write(step, deltas, prefix="eval/")
    return deltas


def _evaluate(writer, step: int, epoch: int, cfg, state, assets, eval_dataset,
              batch_size: int, device, overlays: dict) -> list:
    """The in-training eval of one epoch: the held-out split on the
    parameters (`eval/`, with the overlays) and, with an EMA, on the EMA
    parameters (`eval_ema/`) swapped in and restored. Returns
    [{"step", "prefix", "summary", "seconds"}]."""
    done = []
    runs = [("eval/", None)] + ([("eval_ema/", state.ema)] if state.ema is not None else [])
    for prefix, params in runs:
        t0 = time.perf_counter()
        with _params_swapped(state.model, params):
            summary = evaluate_packed(cfg, state.model, assets, eval_dataset,
                                      batch_size=batch_size, device=device)
        seconds = time.perf_counter() - t0
        log.info("eval epoch %d%s: mpjpe %.2f mm mpvpe %.2f mm pa %.2f mm (%.1f s)", epoch,
                 " (EMA)" if params is not None else "", summary["mpjpe_mm"],
                 summary["mpvpe_mm"], summary["pa_mpjpe_mm"], seconds)
        writer.write(step, summary, prefix=prefix)
        if params is None and cfg.train.vis_every_eval:
            _write_eval_overlays(writer, step, cfg, state.model, assets, eval_dataset,
                                 device, overlays)
        done.append(dict(step=step, prefix=prefix, summary=summary, seconds=seconds))
    return done


def _datasets(args, cfg, assets, device):
    if args.synthetic or not args.data:
        if not 0 <= args.synth_seed < HELD_OUT_SEED:
            raise ValueError(f"--synth_seed must be in [0, {HELD_OUT_SEED})")
        root = os.path.join(cfg.train.checkpoint_dir, "_synth_data")

        def make():
            train = make_synthetic_packed(root, "train", assets, n=args.synth_n,
                                          seed=args.synth_seed,
                                          render_images=args.synth_render, device=device)
            held_out = make_synthetic_packed(root, "test", assets,
                                             n=args.synth_eval_n or max(args.synth_n // 4, 16),
                                             seed=HELD_OUT_SEED + args.synth_seed,
                                             render_images=args.synth_render, device=device)
            return train, held_out

        if dist.rank() == 0:
            splits = make()
        dist.barrier()  # rank 0 has written the splits; the others read them
        if dist.rank() != 0:
            splits = make()
        return splits
    train = PackedInterHand.load(args.data, "train")
    has_test = os.path.exists(os.path.join(args.data, "test_labels.npz"))
    return train, PackedInterHand.load(args.data, "test") if has_test else None


def main(argv=None) -> dict:
    """Train; returns {"final_step" (updates applied), "steps_taken",
    "checkpoint", "step_seconds", "images_per_s", "logged": [(step, terms)],
    "evals": [{"step", "prefix", "summary", "seconds"}]}."""
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    cfg = load_config(args.cfg)
    if args.epochs:
        cfg.train.epochs = args.epochs
    seed = cfg.train.seed
    device = resolve_device(args.device)
    if args.multihost:
        device = dist.init(device)
    world, rank = dist.world(), dist.rank()
    if rank:
        log.setLevel(logging.WARNING)
    if cfg.train.mesh_data not in (-1, world) or cfg.train.mesh_model != 1:
        raise ValueError(f"train.mesh_data {cfg.train.mesh_data} x mesh_model "
                         f"{cfg.train.mesh_model}: the data axis is the {world} ranks "
                         "(mesh_data -1 or the world size, mesh_model 1)")

    assets = load_assets(cfg.assets)
    dataset, eval_dataset = _datasets(args, cfg, assets, device)
    global_batch = cfg.train.batch_size * world
    rows = dist.rank_rows(global_batch, world, rank, max(1, int(cfg.train.grad_accum)))
    provider = DataProvider(dataset, batch_size=global_batch, seed=seed)
    steps_per_epoch = max(provider.batch_per_epoch, 1)
    total_steps = args.steps or cfg.train.epochs * steps_per_epoch
    log.info("dataset: %d samples, %d steps an epoch; %d rank(s), global batch %d",
             len(dataset), steps_per_epoch, world, global_batch)

    model = init_model(cfg, assets, torch.Generator().manual_seed(seed))
    model = model.to(device, memory_format=torch.channels_last)
    state = create_train_state(cfg, model, steps_per_epoch)
    log.info("model: %s, %.2fM params, on %s", cfg.model.encoder,
             sum(p.numel() for p in model.parameters()) / 1e6, device)
    resume = args.resume
    if resume == "auto":
        resume = latest_checkpoint(cfg.train.checkpoint_dir)
        log.info("resume auto: %s", resume or "no checkpoint found")
    if resume:
        restore_checkpoint(resume, state)
        log.info("resumed from %s at step %d (%d updates applied)", resume,
                 state.steps_taken, state.step)
    if eval_dataset is not None and cfg.train.eval_every < 1:
        raise ValueError(f"train.eval_every must be >= 1, got {cfg.train.eval_every}")
    step0 = state.steps_taken  # skipped steps drew their batch too
    provider.sampler.skip(step0)

    # Device-resident data cache: upload the split once, gather on the device.
    cache = None
    if world == 1 and 0 < dataset.nbytes <= cfg.train.data_device_cache_mb * 1e6:
        t_up = time.perf_counter()
        cache = {k: torch.from_numpy(v).to(device)
                 for k, v in dataset.batch(np.arange(len(dataset))).items()}
        log.info("device data cache: %d samples, %.0f MB, uploaded in %.1f s",
                 len(dataset), dataset.nbytes / 1e6, time.perf_counter() - t_up)

    step_fn = make_augmented_step(cfg, make_train_step(cfg, assets, steps_per_epoch, device),
                                  seed, device)
    preempted = []
    prev_handler = signal.signal(signal.SIGTERM, lambda *_: preempted.append(True))
    ckpt_dir = cfg.train.checkpoint_dir
    step_seconds, logged, evals = [], [], []
    overlays: dict = {}  # this run's last eval overlays
    # a failure on one rank of several ends the run (see the module docstring)
    guard = {} if world == 1 else dict(retries=0, crash_checkpoint=False)
    for counter in _kernel_counters().values():
        counter.reset()
    try:
        with MetricsWriter(ckpt_dir) if rank == 0 else contextlib.nullcontext(
                _NoWriter()) as writer:
            t_prev = time.perf_counter()
            for i in range(step0, total_steps):
                idx = provider.sampler.next_indices()[rows]
                if cache is not None:
                    dev_idx = torch.from_numpy(idx).to(device)
                    raw = {k: v.index_select(0, dev_idx) for k, v in cache.items()}
                else:
                    raw = {k: torch.from_numpy(v).to(device)
                           for k, v in dataset.batch(idx).items()}
                want_log = (i + 1) % cfg.train.log_every == 0 or i == step0

                def thunk(raw=raw, i=i, want_log=want_log):
                    terms = step_fn(state, raw, i)
                    if not want_log:
                        return None
                    # the host reads the terms inside the guard, in one copy
                    return dict(zip(terms, torch.stack(list(terms.values())).tolist()))

                terms = run_step_guarded(thunk, state, ckpt_dir, **guard)
                now = time.perf_counter()
                step_seconds.append(now - t_prev)
                t_prev = now
                if terms is not None:
                    steady = step_seconds[WARMUP_STEPS:] or step_seconds
                    ips = global_batch / statistics.median(steady)
                    heads = "".join(f" {k} {v:.4f}" for k, v in terms.items()
                                    if k.startswith(("aux_", "mano_")))
                    log.info("step %d/%d epoch %d loss %.4f (v3d %.4f v2d %.4f joint %.4f%s) "
                             "%.1f img/s", i + 1, total_steps, (i + 1) // steps_per_epoch,
                             terms["total"], terms["vert3d"], terms["vert2d"],
                             terms["joint"], heads, ips)
                    writer.write(i + 1, terms, prefix="train/")
                    writer.write(i + 1, {"images_per_sec": ips})
                    logged.append((i + 1, terms))
                if dist.any_rank(bool(preempted), device):
                    path = os.path.abspath(os.path.join(ckpt_dir, "preempt"))
                    save_checkpoint(path, state)
                    log.info("SIGTERM: saved preemption checkpoint %s at step %d",
                             path, state.step)
                    return _result(state, path, step_seconds, global_batch, logged, evals)
                epoch = (i + 1) // steps_per_epoch
                if (i + 1) % steps_per_epoch == 0 and epoch % cfg.train.save_gap == 0:
                    path = os.path.abspath(os.path.join(ckpt_dir, f"epoch_{epoch}"))
                    save_checkpoint(path, state)
                    log.info("saved checkpoint %s", path)
                if (eval_dataset is not None and (i + 1) % steps_per_epoch == 0
                        and epoch % cfg.train.eval_every == 0):
                    if rank == 0:
                        evals += _evaluate(writer, i + 1, epoch, cfg, state, assets,
                                           eval_dataset, global_batch, device, overlays)
                    dist.barrier()
                    t_prev = time.perf_counter()  # the next step's time leaves eval out
    finally:
        signal.signal(signal.SIGTERM, prev_handler)

    final = os.path.abspath(os.path.join(ckpt_dir, "final"))
    save_checkpoint(final, state)
    log.info("done; final checkpoint at %s", final)
    result = _result(state, final, step_seconds, global_batch, logged, evals)
    if rank == 0:
        print(json.dumps({"final_step": result["final_step"],
                          "images_per_s": result["images_per_s"], "world": world,
                          "kernel_launches": {k: c.value
                                              for k, c in _kernel_counters().items()}}),
              flush=True)
    return result


def _result(state, path, step_seconds, batch_size, logged, evals) -> dict:
    steady = step_seconds[WARMUP_STEPS:] or step_seconds
    return {"final_step": state.step, "steps_taken": state.steps_taken, "checkpoint": path,
            "step_seconds": step_seconds,
            "images_per_s": batch_size / statistics.median(steady) if steady else None,
            "logged": logged, "evals": evals}


if __name__ == "__main__":
    main()
