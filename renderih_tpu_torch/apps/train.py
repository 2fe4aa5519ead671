"""Training CLI (counterpart of `renderih_tpu/apps/train.py`; reference
`apps/train.py` + `core/lijun_trainer.py:train_gcn`), on one device.

    python -m renderih_tpu_torch.apps.train [--cfg configs/flagship.yaml] \
        [--data /path/to/packed | --synthetic] [--epochs N] [--steps N] \
        [--resume auto|PATH] [--device cuda|cpu]

Runs on the card (`--device cuda`, the default; raises without one) or,
when asked, on the CPU with the kernels' plain versions. A packed split
that fits `train.data_device_cache_mb` is uploaded once and each step's
batch is gathered, augmented and trained on the device; a larger one is
streamed from the host memmap. Checkpoints (full state) go to
`train.checkpoint_dir`: `epoch_<N>` every `save_gap` epochs, `preempt` on
SIGTERM, `crash` when a step fails, `final` at the end; `--resume auto`
picks the newest and continues with the batches and random draws the
uninterrupted run would have had (each step's generator is seeded from
`train.seed` and the step). In-training eval (`evaluate_packed`) is not
ported yet: a run that would reach an eval epoch raises at start.
"""

from __future__ import annotations

import argparse
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
from renderih_tpu_torch.models import init_model
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
    return p


def eval_epochs(step0: int, total_steps: int, steps_per_epoch: int,
                eval_every: int) -> list:
    """The epochs at which steps step0..total_steps-1 would run eval."""
    first = step0 // steps_per_epoch + 1
    last = total_steps // steps_per_epoch
    return [e for e in range(first, last + 1) if e % eval_every == 0]


def _datasets(args, cfg, assets, device):
    if args.synthetic or not args.data:
        if not 0 <= args.synth_seed < HELD_OUT_SEED:
            raise ValueError(f"--synth_seed must be in [0, {HELD_OUT_SEED})")
        root = os.path.join(cfg.train.checkpoint_dir, "_synth_data")
        train = make_synthetic_packed(root, "train", assets, n=args.synth_n,
                                      seed=args.synth_seed,
                                      render_images=args.synth_render, device=device)
        held_out = make_synthetic_packed(root, "test", assets,
                                         n=args.synth_eval_n or max(args.synth_n // 4, 16),
                                         seed=HELD_OUT_SEED + args.synth_seed,
                                         render_images=args.synth_render, device=device)
        return train, held_out
    train = PackedInterHand.load(args.data, "train")
    has_test = os.path.exists(os.path.join(args.data, "test_labels.npz"))
    return train, PackedInterHand.load(args.data, "test") if has_test else None


def main(argv=None) -> dict:
    """Train; returns {"final_step", "checkpoint", "step_seconds",
    "images_per_s", "logged": [(step, terms)]}."""
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    cfg = load_config(args.cfg)
    if args.epochs:
        cfg.train.epochs = args.epochs
    seed = cfg.train.seed
    device = resolve_device(args.device)

    assets = load_assets(cfg.assets)
    dataset, eval_dataset = _datasets(args, cfg, assets, device)
    batch_size = cfg.train.batch_size
    provider = DataProvider(dataset, batch_size=batch_size, seed=seed)
    steps_per_epoch = max(provider.batch_per_epoch, 1)
    total_steps = args.steps or cfg.train.epochs * steps_per_epoch
    log.info("dataset: %d samples, %d steps an epoch", len(dataset), steps_per_epoch)

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
        log.info("resumed from %s at step %d", resume, state.step)
    step0 = state.step
    if eval_dataset is not None:
        reached = eval_epochs(step0, total_steps, steps_per_epoch, cfg.train.eval_every)
        if reached:
            raise NotImplementedError(
                f"this run reaches eval epochs {reached[:3]}..., and in-training eval "
                "(evaluate_packed) is not ported yet (ROADMAP.md A.5): lower --steps "
                "or --epochs, or raise train.eval_every")
    provider.sampler.skip(step0)

    # Device-resident data cache: upload the split once, gather on the device.
    cache = None
    if 0 < dataset.nbytes <= cfg.train.data_device_cache_mb * 1e6:
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
    step_seconds, logged = [], []
    try:
        with MetricsWriter(ckpt_dir) as writer:
            t_prev = time.perf_counter()
            for i in range(step0, total_steps):
                idx = provider.sampler.next_indices()
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

                terms = run_step_guarded(thunk, state, ckpt_dir)
                now = time.perf_counter()
                step_seconds.append(now - t_prev)
                t_prev = now
                if terms is not None:
                    steady = step_seconds[WARMUP_STEPS:] or step_seconds
                    ips = batch_size / statistics.median(steady)
                    log.info("step %d/%d epoch %d loss %.4f (v3d %.4f v2d %.4f joint %.4f) "
                             "%.1f img/s", i + 1, total_steps, (i + 1) // steps_per_epoch,
                             terms["total"], terms["vert3d"], terms["vert2d"],
                             terms["joint"], ips)
                    writer.write(i + 1, terms, prefix="train/")
                    writer.write(i + 1, {"images_per_sec": ips})
                    logged.append((i + 1, terms))
                if preempted:
                    path = os.path.abspath(os.path.join(ckpt_dir, "preempt"))
                    save_checkpoint(path, state)
                    log.info("SIGTERM: saved preemption checkpoint %s at step %d",
                             path, state.step)
                    return _result(state, path, step_seconds, batch_size, logged)
                epoch = (i + 1) // steps_per_epoch
                if (i + 1) % steps_per_epoch == 0 and epoch % cfg.train.save_gap == 0:
                    path = os.path.abspath(os.path.join(ckpt_dir, f"epoch_{epoch}"))
                    save_checkpoint(path, state)
                    log.info("saved checkpoint %s", path)
    finally:
        signal.signal(signal.SIGTERM, prev_handler)

    final = os.path.abspath(os.path.join(ckpt_dir, "final"))
    save_checkpoint(final, state)
    log.info("done; final checkpoint at %s", final)
    result = _result(state, final, step_seconds, batch_size, logged)
    print(json.dumps({"final_step": result["final_step"],
                      "images_per_s": result["images_per_s"]}), flush=True)
    return result


def _result(state, path, step_seconds, batch_size, logged) -> dict:
    steady = step_seconds[WARMUP_STEPS:] or step_seconds
    return {"final_step": state.step, "checkpoint": path, "step_seconds": step_seconds,
            "images_per_s": batch_size / statistics.median(steady) if steady else None,
            "logged": logged}


if __name__ == "__main__":
    main()
