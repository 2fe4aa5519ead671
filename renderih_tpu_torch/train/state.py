"""Train state, optimizers and checkpoints (counterpart of
`renderih_tpu/train/state.py`).

The state is the full training state, as in the JAX package: the model
(parameters and BatchNorm statistics), the optimizer (moments), the step
(updates applied, which the learning-rate schedule reads) and the EMA of
the parameters. A checkpoint holds all of it, so a resumed run continues
where it stopped (the reference saves only the weights,
`core/lijun_trainer.py:343-355`).

Optimizers (`make_optimizer`), as optax computes them:
  * adamw: `torch.optim.AdamW` (decoupled decay p·(1 − lr·wd), eps outside
    the root, b1 0.9, b2 0.999, eps 1e-8: optax's `adamw`);
  * sgd: plain p − lr·g (an SGD step exposes the raw gradient,
    g = (p0 − p1)/lr; the equivalence tests use it);
  * rmsprop: `OptaxRMSprop`, optax's `rmsprop` (decay 0.9, g·rsqrt(ν + eps)
    with eps inside the root), which `torch.optim.RMSprop` is not.
`freeze_upsample` gives the 252->778 upsample weight `requires_grad=False`
and leaves it out of the optimizer: no update, no weight decay
(`core/lijun_trainer.py:115-116`).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass

import torch
from torch import nn

from renderih_tpu_torch.config import Config
from renderih_tpu_torch.train.schedule import Schedule, warmup_step_decay_schedule

CHECKPOINT_FILE = "state.pt"


class OptaxRMSprop(torch.optim.Optimizer):
    """optax.rmsprop: ν ← decay·ν + (1 − decay)·g², p ← p − lr·g·rsqrt(ν + eps)."""

    def __init__(self, params, lr: float = 1e-3, decay: float = 0.9, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.mul_(group["decay"]).addcmul_(p.grad, p.grad, value=1.0 - group["decay"])
                p.addcmul_(p.grad, torch.rsqrt(nu + group["eps"]), value=-group["lr"])


def trainable_parameters(model: nn.Module) -> list:
    return [p for p in model.parameters() if p.requires_grad]


def make_optimizer(cfg: Config, params: list) -> torch.optim.Optimizer:
    """The optimizer of `cfg.train.optimizer` over `params`; the train step
    sets its learning rate from the schedule before each update."""
    name = cfg.train.optimizer
    fused = bool(params) and params[0].is_cuda
    if name == "adamw":
        return torch.optim.AdamW(params, lr=cfg.train.lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=cfg.train.weight_decay, fused=fused or None)
    if name == "rmsprop":  # reference alternative path (`core/lijun_trainer.py:131-144`)
        return OptaxRMSprop(params, lr=cfg.train.lr)
    if name == "sgd":
        return torch.optim.SGD(params, lr=cfg.train.lr, fused=fused or None)
    raise ValueError(f"unknown optimizer {name}")


def make_schedule(cfg: Config, steps_per_epoch: int) -> Schedule:
    return warmup_step_decay_schedule(
        base_lr=cfg.train.lr, steps_per_epoch=steps_per_epoch,
        warmup_epochs=cfg.train.warmup_epochs,
        decay_step_epochs=cfg.train.lr_decay_step, gamma=cfg.train.lr_decay_gamma)


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    step: int = 0            # updates applied
    ema: dict | None = None  # name -> EMA of that parameter


def create_train_state(cfg: Config, model: nn.Module, steps_per_epoch: int) -> TrainState:
    """State over `model` (already on its device), which it trains in place."""
    if cfg.model.freeze_upsample:
        model.decoder.unsample_layer.weight.requires_grad_(False)
    ema = ({name: p.detach().clone() for name, p in model.named_parameters()}
           if cfg.train.ema_decay > 0 else None)
    return TrainState(model=model,
                      optimizer=make_optimizer(cfg, trainable_parameters(model)),
                      schedule=make_schedule(cfg, steps_per_epoch), ema=ema)


def save_checkpoint(path: str, state: TrainState) -> None:
    """The full state into the directory `path` (written to a temporary
    file, then renamed: a crash mid-write leaves the old checkpoint)."""
    os.makedirs(path, exist_ok=True)
    blob = {"step": state.step, "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(), "ema": state.ema}
    tmp = os.path.join(path, CHECKPOINT_FILE + ".tmp")
    torch.save(blob, tmp)
    os.replace(tmp, os.path.join(path, CHECKPOINT_FILE))


def _load(path: str, device) -> dict:
    return torch.load(os.path.join(path, CHECKPOINT_FILE), map_location=device,
                      weights_only=True)


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load the checkpoint at `path` into `state` (in place) and return it."""
    device = next(state.model.parameters()).device
    blob = _load(path, device)
    state.model.load_state_dict(blob["model"])
    state.optimizer.load_state_dict(blob["optimizer"])
    state.step = int(blob["step"])
    if (blob["ema"] is None) != (state.ema is None):
        raise ValueError(f"{path}: EMA {'present' if blob['ema'] is not None else 'absent'}"
                         " in the checkpoint but not so in the config")
    if state.ema is not None:
        for name, value in blob["ema"].items():
            state.ema[name].copy_(value)
    return state


def checkpoint_state_dict(path: str) -> dict:
    """The model's state_dict from a checkpoint directory, on the CPU:
    what `serve.InferenceEngine(checkpoint=...)` loads."""
    return _load(path, "cpu")["model"]


def latest_checkpoint(checkpoint_dir: str) -> str | None:
    """Newest checkpoint under `checkpoint_dir`, or None.

    The trainer's layout: `epoch_<N>` (highest N wins; robust against
    copies that reset mtimes), then `preempt`/`crash`/`final`, the highest
    epoch and these compared by mtime (written by the same run).
    """
    if not os.path.isdir(checkpoint_dir):
        return None
    epochs = []
    for name in os.listdir(checkpoint_dir):
        m = re.fullmatch(r"epoch_(\d+)", name)
        if m and os.path.isdir(os.path.join(checkpoint_dir, name)):
            epochs.append((int(m.group(1)), name))
    candidates = [max(epochs)[1]] if epochs else []
    for special in ("preempt", "crash", "final"):
        if os.path.isdir(os.path.join(checkpoint_dir, special)):
            candidates.append(special)
    if not candidates:
        return None
    best = max(candidates, key=lambda n: os.path.getmtime(os.path.join(checkpoint_dir, n)))
    return os.path.abspath(os.path.join(checkpoint_dir, best))
