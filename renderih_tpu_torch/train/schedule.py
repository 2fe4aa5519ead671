"""Learning-rate schedules as plain functions of the optimizer step
(counterpart of `renderih_tpu/train/schedule.py`, there optax schedules).

`StepLR_withWarmUp` (`utils/lr_sc.py:159-174`): linear warmup from
init_lr = 1e-2 * base over `warm_up` epochs, then step decay
gamma^((epoch - warmup) // step) with a floor, stepped per epoch in the
reference (`core/lijun_trainer.py:148-159`); here per optimizer step given
steps_per_epoch. `SGDR_withWarmUp` (`utils/lr_sc.py:177+`): linear warmup
from 0, then cosine restarts.
"""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def warmup_step_decay_schedule(base_lr: float, steps_per_epoch: int,
                               warmup_epochs: int = 3, decay_step_epochs: int = 80,
                               gamma: float = 0.1, min_scale: float = 0.0,
                               init_scale: float = 1e-2) -> Schedule:
    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        if epoch < warmup_epochs:
            return init_scale * base_lr + (base_lr - init_scale * base_lr) * (
                epoch / max(warmup_epochs, 1))
        return base_lr * max(gamma ** ((epoch - warmup_epochs) // decay_step_epochs),
                             min_scale)

    return schedule


def _cosine(base_lr: float, decay_steps: int, alpha: float, count: int) -> float:
    """optax.cosine_decay_schedule."""
    if decay_steps <= 0:
        return base_lr
    frac = min(count, decay_steps) / decay_steps
    return base_lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * frac)) + alpha)


def sgdr_schedule(base_lr: float, steps_per_epoch: int, t_0_epochs: int,
                  t_mult: int = 1, eta_min: float = 0.0,
                  warmup_epochs: int = 1, restarts: int = 8) -> Schedule:
    """Warmup from 0 to `base_lr`, then `restarts` cosine cycles of t_0,
    t_0·t_mult, ... epochs down to `eta_min`; after the last the rate
    stays at its end."""
    warm = warmup_epochs * steps_per_epoch
    alpha = eta_min / max(base_lr, 1e-12)
    lengths = [t_0_epochs * t_mult ** i * steps_per_epoch for i in range(restarts)]

    def schedule(step: int) -> float:
        if step < warm:
            return base_lr * step / warm
        count = step - warm
        for length in lengths[:-1]:
            if count < length:
                return _cosine(base_lr, length, alpha, count)
            count -= length
        return _cosine(base_lr, lengths[-1], alpha, count)

    return schedule
