"""Dropout with an explicit generator (counterpart of flax `nn.Dropout`).

`dropout(x, p, training)` draws its mask from the generator that
`dropout_generator` installs for a block (the train step installs its own,
seeded), so that a seeded training run repeats; outside such a block the
mask comes from torch's default generator. Every dropout site of the
decoder goes through it.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

_GENERATOR: contextvars.ContextVar = contextvars.ContextVar(
    "dropout_generator", default=None)


@contextlib.contextmanager
def dropout_generator(gen: torch.Generator | None):
    """Every `dropout` inside the block draws its mask from `gen`."""
    token = _GENERATOR.set(gen)
    try:
        yield
    finally:
        _GENERATOR.reset(token)


def dropout(x: torch.Tensor, p: float, training: bool) -> torch.Tensor:
    """Inverted dropout: keep with probability 1 - p and scale by
    1 / (1 - p). Identity in eval and at p = 0."""
    if not training or p == 0.0:
        return x
    keep = 1.0 - p
    mask = torch.empty_like(x).bernoulli_(keep, generator=_GENERATOR.get())
    return x * mask.div_(keep)
