"""Seeded weights in the upstream state-dict layout, drawn on the device.

Every floating-point entry comes from one normal draw of a `torch.Generator`
on `device` (a single large call), cut into the entries in state-dict order
and shaped by the rule of the module that holds it:
  * conv and linear weights: N(0, 1 / fan_in);
  * conv and linear biases, embeddings: N(0, 0.02^2);
  * norm weights 1 + 0.1 N, norm biases 0.1 N;
  * BatchNorm running means 0.1 N, running variances exp(0.2 N);
  * `num_batches_tracked` 0.
So every parameter and statistic is non-trivial, and a path that drops a
bias, an affine or a statistic changes the outputs. The same seed gives the
same dict on any card.
"""

from __future__ import annotations

import torch
from torch import nn


def _rule(module: nn.Module, leaf: str, shape: torch.Size):
    """(scale, offset, exp) of `module`'s entry `leaf`: value = offset + scale * z,
    then exp() when `exp`."""
    if isinstance(module, (nn.BatchNorm2d, nn.LayerNorm)):
        if leaf == "weight":
            return 0.1, 1.0, False
        if leaf == "running_var":
            return 0.2, 0.0, True
        return 0.1, 0.0, False  # bias, running_mean
    if isinstance(module, nn.Embedding) or leaf == "bias":
        return 0.02, 0.0, False
    fan_in = shape[1:].numel()
    return fan_in ** -0.5, 0.0, False


def draw_state_dict(model: nn.Module, seed: int, device: torch.device | str) -> dict:
    """A state dict for `model` (any device, meta included) drawn from `seed`
    on `device` in float32."""
    modules = dict(model.named_modules())
    entries = [(name, t.shape, t.dtype) for name, t in model.state_dict().items()]
    floats = [e for e in entries if e[2].is_floating_point]
    total = sum(shape.numel() for _, shape, _ in floats)
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, dtype in entries:
        if not dtype.is_floating_point:
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
            continue
        owner, _, leaf = name.rpartition(".")
        scale, offset, exp = _rule(modules[owner], leaf, shape)
        v = z[at:at + shape.numel()].view(shape) * scale + offset
        out[name] = v.exp() if exp else v
        at += shape.numel()
    return out
