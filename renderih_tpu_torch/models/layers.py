"""Layers whose arithmetic follows the JAX package where torch's differs.

  * `Linear`, `Conv2d`: compute in their input's dtype. Parameters stay
    float32; each forward casts them to the input's dtype, as the JAX
    package's modules do with `dtype=` (f32 params, bf16 compute under
    `train.precision="bf16"`). A module's compute dtype is therefore set by
    casting its input, at the same places the JAX package casts. For
    float32 input these are exactly the stock torch layers. `nn.LayerNorm`
    takes a bf16 input with float32 parameters as it is (normalising in
    float32).
  * `BatchNorm2d`: flax `nn.BatchNorm(momentum=0.9)` in training.

Dropout is `ops/dropout.py`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


# std of a unit normal cut at ±2: flax's `variance_scaling` divides by it
# so that the cut draw keeps the asked-for variance
_TRUNC_NORMAL_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(mod: nn.Module, generator: torch.Generator | None = None) -> None:
    """flax's default init of a Dense or Conv: `lecun_normal` on the weight
    (a normal cut at ±2σ, σ rescaled so that the variance is 1/fan_in) and
    a zero bias, drawn from `generator`."""
    std = mod.weight[0].numel() ** -0.5 / _TRUNC_NORMAL_STD
    nn.init.trunc_normal_(mod.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    if mod.bias is not None:
        mod.bias.zero_()


def _cast(p: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor | None:
    return None if p is None else p.to(dtype)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  _cast(self.bias, x.dtype))


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` whose training step updates the running statistics
    as flax does (`renderih_tpu/models/resnet.py`, `momentum=0.9`).

    Both normalise with the biased batch variance, but torch blends the
    *unbiased* one into `running_var`; flax blends the biased one. With
    n values a channel and torch momentum m (flax's 1 - m):
        flax  = (1 - m) r0 + m v
        torch = (1 - m) r0 + m v n / (n - 1)
    so flax = torch (n - 1) / n + (1 - m) r0 / n, which the forward applies
    after the stock kernel (statistics in float32 for a bf16 input either
    way). The module and buffer names are torch's; `num_batches_tracked`
    stays 0, since the momentum is fixed. Eval is the stock module.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        n = x.numel() // x.shape[1]
        m = self.momentum
        # torch's update goes to a copy: the graph keeps the tensor it was
        # given, which must not change before the backward
        var = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, var, self.weight, self.bias, True, m,
                         self.eps)
        with torch.no_grad():
            torch.add(self.running_var * ((1.0 - m) / n), var, alpha=(n - 1) / n,
                      out=self.running_var)
        return y
