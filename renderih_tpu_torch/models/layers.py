"""Layers whose arithmetic follows the JAX package where torch's differs.

  * `Linear`, `Conv2d`: compute in their input's dtype. Parameters stay
    float32; each forward casts them to the input's dtype, as the JAX
    package's modules do with `dtype=` (f32 params, bf16 compute under
    `train.precision="bf16"`). A module's compute dtype is therefore set by
    casting its input, at the same places the JAX package casts. For
    float32 input these are exactly the stock torch layers.
  * `LayerNorm`: flax `nn.LayerNorm(dtype=...)` on float32 parameters:
    normalises in float32 and returns its input's dtype. torch's CPU kernel
    takes a bf16 input with float32 parameters as it is, but its CUDA
    kernel refuses the mix, so the input is cast up and the result down.
  * `BatchNorm2d`: flax `nn.BatchNorm(momentum=0.9)` in training.

Dropout is `ops/dropout.py`.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
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


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(x.dtype)


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

    In a process group of more than one rank the training statistics are
    global over the ranks' batches, as under JAX's data mesh: flax's
    `nn.BatchNorm` has no `axis_name`, and the jitted step's batch is one
    array sharded on `data`, so its mean and variance span the whole
    batch (`_GlobalBatchNorm`). The running variance is blended with the
    global biased variance, flax's rule. Stock `nn.SyncBatchNorm` blends
    the unbiased one. With no group, or a group of one rank, the module
    takes the one-device path above.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
                self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            return y
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


def _channel(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


class _GlobalBatchNorm(torch.autograd.Function):
    """Training BatchNorm over the batches of every rank of the process
    group, statistics in float32.

    Forward: each rank's per-channel count n_r, mean and M2 (the sum of
    squared deviations, from `var_mean`) go to every rank in one
    all-reduce (each rank fills its own row of a zeroed (W, 2C + 1)
    table); each rank combines the rows alike (Chan et al.): N = Σ n_r,
    mean = Σ n_r·mean_r / N, M2 = Σ M2_r + n_r·(mean_r − mean)², var = M2/N.
    Backward: Σ dy and Σ dy·x̂ are all-reduced, and
        dx = γ/σ · (dy − Σdy/N − x̂·Σdy·x̂/N);
    dγ and dβ are this rank's own sums, which the step's gradient
    all-reduce averages with the others'. Returns (y, mean, biased var)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        c = x.shape[1]
        xf = x.float()
        var, mean = torch.var_mean(xf, (0, 2, 3), correction=0)
        n = x.numel() // c
        rows = torch.zeros(dist.get_world_size(), 2 * c + 1, device=x.device)
        rows[dist.get_rank()] = torch.cat([mean, var * n, mean.new_full((1,), n)])
        dist.all_reduce(rows)
        means, m2s, counts = rows[:, :c], rows[:, c:2 * c], rows[:, 2 * c:]
        total = counts.sum()
        mean = (counts * means).sum(0) / total
        var = (m2s + counts * (means - mean) ** 2).sum(0) / total
        invstd = torch.rsqrt(var + eps)
        y = (xf - _channel(mean)) * _channel(invstd * weight) + _channel(bias)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.total = total
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd = ctx.saved_tensors
        c = x.shape[1]
        dyf = dy.float()
        xhat = (x.float() - _channel(mean)) * _channel(invstd)
        sums = torch.cat([dyf.sum((0, 2, 3)), (dyf * xhat).sum((0, 2, 3))])
        local = sums.clone()
        dist.all_reduce(sums)
        sum_dy, sum_dy_xhat = sums[:c] / ctx.total, sums[c:] / ctx.total
        dx = _channel(weight * invstd) * (dyf - _channel(sum_dy) - xhat * _channel(sum_dy_xhat))
        return dx.to(x.dtype), local[c:], local[:c], None
