"""Linear and Conv2d that compute in their input's dtype.

Parameters stay float32; each forward casts them to the input's dtype, as
the JAX package's modules do with `dtype=` (f32 params, bf16 compute under
`train.precision="bf16"`). A module's compute dtype is therefore set by
casting its input, at the same places the JAX package casts. For float32
input these are exactly the stock torch layers. `nn.LayerNorm` and
`nn.BatchNorm2d` take a bf16 input with float32 parameters as they are
(normalising in float32), so they need no counterpart here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _cast(p: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor | None:
    return None if p is None else p.to(dtype)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  _cast(self.bias, x.dtype))
