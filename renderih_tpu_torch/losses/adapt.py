"""Domain adaptation: gradient reversal and a feature discriminator
(counterpart of `renderih_tpu/losses/adapt.py`; reference
`common/myhand/model_adapt.py:18-90`, `common/nets/discriminator.py`).

A labelled source batch and an unlabelled target batch share the encoder;
a domain discriminator on the global feature, behind the DANN
gradient-reversal layer, pushes the encoder toward domain-invariant
features in the same backward pass that trains the discriminator.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from renderih_tpu_torch.models.layers import Linear


class _GradientReversal(torch.autograd.Function):
    """Identity forward; -lam * g backward (the JAX `custom_vjp`)."""

    @staticmethod
    def forward(ctx, x, lam: float):
        ctx.lam = lam
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.lam * g, None


def gradient_reversal(x: torch.Tensor, lam: float = 1.0) -> torch.Tensor:
    """Identity forward; -lam * grad backward (DANN)."""
    return _GradientReversal.apply(x, lam)


class DomainDiscriminator(nn.Module):
    """MLP domain classifier on the global feature: (B, in_dim) -> logits (B,)."""

    def __init__(self, in_dim: int = 2048, hidden: int = 512):
        super().__init__()
        self.fc1 = Linear(in_dim, hidden)
        self.fc2 = Linear(hidden, hidden // 4)
        self.out = Linear(hidden // 4, 1)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        return self.out(F.relu(self.fc2(F.relu(self.fc1(feat)))))[..., 0]


def domain_adaptation_loss(disc: DomainDiscriminator, feat_source: torch.Tensor,
                           feat_target: torch.Tensor, lam: float = 1.0) -> torch.Tensor:
    """DANN loss: the discriminator's sigmoid cross-entropy (source 1,
    target 0) on the features behind the gradient-reversal layer.
    Minimising it trains `disc`; the reversal makes the same objective push
    the features toward domain confusion. Ramp `lam` 0 -> 1 over warm-up."""
    feats = gradient_reversal(torch.cat([feat_source, feat_target]), lam)
    logits = disc(feats)
    labels = torch.cat([logits.new_ones(feat_source.shape[0]),
                        logits.new_zeros(feat_target.shape[0])])
    return F.binary_cross_entropy_with_logits(logits, labels)
