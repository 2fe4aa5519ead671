"""Focal and Dice losses (counterpart of `renderih_tpu/losses/focal.py`):
the plain formulation of the reference's mmcv `sigmoid_focal_loss`
(`common/utils/focal_loss.py:4,56-121`), stock elementwise ops."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor, gamma: float = 2.0,
                       alpha: float = 0.25) -> torch.Tensor:
    """Mean sigmoid focal loss (Lin et al., ICCV'17)."""
    p = torch.sigmoid(logits)
    ce = F.binary_cross_entropy_with_logits(logits, targets, reduction="none")
    p_t = p * targets + (1 - p) * (1 - targets)
    alpha_t = alpha * targets + (1 - alpha) * (1 - targets)
    return torch.mean(alpha_t * (1 - p_t) ** gamma * ce)


def dice_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 1.0) -> torch.Tensor:
    """Soft Dice loss over the last two (spatial) axes."""
    num = 2.0 * torch.sum(pred * target, dim=(-1, -2)) + eps
    den = torch.sum(pred ** 2, dim=(-1, -2)) + torch.sum(target ** 2, dim=(-1, -2)) + eps
    return torch.mean(1.0 - num / den)
