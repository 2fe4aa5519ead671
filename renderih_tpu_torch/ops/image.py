"""Image normalisation (counterpart of `renderih_tpu/ops/image.py`)."""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_imagenet(img01: torch.Tensor) -> torch.Tensor:
    """[0,1] RGB, channels last (..., 3) -> ImageNet-normalized."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=img01.dtype, device=img01.device)
    std = torch.tensor(IMAGENET_STD, dtype=img01.dtype, device=img01.device)
    return (img01 - mean) / std
