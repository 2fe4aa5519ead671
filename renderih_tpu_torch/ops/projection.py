"""Orthographic camera of the two-hand head (counterpart of
`renderih_tpu/ops/projection.py:orthographic_project`).

    uv = scale * img_size * xyz[..., :2] + (trans2d * img_size / 2 + img_size / 2)

matching `projection_batch` in the reference (`utils/manoutils.py:26-44`).
"""

from __future__ import annotations

import torch


def orthographic_project(scale: torch.Tensor, trans2d: torch.Tensor,
                         points3d: torch.Tensor,
                         img_size: float = 256.0) -> torch.Tensor:
    """scale (...,), trans2d (..., 2), points3d (..., N, 3) -> (..., N, 2)
    pixel coordinates."""
    s = (scale * img_size)[..., None, None]
    t = (trans2d * img_size / 2.0 + img_size / 2.0)[..., None, :]
    return s * points3d[..., :2] + t
