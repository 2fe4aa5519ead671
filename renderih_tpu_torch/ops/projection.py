"""Cameras of the two-hand stack (counterpart of
`renderih_tpu/ops/projection.py`).

Orthographic: the model predicts, per hand, a scalar `scale` and a 2D
`trans2d` in normalised units; projection to pixels is

    uv = scale * img_size * xyz[..., :2] + (trans2d * img_size / 2 + img_size / 2)

matching `projection_batch` in the reference (`utils/manoutils.py:26-44`).

Pinhole: camera-space points through per-frame 3x3 intrinsics `cameraIn`,
as the reference's `utils/compute_maskiou.py:190-198`
(`p = v @ K.T; uv = p[:, :2] / p[:, 2:]`) and its `PerspectiveCameras`
(`utils/vis_utils.py:72-80`).
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


def pinhole_project(points_cam: torch.Tensor, camera_in: torch.Tensor,
                    eps: float = 1e-9) -> tuple:
    """points_cam (..., N, 3) in camera space (+z towards the scene),
    camera_in (..., 3, 3) -> (uv (..., N, 2) pixels, the homogeneous
    (K p)_xy / ((K p)_z + eps); depth (..., N), camera-space z, the
    rasteriser's depth key: smaller is closer)."""
    p = torch.einsum("...ij,...nj->...ni", camera_in, points_cam)
    return p[..., :2] / (p[..., 2:] + eps), points_cam[..., 2]
