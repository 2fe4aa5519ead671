"""Rotation representations and conversions (counterpart of
`renderih_tpu/ops/rotation.py`).

Every function is batched over leading dimensions and differentiable.

  * axis-angle -> rotation matrix: the sinc/cosc form of Rodrigues with a
    Taylor branch below t² = 1e-8, so the zero pose (where every pose
    refinement starts) has exact, finite gradients.
  * matrix -> axis-angle mirrors the quadrant handling of the reference's
    `ManoLayer.Rmat2axis` (asin angle with a cosine-sign fixup).
  * 6D rotation follows Zhou et al. CVPR'19 (columns a1, a2 interleaved).
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric cross-product matrix. v: (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    rows = [
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def rodrigues(axis_angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3).

    R = I + sinc(t) K + cosc(t) K² with K = hat(axis) unnormalised,
    sinc(t) = sin(t)/t, cosc(t) = (1 - cos t)/t², and Taylor branches for
    t² < 1e-8 (both branches are evaluated; `where` picks one, and the
    safe t² keeps the unused branch finite so its gradient is 0, not NaN).
    """
    t2 = torch.sum(axis_angle * axis_angle, dim=-1, keepdim=True)
    small = t2 < 1e-8
    t2_safe = torch.where(small, torch.ones_like(t2), t2)
    t = torch.sqrt(t2_safe)
    sinc = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    cosc = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / t2_safe)
    k = _hat(axis_angle)
    k2 = k @ k
    eye = torch.eye(3, dtype=axis_angle.dtype, device=axis_angle.device)
    return eye + sinc[..., None] * k + cosc[..., None] * k2


def rodrigues_inverse(rotmat: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> axis-angle (..., 3)."""
    r = rotmat
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    anti = (r - r.transpose(-1, -2)) / 2.0
    # (R32-R23, R13-R31, R21-R12)/2 ~ sin(t) * axis
    l_vec = torch.stack([anti[..., 2, 1], anti[..., 0, 2], anti[..., 1, 0]], dim=-1)
    sin = torch.linalg.norm(l_vec, dim=-1)
    axis = l_vec / (sin[..., None] + _EPS)

    sym = (r + r.transpose(-1, -2)) / 2.0 - eye
    outer = axis[..., :, None] * axis[..., None, :] - eye
    tr_sym = torch.diagonal(sym, dim1=-2, dim2=-1).sum(-1)
    tr_outer = torch.diagonal(outer, dim1=-2, dim2=-1).sum(-1)
    cos = 1.0 - tr_sym / (tr_outer + _EPS)

    sin_c = torch.clamp(sin, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arcsin(sin_c)
    # quadrant fixup when cos < 0 (same constants as the reference)
    theta = torch.where((cos < 0) & (sin_c > 0), 3.14159 - theta, theta)
    theta = torch.where((cos < 0) & (sin_c < 0), -3.14159 - theta, theta)
    return theta[..., None] * axis


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """6D rotation (..., 6) -> (..., 3, 3) by Gram-Schmidt; x.reshape(..., 3, 2)
    holds a1 in column 0 and a2 in column 1."""
    m = x.reshape(x.shape[:-1] + (3, 2))
    a1, a2 = m[..., 0], m[..., 1]
    b1 = a1 / (torch.linalg.norm(a1, dim=-1, keepdim=True) + _EPS)
    a2_proj = torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2 - a2_proj
    b2 = b2 / (torch.linalg.norm(b2, dim=-1, keepdim=True) + _EPS)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def axis_angle_rotate(points: torch.Tensor, axis_angle: torch.Tensor) -> torch.Tensor:
    """Rotate points (..., N, 3) by axis-angle (..., 3)."""
    rot = rodrigues(axis_angle)
    return torch.einsum("...ij,...nj->...ni", rot, points)


def rotmat_z(theta_deg: torch.Tensor) -> torch.Tensor:
    """In-plane (z-axis) rotation of the 2D augmentation, with the
    reference's 3.14159 approximation of pi (`imgUtils.get_rotation_mat3d`)."""
    t = theta_deg * (3.14159 / 180.0)
    c, s = torch.cos(t), torch.sin(t)
    zero = torch.zeros_like(t)
    one = torch.ones_like(t)
    row0 = torch.stack([c, -s, zero], dim=-1)
    row1 = torch.stack([s, c, zero], dim=-1)
    row2 = torch.stack([zero, zero, one], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)
