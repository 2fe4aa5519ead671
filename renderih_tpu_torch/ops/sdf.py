"""Signed-distance penetration field and the two-hand penetration loss
(counterpart of `renderih_tpu/ops/sdf.py`).

For one mesh, `sdf_grid` fills a G³ grid over its bbox with phi = the
distance to the surface inside the mesh and 0 outside (parity ray cast),
the output of upstream's CUDA op (`sdf_cuda_kernel.cu:291-300`). On the
card it is kernel B3 (`kernels/sdf.py`, `csrc/sdf.cu`); on the CPU its plain
version. The field is built from detached vertices and has no backward:
gradients reach the penalised mesh through the trilinear sample only.
"""

from __future__ import annotations

import torch

from renderih_tpu_torch.kernels.sdf import (  # noqa: F401  (re-exported)
    RAY_DIR,
    point_triangle_distance_sq,
    ray_crossings_x,
    sdf_grid,
    sdf_grid_reference,
)


def sample_sdf_trilinear(phi: torch.Tensor, bbox_min: torch.Tensor,
                         scale: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of phi (G, G, G) [z, y, x] at points (N, 3) -> (N,).

    Indices are clamped to the grid and the fractions are not, exactly as
    the JAX package does, so points outside the bbox extrapolate along the
    border cells; the gradient flows through the fractions."""
    g = phi.shape[0]
    uvw = (points - bbox_min) / scale * g - 0.5

    def axis(v):
        v0 = torch.floor(v)
        frac = v - v0
        i0 = torch.clamp(v0.long(), 0, g - 1)
        i1 = torch.clamp(i0 + 1, 0, g - 1)
        return i0, i1, frac

    x0, x1, fx = axis(uvw[:, 0])
    y0, y1, fy = axis(uvw[:, 1])
    z0, z1, fz = axis(uvw[:, 2])

    c00 = phi[z0, y0, x0] * (1 - fx) + phi[z0, y0, x1] * fx
    c01 = phi[z0, y1, x0] * (1 - fx) + phi[z0, y1, x1] * fx
    c10 = phi[z1, y0, x0] * (1 - fx) + phi[z1, y0, x1] * fx
    c11 = phi[z1, y1, x0] * (1 - fx) + phi[z1, y1, x1] * fx
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def sdf_penetration_loss(verts_a: torch.Tensor, verts_b: torch.Tensor,
                         faces_a: torch.Tensor, grid_size: int = 32,
                         robustifier: float | None = None) -> torch.Tensor:
    """Mean over the batch of the summed depth of B's vertices inside A.

    verts_a, verts_b (B, V, 3); one field per batch element, built from
    A's detached vertices; optional Geman-McClure robustifier of upstream's
    `SDFLoss.forward`."""
    total = []
    for va, vb in zip(verts_a, verts_b):
        phi, bmin, scale = sdf_grid(va.detach(), faces_a, grid_size)
        pen = sample_sdf_trilinear(phi, bmin, scale, vb)
        if robustifier is not None:
            frac = (pen / robustifier) ** 2
            pen = frac / (frac + 1.0)
        total.append(pen.sum())
    return torch.stack(total).mean()
