"""Orthographic z-buffer rasteriser (counterpart of
`renderih_tpu/render/rasterize.py`).

One face per pixel (hard z-test, smaller z wins), flat barycentric
interpolation of per-vertex attributes, pixel centres at integer
coordinates. The rasteriser takes already-projected pixel coordinates and
a depth key, so any camera feeds it. Every (pixel, face) pair is tested,
a block of image rows at a time to bound memory; the JAX package's `vmap`
over scenes is a batch dimension here.
"""

from __future__ import annotations

import torch


def _raster_rows(verts2d: torch.Tensor, z: torch.Tensor, attrs: torch.Tensor,
                 faces: torch.Tensor, ys: torch.Tensor, width: int):
    """verts2d (B, V, 2), z (B, V), attrs (B, V, A), faces (F, 3), ys (R,)
    -> attr (B, R, W, A), hit (B, R, W), zbuf (B, R, W)."""
    bs = verts2d.shape[0]
    tri = verts2d[:, faces]                    # (B, F, 3, 2)
    tz = z[:, faces]                           # (B, F, 3)
    ta = attrs[:, faces]                       # (B, F, 3, A)

    v0 = tri[:, :, 0]
    e1 = tri[:, :, 1] - v0
    e2 = tri[:, :, 2] - v0
    det = e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0]   # (B, F)
    ok = det.abs() > 1e-12
    inv_det = torch.where(ok, 1.0 / det, torch.zeros_like(det))

    xs = torch.arange(width, dtype=verts2d.dtype, device=verts2d.device)
    py, px = torch.meshgrid(ys, xs, indexing="ij")            # (R, W)
    px, py = px.reshape(1, -1, 1), py.reshape(1, -1, 1)       # N = R * W pixels

    dx = px - v0[:, None, :, 0]                               # (B, N, F)
    dy = py - v0[:, None, :, 1]
    u = (dx * e2[:, None, :, 1] - dy * e2[:, None, :, 0]) * inv_det[:, None]
    v = (-dx * e1[:, None, :, 1] + dy * e1[:, None, :, 0]) * inv_det[:, None]
    del dx, dy
    w = 1.0 - u - v
    inside = (u >= 0) & (v >= 0) & (w >= 0) & ok[:, None]
    zi = w * tz[:, None, :, 0] + u * tz[:, None, :, 1] + v * tz[:, None, :, 2]
    del w
    zi = torch.where(inside, zi, torch.full_like(zi, float("inf")))
    del inside
    best = torch.argmin(zi, dim=2, keepdim=True)               # first on ties
    zbuf = torch.gather(zi, 2, best)[..., 0]
    hit = zbuf < float("inf")
    ub = torch.gather(u, 2, best)[..., 0]
    vb = torch.gather(v, 2, best)[..., 0]
    wb = 1.0 - ub - vb
    fa = ta[torch.arange(bs, device=ta.device)[:, None], best[..., 0]]  # (B, N, 3, A)
    attr = wb[..., None] * fa[:, :, 0] + ub[..., None] * fa[:, :, 1] + vb[..., None] * fa[:, :, 2]
    # misses get 0: the argmin face's barycentric extrapolation is garbage
    attr = torch.where(hit[..., None], attr, torch.zeros_like(attr))
    r = ys.shape[0]
    return (attr.reshape(bs, r, width, -1), hit.reshape(bs, r, width),
            zbuf.reshape(bs, r, width))


def rasterize_orthographic(verts2d: torch.Tensor, z: torch.Tensor, attrs: torch.Tensor,
                           faces: torch.Tensor, height: int = 256, width: int = 256,
                           row_block: int = 16):
    """Rasterise a batch of meshes sharing `faces`: verts2d (B, V, 2) pixel
    coordinates, z (B, V) depth, attrs (B, V, A). Returns (attr (B, H, W, A),
    mask (B, H, W), zbuf (B, H, W)). `row_block` must divide `height`."""
    if height % row_block:
        raise ValueError(f"row_block {row_block} does not divide height {height}")
    ys = torch.arange(height, dtype=verts2d.dtype, device=verts2d.device)
    parts = [_raster_rows(verts2d, z, attrs, faces, rows, width)
             for rows in ys.reshape(-1, row_block)]
    return tuple(torch.cat(p, dim=1) for p in zip(*parts))


def pick_row_block(batch: int, height: int, width: int, n_faces: int,
                   budget_elems: int = 100_000_000) -> int:
    """Largest divisor of `height` (<= 16) whose per-block (batch,
    row_block * width, n_faces) intermediates stay under `budget_elems`
    elements each (at batch 32, 256² and 3104 faces a row block of 16
    would need 1.6 GB for each of u, v and z)."""
    per_row = max(1, batch) * width * max(1, n_faces)
    rb = max(1, min(16, int(budget_elems // per_row)))
    while height % rb:
        rb -= 1
    return rb
