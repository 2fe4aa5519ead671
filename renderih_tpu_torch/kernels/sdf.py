"""SDF voxelisation of one mesh: CUDA kernel + plain version (kernel B3).

`sdf_grid(verts, faces, grid_size)` returns `(phi (G, G, G), bbox_min (3,),
scale ())`, the contract of `renderih_tpu/ops/sdf.py:sdf_grid` and of
`renderih_tpu/kernels/sdf_pallas.py:sdf_grid_pallas`, whose `_sdf_kernel`
the CUDA kernel (`csrc/sdf.cu`) replaces. The grid covers the mesh's bbox,
cubed and padded x1.1; voxel centres are `bbox_min + scale * (k + 0.5) / G`,
stacked [x, y, z] from an ij-meshgrid of (z, y, x), so `phi` is indexed
[z, y, x]. phi is the distance to the surface for voxels inside the mesh
(odd count of crossings along `RAY_DIR`) and 0 outside.

Dispatch: a CPU tensor takes the plain version (`sdf_grid_reference`); a
CUDA tensor launches the kernel or raises. The field has no backward (the
JAX package builds it under `stop_gradient`, upstream's op had none), so a
`verts` that requires grad while grad is on is refused. The bbox and the
grid frame are computed in torch on the device, under `no_grad`.

The plain version and the kernel do the same float32 arithmetic in the
same order: every dot product is summed x, y, z left to right, and
`sdf.cu` is built with `-fmad=false`, so the crossing parity (a
discontinuous function of the inputs) agrees voxel for voxel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from renderih_tpu_torch.kernels import _build

_EPS = 1e-12

# Generic ray direction for the parity test: axis-aligned rays are
# degenerate for axis-aligned geometry (a +x ray from a cube centre exits
# through the diagonal edge shared by two triangles and counts twice).
# Normalised (3, 2, 1), the constant of `renderih_tpu/ops/sdf.py:_RAY_DIR`.
RAY_DIR = (0.801783726, 0.534522484, 0.267261242)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {f"sdf_grid_{t}": (_P, _P, _P, _P, _P, _I, _I, _P)
               for t in ("i32", "i64")}
_FACE_SUFFIX = {torch.int32: "i32", torch.int64: "i64"}

launches = _build.LaunchCounter()


def _dot(a, b):
    """Dot product of two 3-vectors given as (x, y, z) tuples of tensors,
    summed x, y, z left to right (the kernel's order)."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _sub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def _xyz(t: torch.Tensor):
    return t[..., 0], t[..., 1], t[..., 2]


def _dist_sq(p, v0, e0, e1):
    """Squared point-triangle distance (Eberly) on (x, y, z) tuples whose
    leading dims broadcast: the least of the interior minimiser (where it
    lies inside) and the three clamped edge minimisers, exact for the
    convex quadratic."""
    d = _sub(v0, p)
    a00, a01, a11 = _dot(e0, e0), _dot(e0, e1), _dot(e1, e1)
    b0, b1 = _dot(e0, d), _dot(e1, d)
    det = torch.clamp_min(a00 * a11 - a01 * a01, _EPS)
    s = a01 * b1 - a11 * b0
    t = a01 * b0 - a00 * b1
    inside = (s + t <= det) & (s >= 0) & (t >= 0)

    def dist_sq(ss, tt):
        diff = tuple((dc + ss * c0) + tt * c1 for dc, c0, c1 in zip(d, e0, e1))
        return _dot(diff, diff)

    t_s0 = torch.clamp(-b1 / torch.clamp_min(a11, _EPS), 0.0, 1.0)
    s_t0 = torch.clamp(-b0 / torch.clamp_min(a00, _EPS), 0.0, 1.0)
    s_diag = torch.clamp(((a11 + b1) - (a01 + b0))
                         / torch.clamp_min(a00 - 2 * a01 + a11, _EPS), 0.0, 1.0)
    best = torch.where(inside, dist_sq(s / det, t / det),
                       torch.full_like(s, float("inf")))
    best = torch.minimum(best, dist_sq(torch.zeros_like(t_s0), t_s0))
    best = torch.minimum(best, dist_sq(s_t0, torch.zeros_like(s_t0)))
    return torch.minimum(best, dist_sq(s_diag, 1.0 - s_diag))


def _hits(p, v0, e1, e2):
    """Möller-Trumbore: does the ray from p along `RAY_DIR` cross the
    triangle (v0, v0 + e1, v0 + e2)? (x, y, z) tuples, broadcast."""
    ray = RAY_DIR
    pvec = _cross(ray, e2)
    det = _dot(e1, pvec)
    ok = det.abs() > 1e-10
    inv_det = torch.where(ok, 1.0 / det, torch.zeros_like(det))
    tvec = _sub(p, v0)
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1)
    v = _dot(qvec, ray) * inv_det
    t = _dot(qvec, e2) * inv_det
    return ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-9)


def _edges(tri: torch.Tensor):
    v0 = _xyz(tri[..., 0, :])
    return v0, _sub(_xyz(tri[..., 1, :]), v0), _sub(_xyz(tri[..., 2, :]), v0)


def point_triangle_distance_sq(p: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """Squared distance from points p (..., 3) to triangles tri (..., 3, 3),
    leading dims broadcast."""
    return _dist_sq(_xyz(p), *_edges(tri))


def ray_crossings_x(p: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """Crossings of the ray from each point p (N, 3) along `RAY_DIR` with
    the triangles tri (F, 3, 3): (N,) int32 counts."""
    v0, e1, e2 = _edges(tri)
    return _hits(_xyz(p[:, None, :]), v0, e1, e2).sum(dim=-1, dtype=torch.int32)


def grid_frame(verts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(bbox_min (3,), scale ()): the mesh's bbox, cubed and padded x1.1."""
    lo = verts.min(dim=0).values
    hi = verts.max(dim=0).values
    center = (lo + hi) / 2.0
    half = (hi - lo).max() / 2.0 * 1.1
    return center - half, 2.0 * half


def grid_points(bbox_min: torch.Tensor, scale: torch.Tensor,
                grid_size: int) -> torch.Tensor:
    """(G³, 3) voxel centres [x, y, z], z slowest. The fractions (k + 0.5) / G
    are rounded once in float32, as the kernel computes them (torch's CUDA
    division by a host scalar multiplies by its reciprocal instead)."""
    lin_np = (np.arange(grid_size, dtype=np.float32) + np.float32(0.5)) / np.float32(grid_size)
    lin = torch.from_numpy(lin_np).to(bbox_min.device)
    zz, yy, xx = torch.meshgrid(lin, lin, lin, indexing="ij")
    return bbox_min + scale * torch.stack([xx, yy, zz], -1).reshape(-1, 3)


def sdf_grid_reference(verts: torch.Tensor, faces: torch.Tensor,
                       grid_size: int = 32, block: int | None = None):
    """Plain version: the torch port of `renderih_tpu/ops/sdf.py:sdf_grid`,
    `block` voxels at a time against every face (the last block ragged,
    so any G works). By default 64 voxels a block on the CPU (its caches),
    4096 on the card (fewer launches)."""
    if block is None:
        block = 64 if verts.device.type == "cpu" else 4096
    with torch.no_grad():
        bbox_min, scale = grid_frame(verts)
        pts = grid_points(bbox_min, scale, grid_size)
        v0, e0, e1 = _edges(verts[faces.long()])  # per face, (F,) each
        chunks = []
        for start in range(0, pts.shape[0], block):
            p = _xyz(pts[start:start + block, None, :])  # (block, 1) each
            dist = torch.sqrt(_dist_sq(p, v0, e0, e1).min(dim=-1).values)
            crossings = _hits(p, v0, e0, e1).sum(dim=-1, dtype=torch.int32)
            chunks.append(torch.where(crossings % 2 == 1, dist, torch.zeros_like(dist)))
        g = grid_size
        return torch.cat(chunks).reshape(g, g, g), bbox_min, scale


def sdf_grid(verts: torch.Tensor, faces: torch.Tensor, grid_size: int = 32):
    """Penetration field of one mesh: verts (V, 3), faces (F, 3) ->
    (phi (G, G, G) [z, y, x], bbox_min (3,), scale ())."""
    if torch.is_grad_enabled() and verts.requires_grad:
        raise RuntimeError("sdf_grid has no backward: pass detached vertices")
    if faces.device != verts.device:
        raise ValueError(f"sdf_grid: verts on {verts.device}, faces on {faces.device}")
    if verts.device.type == "cpu":
        return sdf_grid_reference(verts, faces, grid_size)
    if not verts.is_cuda:
        raise ValueError(f"sdf_grid: unsupported device {verts.device}")
    if verts.dtype != torch.float32 or faces.dtype not in _FACE_SUFFIX:
        raise TypeError(f"sdf_grid: verts must be float32 and faces int32 or "
                        f"int64, got {verts.dtype}, {faces.dtype}")
    if verts.dim() != 2 or verts.shape[1] != 3 or faces.dim() != 2 \
            or faces.shape[1] != 3 or verts.shape[0] == 0:
        raise ValueError(f"sdf_grid: bad shapes verts {tuple(verts.shape)}, "
                         f"faces {tuple(faces.shape)}")
    if grid_size < 1:
        raise ValueError(f"sdf_grid: grid_size {grid_size} < 1")
    verts, faces = verts.contiguous(), faces.contiguous()
    with torch.no_grad():
        bbox_min, scale = grid_frame(verts)
    return launch_sdf(verts, faces, bbox_min, scale, grid_size), bbox_min, scale


def launch_sdf(verts: torch.Tensor, faces: torch.Tensor, bbox_min: torch.Tensor,
               scale: torch.Tensor, grid_size: int) -> torch.Tensor:
    """The kernel alone on checked, contiguous CUDA inputs and a computed
    grid frame -> phi (G, G, G)."""
    g = grid_size
    phi = torch.empty((g, g, g), dtype=torch.float32, device=verts.device)
    lib = _build.load("sdf", _SIGNATURES)
    fn = getattr(lib, f"sdf_grid_{_FACE_SUFFIX[faces.dtype]}")
    with torch.cuda.device(verts.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(verts.data_ptr(), faces.data_ptr(), bbox_min.data_ptr(),
                 scale.data_ptr(), phi.data_ptr(), faces.shape[0], g, stream)
    if err != 0:
        raise RuntimeError(f"sdf_grid: kernel launch failed (CUDA error {err})")
    launches.add()
    return phi
