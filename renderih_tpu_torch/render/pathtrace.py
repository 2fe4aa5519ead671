"""Monte-Carlo path tracer for offline synthetic data (counterpart of
`renderih_tpu/render/pathtrace.py`).

It closes the gap between the rasteriser's local shading
(`render/renderer.py`) and the reference's offline Blender/Cycles renders
(`rendering_code/step4_load_mano_diffbg.py`): shadow rays to a disk area
light (soft shadows), diffuse interreflection over a fixed number of
bounces, and a constant environment for escaped paths.

* Intersection is brute-force Moller-Trumbore of every ray against every
  triangle (two MANO hands are ~3.1k faces), as (scene, ray, triangle)
  tensor ops in chunks of rays: `max(256, 8192 // B)` rays a scene for B
  scenes at once, so the (B, chunk, T, 3) temporaries stay near one
  scene's 8192-ray budget whatever the batch. Stock PyTorch ops; no
  kernel of its own.
* The primary hit is deterministic (one ray a pixel at integer (x, y),
  along +z: the rasteriser's sample points and depth order), traced once
  and shared by every sample; shadow and bounce rays are per sample.
* Randomness is explicit: `draw_paths` draws every uniform a render uses
  (per scene, sample and path vertex: the disk light's r and phi, the
  cosine-weighted bounce's r1 and r2) from a `torch.Generator`, and
  `render_scene` is a deterministic function of them, so the JAX
  package's draws can be fed to it.
* Geometry lives in a render space: x, y from `orthographic_project`
  (pixels) and z scaled by the same pixels-per-metre factor.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from renderih_tpu_torch.ops.projection import orthographic_project
from renderih_tpu_torch.render.renderer import vertex_normals

_EPS_DET = 1e-9       # Moller-Trumbore degenerate-triangle guard
_RAY_EPS = 1e-3       # surface offset along the normal (pixels)


class Scene(NamedTuple):
    """Per-triangle data of B meshes in render space."""

    v0: torch.Tensor       # (B, T, 3) first vertex of each triangle
    e1: torch.Tensor       # (B, T, 3) v1 - v0
    e2: torch.Tensor       # (B, T, 3) v2 - v0
    n_vert: torch.Tensor   # (B, T, 3, 3) smooth vertex normals at the corners
    a_vert: torch.Tensor   # (B, T, 3, 3) albedo at the corners


class PathDraws(NamedTuple):
    """Every uniform in [0, 1) of one render, R rays a scene: the disk
    light's (r, phi) draws at each of the n_bounces + 1 path vertices and
    the bounce direction's (r1, r2) at each of the n_bounces bounces."""

    disk_r: torch.Tensor    # (B, spp, n_bounces + 1, R)
    disk_phi: torch.Tensor  # (B, spp, n_bounces + 1, R)
    cos_r1: torch.Tensor    # (B, spp, n_bounces, R)
    cos_r2: torch.Tensor    # (B, spp, n_bounces, R)


def draw_paths(gen: torch.Generator, bs: int, spp: int, n_bounces: int,
               n_rays: int) -> PathDraws:
    """The draws of a render of `bs` scenes, on the generator's device."""
    def u(events):
        return torch.rand((bs, spp, events, n_rays), generator=gen, device=gen.device)

    return PathDraws(u(n_bounces + 1), u(n_bounces + 1), u(n_bounces), u(n_bounces))


def build_scene(verts: torch.Tensor, faces: torch.Tensor, albedo: torch.Tensor) -> Scene:
    """verts (B, V, 3) in render space, faces (T, 3), albedo (B, V, 3)."""
    tri = verts[:, faces]                        # (B, T, 3, 3)
    vn = vertex_normals(verts, faces)            # (B, V, 3)
    return Scene(v0=tri[:, :, 0], e1=tri[:, :, 1] - tri[:, :, 0],
                 e2=tri[:, :, 2] - tri[:, :, 0], n_vert=vn[:, faces], a_vert=albedo[:, faces])


def _intersect_chunk(o: torch.Tensor, d: torch.Tensor, scene: Scene):
    """Nearest hit of rays o, d (B, R, 3) against each scene's triangles:
    (t, tri, u, v), each (B, R); t = +inf on a miss, tri the first
    triangle at the least t (0 on a miss)."""
    h = torch.linalg.cross(d[:, :, None, :], scene.e2[:, None], dim=-1)   # (B, R, T, 3)
    a = torch.sum(scene.e1[:, None] * h, dim=-1)                          # (B, R, T)
    ok = torch.abs(a) > _EPS_DET
    f = torch.where(ok, 1.0 / a, torch.zeros_like(a))
    s = o[:, :, None, :] - scene.v0[:, None]                              # (B, R, T, 3)
    u = f * torch.sum(s * h, dim=-1)
    del h
    q = torch.linalg.cross(s, scene.e1[:, None].expand_as(s), dim=-1)
    del s
    v = f * torch.sum(d[:, :, None, :] * q, dim=-1)
    t = f * torch.sum(scene.e2[:, None] * q, dim=-1)
    del q, f
    valid = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > _RAY_EPS)
    t = torch.where(valid, t, torch.full_like(t, math.inf))
    tri = torch.argmin(t, dim=2, keepdim=True)
    return (torch.gather(t, 2, tri)[..., 0], tri[..., 0], torch.gather(u, 2, tri)[..., 0],
            torch.gather(v, 2, tri)[..., 0])


def intersect(o: torch.Tensor, d: torch.Tensor, scene: Scene, chunk: int = 8192):
    """Nearest hits of R rays a scene, o and d (B, R, 3), `chunk` rays a
    scene at a time; R is padded up to whole chunks with rays from the
    origin along +z, as the JAX package pads it. Returns (t, tri, u, v)."""
    bs, n = o.shape[:2]
    c = min(chunk, n)
    pad = (-n) % c
    if pad:
        o = torch.cat([o, o.new_zeros((bs, pad, 3))], dim=1)
        d = torch.cat([d, torch.tensor([0.0, 0.0, 1.0], dtype=d.dtype, device=d.device)
                       .expand(bs, pad, 3)], dim=1)
    parts = [_intersect_chunk(o[:, i:i + c], d[:, i:i + c], scene)
             for i in range(0, n + pad, c)]
    return tuple(torch.cat(p, dim=1)[:, :n] for p in zip(*parts))


def _interp(tri_attr: torch.Tensor, tri: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Barycentric interpolation of (B, T, 3, A) corner data at hits (B, R)."""
    corners = tri_attr[torch.arange(tri.shape[0], device=tri.device)[:, None], tri]
    w = 1.0 - u - v
    return (w[..., None] * corners[:, :, 0] + u[..., None] * corners[:, :, 1]
            + v[..., None] * corners[:, :, 2])


def _basis(n: torch.Tensor):
    """Branchless orthonormal tangents (Frisvad / Pixar) of unit n (..., 3)."""
    s = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    c = -1.0 / (s + n[..., 2] + 1e-12)
    b = n[..., 0] * n[..., 1] * c
    t1 = torch.stack([1.0 + s * n[..., 0] ** 2 * c, s * b, -s * n[..., 0]], -1)
    t2 = torch.stack([b, s + n[..., 1] ** 2 * c, -n[..., 1]], -1)
    return t1, t2


def cosine_sample(n: torch.Tensor, r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted hemisphere directions around normals n (B, R, 3)
    from uniforms r1, r2 (B, R)."""
    phi = 2.0 * math.pi * r1
    sin_t = torch.sqrt(r2)
    local = torch.stack([torch.cos(phi) * sin_t, torch.sin(phi) * sin_t,
                         torch.sqrt(torch.clamp_min(1.0 - r2, 0.0))], dim=-1)
    t1, t2 = _basis(n)
    return local[..., 0:1] * t1 + local[..., 1:2] * t2 + local[..., 2:3] * n


def disk_sample(center: torch.Tensor, normal: torch.Tensor, radius: torch.Tensor,
                u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Uniform points on each scene's oriented disk light (center, normal
    (B, 3), radius (B,)) from uniforms u1, u2 (B, R) -> (B, R, 3)."""
    r = radius[:, None] * torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    t1, t2 = _basis(normal)
    return (center[:, None] + (r * torch.cos(phi))[..., None] * t1[:, None]
            + (r * torch.sin(phi))[..., None] * t2[:, None])


def _direct_light(u1, u2, p, n, alb, scene: Scene, light: dict, chunk: int):
    """Next-event estimation against the disk light: the RGB (B, R, 3) that
    reaches each path vertex p with normal n and albedo alb (no
    throughput applied)."""
    lp = disk_sample(light["center"], light["normal"], light["radius"], u1, u2)
    wi = lp - p
    dist = torch.linalg.norm(wi, dim=-1) + 1e-9
    wi = wi / dist[..., None]
    cos_s = torch.clamp_min(torch.sum(n * wi, dim=-1), 0.0)
    cos_l = torch.clamp_min(torch.sum(-wi * light["normal"][:, None], dim=-1), 0.0)
    t_sh = intersect(p + _RAY_EPS * n, wi, scene, chunk=chunk)[0]
    vis = (t_sh >= dist - 2.0 * _RAY_EPS).to(p.dtype)
    area = math.pi * light["radius"] ** 2
    geom = cos_s * cos_l * area[:, None] / (dist ** 2 + 1e-9)   # pdf = 1 / area
    return (alb / math.pi) * (geom * vis)[..., None] * light["radiance"][:, None]


def _unit_facing(n: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """n normalised and turned against the incoming direction d."""
    n = n / (torch.linalg.norm(n, dim=-1, keepdim=True) + 1e-9)
    return torch.where(torch.sum(n * d, -1, keepdim=True) > 0, -n, n)


def render_scene(scene: Scene, draws: PathDraws, *, img_size: int, light: dict,
                 env_radiance, chunk: int = 8192):
    """Path-trace B scenes through the orthographic pixel camera on
    `draws` (its shape sets spp and the bounces).

    light: center, normal (B, 3), radius (B,), radiance (B, 3). Returns
    (rgb (B, H, W, 3) linear radiance, no environment on a primary miss:
    the background is composited outside, as with the rasteriser; mask
    (B, H, W) float, the primary hits)."""
    bs, spp, n_events, n = draws.disk_r.shape
    n_bounces = n_events - 1
    size = img_size
    dev, dtype = scene.v0.device, scene.v0.dtype
    xs = torch.arange(size, dtype=dtype, device=dev)
    py, px = torch.meshgrid(xs, xs, indexing="ij")
    o0 = torch.stack([px.reshape(-1), py.reshape(-1),
                      torch.full((size * size,), -1e4, dtype=dtype, device=dev)], -1)
    o0 = o0.expand(bs, -1, -1)
    d0 = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=dev).expand(bs, size * size, 3)
    env = torch.as_tensor(env_radiance, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)

    # the deterministic primary hit, shared by every sample
    t0, tri0, u0, v0 = intersect(o0, d0, scene, chunk=chunk)
    hit0 = torch.isfinite(t0)
    p0 = o0 + torch.where(hit0, t0, zero)[..., None] * d0
    n0 = _unit_facing(_interp(scene.n_vert, tri0, u0, v0), d0)
    alb0 = torch.clamp(_interp(scene.a_vert, tri0, u0, v0), 0.0, 1.0)

    acc = torch.zeros((bs, n, 3), dtype=dtype, device=dev)
    for i in range(spp):
        # iterative path tracing with next-event estimation: at each path
        # vertex add throughput x NEE, then extend the path by a
        # cosine-weighted bounce (its cos / pi over the pdf leaves the
        # albedo as the throughput's update)
        throughput = hit0[..., None].to(dtype)
        radiance = throughput * _direct_light(draws.disk_r[:, i, 0], draws.disk_phi[:, i, 0],
                                              p0, n0, alb0, scene, light, chunk)
        alive, p, nrm, alb = hit0, p0, n0, alb0
        for b in range(n_bounces):
            throughput = throughput * alb
            d = cosine_sample(nrm, draws.cos_r1[:, i, b], draws.cos_r2[:, i, b])
            t, tri, u, v = intersect(p + _RAY_EPS * nrm, d, scene, chunk=chunk)
            found = torch.isfinite(t)
            hit = found & alive
            escaped = alive & ~found
            radiance = radiance + torch.where(escaped[..., None], throughput * env, zero)
            p = p + _RAY_EPS * nrm + torch.where(hit, t, zero)[..., None] * d
            nrm = _unit_facing(_interp(scene.n_vert, tri, u, v), d)
            alb = torch.clamp(_interp(scene.a_vert, tri, u, v), 0.0, 1.0)
            radiance = radiance + torch.where(
                hit[..., None],
                throughput * _direct_light(draws.disk_r[:, i, b + 1], draws.disk_phi[:, i, b + 1],
                                           p, nrm, alb, scene, light, chunk),
                zero)
            alive = hit
        acc = acc + radiance
    rgb = (acc / spp).reshape(bs, size, size, 3)
    return rgb, hit0.reshape(bs, size, size).to(dtype)


class TwoHandPathTracer:
    """Path-traced counterpart of `TwoHandRenderer.render_rgb_orth`: the
    same per-hand orthographic cameras; z is scaled into pixels by the mean
    of the two hands' pixel scales, so the merged scene is one isotropic
    space. Faces live on `device`."""

    def __init__(self, assets, img_size: int = 256, device: torch.device | str = "cpu"):
        self.img_size = img_size
        nl = assets.left.mano.v_template.shape[0]
        self.faces = torch.cat([assets.left.mano.faces.long(),
                                assets.right.mano.faces.long() + nl]).to(device)
        self.num_verts = nl + assets.right.mano.v_template.shape[0]

    def scene(self, scale, trans2d, verts_left, verts_right, albedo, light_dir=None,
              light_radiance: float = 3.0):
        """The render-space scene of B two-hand meshes and its disk light
        (`render`'s arguments)."""
        size, bs = self.img_size, verts_left.shape[0]
        dev, dtype = verts_left.device, verts_left.dtype
        if light_dir is None:
            light_dir = torch.tensor([0.4, -0.3, -0.85], dtype=dtype, device=dev).expand(bs, 3)
        ld = light_dir / (torch.linalg.norm(light_dir, dim=-1, keepdim=True) + 1e-9)
        xy_l = orthographic_project(scale["left"], trans2d["left"], verts_left, size)
        xy_r = orthographic_project(scale["right"], trans2d["right"], verts_right, size)
        k_pix = (0.5 * (scale["left"] + scale["right"]) * size)[:, None, None]  # px / metre
        verts = torch.cat([torch.cat([xy_l, verts_left[..., 2:] * k_pix], -1),
                           torch.cat([xy_r, verts_right[..., 2:] * k_pix], -1)], dim=1)
        centre = torch.mean(verts, dim=1)
        extent = torch.amax(torch.linalg.norm(verts - centre[:, None], dim=-1), dim=1)
        radius = extent * 1.5 + 1e-3
        light = {
            "center": centre - ld * (extent * 4.0 + 1.0)[:, None],
            "normal": ld,
            "radius": radius,
            # radiance scaled so that the form factor is O(1) at the scene
            "radiance": torch.full((bs, 3), light_radiance, dtype=dtype, device=dev)
            * ((extent * 4.0 + 1.0) ** 2)[:, None] / (math.pi * radius ** 2)[:, None],
        }
        return build_scene(verts, self.faces, albedo), light

    def render(self, scale, trans2d, verts_left, verts_right, albedo, gen=None, *,
               draws: PathDraws | None = None, light_dir=None, light_radiance: float = 3.0,
               env_radiance=(0.25, 0.25, 0.25), spp: int = 8, n_bounces: int = 2,
               tonemap: bool = True, chunk: int | None = None):
        """Render B scenes: scale / trans2d {'left', 'right'} of (B,) /
        (B, 2); verts_* (B, 778, 3) in metres; albedo (B, 2V, 3). The
        uniforms come from `draws` or, without it, from `gen`
        (`draw_paths`).

        light_dir (B, 3) points from the light towards the scene (the
        rasteriser's convention); the disk light sits up-stream of the
        scene's centre along -light_dir. Returns (rgb (B, H, W, 3), in
        [0, 1] after Reinhard and gamma 2.2 if tonemap; mask (B, H, W)
        float)."""
        size, bs = self.img_size, verts_left.shape[0]
        if chunk is None:
            # the intersection temporaries are (B, chunk, T, 3): keep them
            # near one scene's 8192-ray budget whatever B is
            chunk = max(256, 8192 // bs)
        if draws is None:
            draws = draw_paths(gen, bs, spp, n_bounces, size * size)
        scene, light = self.scene(scale, trans2d, verts_left, verts_right, albedo, light_dir,
                                  light_radiance)
        rgb, mask = render_scene(scene, draws, img_size=size, light=light,
                                 env_radiance=env_radiance, chunk=chunk)
        if tonemap:
            rgb = rgb / (1.0 + rgb)                          # Reinhard
            rgb = torch.clamp(rgb, 0.0, 1.0) ** (1.0 / 2.2)
        return rgb, mask
