"""Two-hand mesh renderer (counterpart of `renderih_tpu/render/renderer.py`,
the reference's `mano_two_hands_renderer`).

RGB from per-hand orthographic cameras (`render_rgb_orth`), RGB and masks
through per-frame pinhole intrinsics (`render_rgb_perspective`,
`render_mask_perspective`: the reference's `PerspectiveCameras` from
`cameraIn`, `utils/vis_utils.py:72-80`), binary masks (`render_mask`) and
vertex-colour (densepose) maps (`render_densepose`). Shading is per
vertex: Lambert or Blinn-Phong under one directional light, with optional
point-based ambient occlusion and a directional soft shadow between the
hands. Everything is batched over scenes on the rasteriser
(`render/rasterize.py`); `overlay` blends a render over an image.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from renderih_tpu_torch.ops.projection import orthographic_project, pinhole_project
from renderih_tpu_torch.render.rasterize import pick_row_block, rasterize_orthographic

_LEFT_COLOR = np.array([0.4, 0.55, 0.85])
_RIGHT_COLOR = np.array([0.85, 0.55, 0.4])


def _face_cross(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    tri = verts[..., faces, :]  # (..., F, 3, 3)
    return torch.linalg.cross(tri[..., 1, :] - tri[..., 0, :],
                              tri[..., 2, :] - tri[..., 0, :], dim=-1)


def vertex_normals(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted unit vertex normals of verts (..., V, 3)."""
    fn = _face_cross(verts, faces)
    vn = torch.zeros_like(verts)
    for i in range(3):
        vn.index_add_(verts.dim() - 2, faces[:, i], fn)
    return vn / (torch.linalg.norm(vn, dim=-1, keepdim=True) + 1e-9)


def _vertex_areas(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Per-vertex area share (1/3 of each adjacent face): (..., V)."""
    fa = 0.5 * torch.linalg.norm(_face_cross(verts, faces), dim=-1)
    va = torch.zeros(verts.shape[:-1], dtype=verts.dtype, device=verts.device)
    for i in range(3):
        va.index_add_(verts.dim() - 2, faces[:, i], fa / 3.0)
    return va


def _occlusion_terms(verts: torch.Tensor, normals: torch.Tensor, areas: torch.Tensor,
                     light_dir: torch.Tensor):
    """Point-based ambient occlusion and directional soft shadow of one
    scene (V vertices): every vertex is an oriented disk of its area share,
    with the disk-to-point form factor
    F_ij = a_j max(n_i.d, 0) max(-n_j.d, 0) / (pi |d|² + a_j)
    (Bunnell, GPU Gems 2 ch. 14); the shadow weights the same disks by a
    cos^8 cone towards the light. Returns (ao (V,), shadow (V,)) in [0, 1],
    1 = unoccluded."""
    d = verts[None, :, :] - verts[:, None, :]          # (V, V, 3) i -> j
    dist2 = torch.sum(d * d, dim=-1)
    dn = d * (1.0 / torch.sqrt(dist2 + 1e-12))[..., None]
    cos_r = torch.clamp_min(torch.einsum("id,ijd->ij", normals, dn), 0.0)
    cos_e = torch.clamp_min(-torch.einsum("jd,ijd->ij", normals, dn), 0.0)
    off_diag = 1.0 - torch.eye(verts.shape[0], dtype=verts.dtype, device=verts.device)
    ff = areas[None, :] * cos_r * cos_e / (math.pi * dist2 + areas[None, :]) * off_diag
    ao = torch.clamp(1.0 - torch.sum(ff, dim=1), 0.0, 1.0)
    toward_light = torch.clamp_min(torch.einsum("ijd,d->ij", dn, light_dir), 0.0)
    sh = areas[None, :] * toward_light ** 8 * cos_e / (math.pi * dist2 + areas[None, :])
    shadow = torch.clamp(1.0 - 2.0 * torch.sum(sh * off_diag, dim=1), 0.0, 1.0)
    return ao, shadow


class TwoHandRenderer:
    """Renders the concatenated left + right MANO meshes; its faces and
    base colours live on `device`."""

    def __init__(self, assets, img_size: int = 256, device: torch.device | str = "cpu"):
        self.img_size = img_size
        faces_l = assets.left.mano.faces.cpu().numpy()
        faces_r = assets.right.mano.faces.cpu().numpy()
        nv = int(max(faces_l.max(), faces_r.max())) + 1
        self.num_verts = nv
        self.faces = torch.from_numpy(
            np.concatenate([faces_l, faces_r + nv]).astype(np.int64)).to(device)
        self.base_colors = torch.from_numpy(np.concatenate([
            np.tile(_LEFT_COLOR, (nv, 1)), np.tile(_RIGHT_COLOR, (nv, 1)),
        ]).astype(np.float32)).to(device)

    def render_rgb_orth(self, scale, trans2d, verts_left, verts_right, albedo=None,
                        light_dir=None, light_color=None, ambient=None,
                        specular: float = 0.0, shininess: float = 16.0,
                        ao: float = 0.0, soft_shadow: float = 0.0):
        """Shaded RGB from per-hand orthographic cameras.

        scale / trans2d: {'left', 'right'} of (B,) / (B, 2); verts_* (B, V, 3).
        albedo (B, 2V, 3) or None (fixed left/right colours); light_dir (B, 3)
        unit vector towards the light, or None for a headlight with Lambert
        clipped to [0.2, 1]; light_color (B, 3), default 1; ambient (B, 3),
        default 0; specular the Blinn-Phong weight; ao and soft_shadow the
        strengths of `_occlusion_terms`. Returns (rgb (B, H, W, 3), mask
        (B, H, W)).
        """
        v2d = torch.cat([
            orthographic_project(scale["left"], trans2d["left"], verts_left, self.img_size),
            orthographic_project(scale["right"], trans2d["right"], verts_right, self.img_size),
        ], dim=1)
        verts = torch.cat([verts_left, verts_right], dim=1)
        return self._render_shaded(v2d, verts[..., 2], verts, albedo, light_dir,
                                   light_color, ambient, specular, shininess, ao,
                                   soft_shadow)

    def render_rgb_perspective(self, camera_in, verts_left, verts_right, albedo=None,
                               light_dir=None, light_color=None, ambient=None,
                               specular: float = 0.0, shininess: float = 16.0,
                               ao: float = 0.0, soft_shadow: float = 0.0):
        """Shaded RGB through per-frame pinhole intrinsics: camera_in
        (B, 3, 3); verts_* (B, V, 3) in camera space (+z towards the scene,
        e.g. `world @ cam_R.T + cam_t`, `utils/compute_maskiou.py:190-198`).
        The shading options are `render_rgb_orth`'s. Returns (rgb
        (B, H, W, 3), mask (B, H, W))."""
        verts = torch.cat([verts_left, verts_right], dim=1)
        v2d, depth = pinhole_project(verts, camera_in)
        return self._render_shaded(v2d, depth, verts, albedo, light_dir, light_color,
                                   ambient, specular, shininess, ao, soft_shadow)

    def render_mask_perspective(self, camera_in, verts_left, verts_right):
        """Two-hand silhouette (B, H, W) through pinhole intrinsics."""
        _, mask = self.render_rgb_perspective(camera_in, verts_left, verts_right)
        return mask

    def _render_shaded(self, v2d, z, verts, albedo, light_dir, light_color, ambient,
                       specular, shininess, ao, soft_shadow):
        bs, dtype, device = verts.shape[0], verts.dtype, verts.device
        if albedo is None:
            albedo = self.base_colors.expand(bs, -1, -1)
        default_light = light_dir is None
        if default_light:
            light_dir = torch.tensor([0.0, 0.0, -1.0], dtype=dtype, device=device).expand(bs, 3)
        if light_color is None:
            light_color = torch.ones((bs, 3), dtype=dtype, device=device)
        if ambient is None:
            ambient = torch.zeros((bs, 3), dtype=dtype, device=device)

        normals = vertex_normals(verts, self.faces)                  # (B, 2V, 3)
        lambert = torch.clamp_min(torch.einsum("bvd,bd->bv", normals, light_dir), 0.0)
        if default_light:
            lambert = torch.clamp(lambert, 0.2, 1.0)
        amb = ambient[:, None, :]                                     # (B, 1 or 2V, 3)
        if ao or soft_shadow:
            areas = _vertex_areas(verts, self.faces)
            terms = [_occlusion_terms(verts[i], normals[i], areas[i], light_dir[i])
                     for i in range(bs)]
            ao_v = torch.stack([t[0] for t in terms])
            sh_v = torch.stack([t[1] for t in terms])
            if ao:
                lambert = lambert * (1.0 - ao + ao * ao_v)
                amb = amb * (1.0 - ao + ao * ao_v)[..., None]
            if soft_shadow:
                lambert = lambert * (1.0 - soft_shadow + soft_shadow * sh_v)
        colors = albedo * (amb + light_color[:, None, :] * lambert[..., None])
        if specular:
            # Blinn-Phong, camera along -z, only where the surface is lit
            h = light_dir + torch.tensor([0.0, 0.0, -1.0], dtype=dtype, device=device)
            h = h / (torch.linalg.norm(h, dim=-1, keepdim=True) + 1e-9)
            spec = torch.clamp_min(torch.einsum("bvd,bd->bv", normals, h), 0.0) ** shininess
            spec = torch.where(lambert > 0.0, spec, torch.zeros_like(spec))
            colors = colors + specular * light_color[:, None, :] * spec[..., None]
        colors = torch.clamp(colors, 0.0, 1.0)
        attrs = torch.cat([colors, torch.ones_like(colors[..., :1])], dim=-1)
        n = self.img_size
        attr, mask, _ = rasterize_orthographic(
            v2d, z, attrs, self.faces, height=n, width=n,
            row_block=pick_row_block(bs, n, n, self.faces.shape[0]))
        return attr[..., :3], mask

    def render_mask(self, scale, trans2d, verts_left, verts_right):
        _, mask = self.render_rgb_orth(scale, trans2d, verts_left, verts_right)
        return mask

    def render_densepose(self, scale, trans2d, verts_left, verts_right,
                         dense_colors: torch.Tensor):
        """Vertex-colour (densepose-style) map under the per-hand
        orthographic cameras: dense_colors (2V, 3) interpolated over each
        face. Returns (attr (B, H, W, 3), mask (B, H, W))."""
        v2d = torch.cat([
            orthographic_project(scale["left"], trans2d["left"], verts_left, self.img_size),
            orthographic_project(scale["right"], trans2d["right"], verts_right, self.img_size),
        ], dim=1)
        verts = torch.cat([verts_left, verts_right], dim=1)
        bs, n = verts.shape[0], self.img_size
        attr, mask, _ = rasterize_orthographic(
            v2d, verts[..., 2], dense_colors.expand(bs, -1, -1), self.faces, height=n, width=n,
            row_block=pick_row_block(bs, n, n, self.faces.shape[0]))
        return attr, mask

    @staticmethod
    def overlay(img01: torch.Tensor, rgb: torch.Tensor, mask: torch.Tensor,
                alpha: float = 0.9) -> torch.Tensor:
        """Alpha-blend a render (B, H, W, 3) with its mask (B, H, W) over an
        image in [0, 1] (`core/test_utils.py:81-99`)."""
        m = mask[..., None] * alpha
        return img01 * (1 - m) + rgb * m
