"""Backgrounds, skin albedo and lighting for synthetic data (counterpart
of `renderih_tpu/render/backgrounds.py`).

Two kinds of background, as the reference's Blender pipeline composites
rendered hands over random background images
(`rendering_code/step4_load_mano_diffbg.py`):
  * `BackgroundCorpus`: a directory of real images, each centre-cropped to
    a square and resized to the render size once on the host (cv2-free:
    `data/image_io.py`), held on the device as an (N, S, S, 3) float32
    stack in [0, 1]; `sample` picks images with a random flip and gain;
  * procedural (`random_background` without a corpus): solid colours,
    gradients, tinted value noise and blends, per sample.

Each random function is split into its draws (from an explicit
`torch.Generator`, on the generator's device) and a deterministic
transform of those draws, so that the transform can be held against the
JAX package on the same numbers.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from renderih_tpu_torch.data.image_io import ImageUnreadableError, imread_rgb, resize_area_u8


def _uniform(gen: torch.Generator, shape, low: float = 0.0, high: float = 1.0):
    u = torch.rand(shape, generator=gen, device=gen.device)
    return u * (high - low) + low


def resize_linear_2d(x: torch.Tensor, size: int) -> torch.Tensor:
    """(B, h, w, C) -> (B, size, size, C), half-pixel bilinear with edge
    clamping (`jax.image.resize(..., "linear")` when upsampling)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


def resize_linear_1d(x: torch.Tensor, size: int) -> torch.Tensor:
    """(B, n, C) -> (B, size, C) along axis 1, as `resize_linear_2d`."""
    y = F.interpolate(x.permute(0, 2, 1), size=size, mode="linear", align_corners=False)
    return y.permute(0, 2, 1)


def value_noise(grids: list, size: int) -> torch.Tensor:
    """Multi-octave value noise in [0, 1] from its coarse grids (octave i
    a (B, r_i, r_i, 3) uniform draw, amplitude 0.5^i): (B, size, size, 3)."""
    img = 0.0
    amp_total = 0.0
    for i, grid in enumerate(grids):
        amp = 0.5 ** i
        img = img + amp * resize_linear_2d(grid, size)
        amp_total += amp
    return img / amp_total


def _value_noise(gen: torch.Generator, bs: int, size: int, octaves: int = 4,
                 base: int = 4) -> torch.Tensor:
    grids = [_uniform(gen, (bs, base * 2 ** i, base * 2 ** i, 3)) for i in range(octaves)]
    return value_noise(grids, size)


def gradient(c0: torch.Tensor, c1: torch.Tensor, theta: torch.Tensor,
             size: int) -> torch.Tensor:
    """Linear two-colour gradient: c0, c1 (B, 1, 1, 3), theta (B,) its
    direction -> (B, size, size, 3)."""
    lin = torch.linspace(0, 1, size, dtype=c0.dtype, device=c0.device)
    yy, xx = torch.meshgrid(lin, lin, indexing="ij")
    t = (xx[None] * torch.cos(theta)[:, None, None]
         + yy[None] * torch.sin(theta)[:, None, None])
    lo = t.amin(dim=(1, 2), keepdim=True)
    hi = t.amax(dim=(1, 2), keepdim=True)
    t = (t - lo) / (hi - lo + 1e-9)
    return c0 + (c1 - c0) * t[..., None]


def _gradient(gen: torch.Generator, bs: int, size: int) -> torch.Tensor:
    c0 = _uniform(gen, (bs, 1, 1, 3))
    c1 = _uniform(gen, (bs, 1, 1, 3))
    theta = _uniform(gen, (bs,), 0.0, 2 * math.pi)
    return gradient(c0, c1, theta, size)


def background(kind: torch.Tensor, solid: torch.Tensor, grad: torch.Tensor,
               noise: torch.Tensor, tint: torch.Tensor) -> torch.Tensor:
    """Per sample one of: solid colour (kind 0), gradient (1), tinted
    value-noise texture (2), or an even blend of gradient and texture (3).
    kind (B,) int; solid, tint (B, 1, 1, 3); grad, noise (B, S, S, 3)."""
    textured = noise * tint
    blend = 0.5 * grad + 0.5 * textured
    stack = torch.stack([solid.expand_as(grad), grad, textured, blend], dim=1)
    return stack[torch.arange(kind.shape[0], device=kind.device), kind]


class BackgroundCorpus:
    """A directory of background images as a stack on `device`.

    The sorted listing of files with one of `EXTS` (case-insensitive), at
    most `limit`, each read as cv.imread reads it, centre-cropped to a
    square and resized to `size` with INTER_AREA, bit for bit as the JAX
    package loads them. A file that is no image at all (cv.imread: None)
    is skipped; a file this reader cannot decode raises.
    """

    EXTS = (".jpg", ".jpeg", ".png", ".bmp")

    def __init__(self, directory: str, size: int = 256, limit: int = 4096,
                 device: torch.device | str = "cpu"):
        paths = sorted(os.path.join(directory, f) for f in os.listdir(directory)
                       if f.lower().endswith(self.EXTS))[:limit]
        if not paths:
            raise ValueError(f"no background images in {directory}")
        imgs = []
        for p in paths:
            try:
                img = imread_rgb(p)
            except ImageUnreadableError:
                continue
            h, w = img.shape[:2]
            s = min(h, w)
            y0, x0 = (h - s) // 2, (w - s) // 2
            imgs.append(resize_area_u8(img[y0:y0 + s, x0:x0 + s], (size, size)))
        if not imgs:
            raise ValueError(f"no readable background images in {directory}")
        self.size = size
        self.images = torch.from_numpy(np.stack(imgs).astype(np.float32) / 255.0).to(device)

    def transform(self, idx: torch.Tensor, flip: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
        """Images `idx` (B,), mirrored left-right where `flip` (B,) bool,
        times `gain` (B, 1, 1, 1), clipped to [0, 1]."""
        imgs = self.images[idx]
        imgs = torch.where(flip[:, None, None, None], imgs.flip(2), imgs)
        return torch.clamp(imgs * gain, 0.0, 1.0)

    def sample(self, gen: torch.Generator, bs: int) -> torch.Tensor:
        """(bs, size, size, 3) in [0, 1]: a uniform pick, a fair flip and a
        gain in [0.7, 1.2) per sample."""
        idx = torch.randint(0, self.images.shape[0], (bs,), generator=gen, device=gen.device)
        flip = torch.rand((bs,), generator=gen, device=gen.device) < 0.5
        gain = _uniform(gen, (bs, 1, 1, 1), 0.7, 1.2)
        return self.transform(idx.to(self.images.device), flip.to(self.images.device),
                              gain.to(self.images.device))


def random_background(gen: torch.Generator, bs: int, size: int,
                      corpus: BackgroundCorpus | None = None) -> torch.Tensor:
    """Batched background in [0, 1], (bs, size, size, 3): augmented corpus
    images with `corpus`, else procedural."""
    if corpus is not None:
        if corpus.size != size:
            raise ValueError(f"corpus of {corpus.size}² images for a {size}² render")
        return corpus.sample(gen, bs)
    kind = torch.randint(0, 4, (bs,), generator=gen, device=gen.device)
    solid = _uniform(gen, (bs, 1, 1, 3))
    grad = _gradient(gen, bs, size)
    noise = _value_noise(gen, bs, size)
    tint = _uniform(gen, (bs, 1, 1, 3), 0.3, 1.0)
    return background(kind, solid, grad, noise, tint)


_DARK_SKIN = (0.35, 0.22, 0.15)
_LIGHT_SKIN = (0.95, 0.78, 0.67)


def skin_albedo(tone: torch.Tensor, jitter: torch.Tensor, variation: torch.Tensor,
                num_verts: int) -> torch.Tensor:
    """Skin-tone albedo (B, 2 * num_verts, 3) shared by both hands of a
    sample: tone (B, 1) uniform on the dark-to-light axis, jitter (B, 3) and
    variation (B, 16, 3) standard normal draws (channel jitter x0.03,
    low-frequency per-vertex variation x0.04, upsampled linearly)."""
    dark = torch.tensor(_DARK_SKIN, dtype=tone.dtype, device=tone.device)
    light = torch.tensor(_LIGHT_SKIN, dtype=tone.dtype, device=tone.device)
    base = dark[None] + (light - dark)[None] * tone
    base = base + jitter * 0.03
    var = resize_linear_1d(variation * 0.04, 2 * num_verts)
    return torch.clamp(base[:, None, :] + var, 0.05, 1.0)


def random_skin_albedo(gen: torch.Generator, bs: int, num_verts: int) -> torch.Tensor:
    tone = _uniform(gen, (bs, 1))
    jitter = torch.randn((bs, 3), generator=gen, device=gen.device)
    variation = torch.randn((bs, 16, 3), generator=gen, device=gen.device)
    return skin_albedo(tone, jitter, variation, num_verts)


def lighting(direction: torch.Tensor, gain: torch.Tensor, tint: torch.Tensor,
             ambient: torch.Tensor):
    """Directional light from its draws: direction (B, 3) standard normal,
    pushed towards the camera hemisphere (z < 0) and normalised; gain
    (B, 1) in [0.5, 1.1) times tint (B, 3) in [0.9, 1) is its colour;
    ambient (B, 1) in [0.15, 0.45). Returns (dir, color, ambient), (B, 3)
    each."""
    d = torch.cat([direction[:, :2], -direction[:, 2:].abs() - 0.5], dim=1)
    d = d / (torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-9)
    color = gain.expand(-1, 3) * tint
    return d, color, ambient.expand(-1, 3)


def random_lighting(gen: torch.Generator, bs: int):
    direction = torch.randn((bs, 3), generator=gen, device=gen.device)
    gain = _uniform(gen, (bs, 1), 0.5, 1.1)
    tint = _uniform(gen, (bs, 3), 0.9, 1.0)
    ambient = _uniform(gen, (bs, 1), 0.15, 0.45)
    return lighting(direction, gain, tint, ambient)
