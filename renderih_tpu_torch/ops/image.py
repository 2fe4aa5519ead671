"""Device-side image ops: affine augmentation, noise, normalisation
(counterpart of `renderih_tpu/ops/image.py`).

  * `affine_mat` reproduces `imgUtils.get_affine_mat` exactly: rotation
    about the image center (same 3.14159 pi), scale about the center,
    then pixel translation.
  * `warp_affine_bilinear` matches cv.warpAffine(INTER_LINEAR,
    BORDER_CONSTANT=0): output pixel (x, y) samples the input at
    M^-1 (x, y), bilinear, zeros outside. uint8 input takes one gather of
    all four taps (`_warp_u8_stacked`), equal to the float route.
  * `add_noise` matches `imgUtils.add_noise`: per-channel brightness gain,
    scalar offset, additive gaussian, clip to [0, 255]. Its random draws
    come in as tensors (`noise_draws`), so a caller can feed any.
  * ImageNet normalisation matches torchvision (`core/loader.py:49-50`).

Images are channels last, (B, H, W, C).
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

_PI = 3.14159  # reference's pi approximation (`utils/manoutils.py:159`)


def affine_mat(theta_deg, scale, u, v, size: float) -> torch.Tensor:
    """Forward 3x3 affines (B, 3, 3): rotate by theta about the center,
    scale about it, translate. theta, scale, u, v are (B,) float32
    tensors (`imgUtils.get_affine_mat`, `utils/manoutils.py:183-194`)."""
    theta_deg, scale, u, v = torch.broadcast_tensors(theta_deg, scale, u, v)
    t = theta_deg * (_PI / 180.0)
    c, s = torch.cos(t), torch.sin(t)
    half = size / 2.0
    zeros = torch.zeros_like(t)
    ones = torch.ones_like(t)

    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    rot = mat([[c, -s, half - (c * half - s * half)],
               [s, c, half - (s * half + c * half)],
               [zeros, zeros, ones]])
    sc = mat([[scale, zeros, half * (1 - scale)],
              [zeros, scale, half * (1 - scale)],
              [zeros, zeros, ones]])
    tr = mat([[ones, zeros, u], [zeros, ones, v], [zeros, zeros, ones]])
    return tr @ (sc @ rot)


def _source_coords(mat: torch.Tensor, out: int):
    """Input-space sample positions (sx, sy) (B, out, out) of every output
    pixel, and their floors."""
    inv = torch.linalg.inv_ex(mat).inverse  # no error check: no host sync
    ys = torch.arange(out, dtype=torch.float32, device=mat.device)
    gx, gy = torch.meshgrid(ys, ys, indexing="xy")
    coords = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # (out, out, 3)
    src = torch.einsum("bij,hwj->bhwi", inv[:, :2, :], coords)
    sx, sy = src[..., 0], src[..., 1]
    return sx, sy, torch.floor(sx), torch.floor(sy)


def _valid(yy, xx, h: int, w: int) -> torch.Tensor:
    return ((xx >= 0) & (xx < w) & (yy >= 0) & (yy < h))[..., None]


def warp_affine_bilinear(img: torch.Tensor, mat: torch.Tensor,
                         out_size: int | None = None) -> torch.Tensor:
    """Batched cv.warpAffine(INTER_LINEAR, BORDER_CONSTANT=0).

    img (B, H, W, C) float or uint8 (returns float32 either way, equal);
    mat (B, 3, 3) *forward* affines; out_size the output side (default H).
    """
    b, h, w, c = img.shape
    out = out_size or h
    if img.dtype == torch.uint8:
        return _warp_u8_stacked(img, mat, out)
    sx, sy, x0, y0 = _source_coords(mat, out)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    flat = img.reshape(b, h * w, c)

    def gather(yy, xx):
        xi = torch.clamp(xx, 0, w - 1).long()
        yi = torch.clamp(yy, 0, h - 1).long()
        idx = (yi * w + xi).reshape(b, -1, 1).expand(-1, -1, c)
        vals = flat.gather(1, idx).reshape(b, out, out, c)
        return torch.where(_valid(yy, xx, h, w), vals, 0.0)

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def _warp_u8_stacked(img: torch.Tensor, mat: torch.Tensor, out: int) -> torch.Tensor:
    """uint8 warp through ONE gather of all four bilinear taps.

    The image is padded with a zero border and its four shifted neighbour
    views are stacked on the channel axis, so each output pixel gathers
    4·C contiguous bytes with a single index: a quarter of the float
    route's gathers, on uint8. The padded border supplies the zeros the
    float route's validity masks give at the -1/H/W edges, the masks below
    are the float route's verbatim, and uint8 converts to float32 exactly,
    so the result equals `warp_affine_bilinear(img.float(), mat)`.
    """
    b, h, w, c = img.shape
    sx, sy, x0, y0 = _source_coords(mat, out)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    p = torch.nn.functional.pad(img, (0, 0, 1, 2, 1, 2))  # (b, h+3, w+3, c)
    stk = torch.cat([p[:, :h + 1, :w + 1], p[:, :h + 1, 1:w + 2],
                     p[:, 1:h + 2, :w + 1], p[:, 1:h + 2, 1:w + 2]], dim=-1)
    xi = torch.clamp(x0, -1, w - 1).long() + 1  # [0, w]
    yi = torch.clamp(y0, -1, h - 1).long() + 1  # [0, h]
    idx = (yi * (w + 1) + xi).reshape(b, -1, 1).expand(-1, -1, 4 * c)
    flat = stk.reshape(b, (h + 1) * (w + 1), 4 * c)
    g = flat.gather(1, idx).reshape(b, out, out, 4, c).float()
    v00 = torch.where(_valid(y0, x0, h, w), g[..., 0, :], 0.0)
    v01 = torch.where(_valid(y0, x0 + 1, h, w), g[..., 1, :], 0.0)
    v10 = torch.where(_valid(y0 + 1, x0, h, w), g[..., 2, :], 0.0)
    v11 = torch.where(_valid(y0 + 1, x0 + 1, h, w), g[..., 3, :], 0.0)
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def transform_points2d(pts: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """Apply (B, 3, 3) forward affines to (B, N, 2) points."""
    return torch.einsum("bij,bnj->bni", mat[:, :2, :2], pts) + mat[:, None, :2, 2]


_GAIN, _OFFSET, _SCALE = 0.3, 0.05, 255.0  # `imgUtils.add_noise`'s alpha, beta, scale


def noise_draws(gen: torch.Generator | None, shape: tuple, noise: float = 0.0) -> dict:
    """The random draws of `add_noise` for images of `shape` (B, H, W, C),
    on `gen`'s device: gain (B, 1, 1, C) in [0.7, 1.3), offset (B, 1, 1, 1)
    in [-0.05, 0.05) (of the 255 scale), gauss standard normal
    (B, H, W, C), or None when `noise` is 0."""
    b, c = shape[0], shape[-1]
    dev = gen.device if gen is not None else None
    gain = 1 - _GAIN + 2 * _GAIN * torch.rand((b, 1, 1, c), generator=gen, device=dev)
    offset = _OFFSET * (2.0 * torch.rand((b, 1, 1, 1), generator=gen, device=dev) - 1.0)
    gauss = (torch.randn(shape, generator=gen, device=dev) if noise > 0.0 else None)
    return {"gain": gain, "offset": offset, "gauss": gauss}


def add_noise(img: torch.Tensor, draws: dict, noise: float = 0.0) -> torch.Tensor:
    """Brightness + gaussian noise (`imgUtils.add_noise`), img (B, H, W, C)
    in [0, 255]."""
    out = draws["gain"] * img + _SCALE * draws["offset"]
    if draws["gauss"] is not None:
        out = out + _SCALE * noise * draws["gauss"]
    return torch.clamp(out, 0.0, _SCALE)


_IMAGENET: dict = {}  # (dtype, device) -> (mean, std), built at the first call there


def normalize_imagenet(img01: torch.Tensor) -> torch.Tensor:
    """[0,1] RGB, channels last (..., 3) -> ImageNet-normalized. The
    constants are built once for each dtype and device: building them on a
    card is a copy that waits for its stream."""
    key = (img01.dtype, img01.device)
    if key not in _IMAGENET:
        with torch.inference_mode(False):  # usable by autograd, whoever calls first
            _IMAGENET.setdefault(key, tuple(
                torch.tensor(c, dtype=img01.dtype, device=img01.device)
                for c in (IMAGENET_MEAN, IMAGENET_STD)))
    mean, std = _IMAGENET[key]
    return (img01 - mean) / std
