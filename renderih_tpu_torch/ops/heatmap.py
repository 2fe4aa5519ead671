"""Joint heatmaps: Gaussian synthesis and DARK sub-pixel decoding
(counterpart of `renderih_tpu/ops/heatmap.py`; reference `HeatmapGenerator`,
`dataset/heatmap.py:11-39`, and `get_max_preds`/`taylor`/`get_final_preds2`,
`dataset/inference.py:20-127`). Batched, plain torch.
"""

from __future__ import annotations

import torch

HEATMAP_SIZE = 64   # reference `dataset/dataset_utils.py:6`
HEATMAP_SIGMA = 2.0


def gaussian_heatmaps(joints2d: torch.Tensor, size: int = HEATMAP_SIZE,
                      sigma: float = HEATMAP_SIGMA) -> torch.Tensor:
    """(B, J, 2) joints in heatmap pixels -> (B, J, size, size) Gaussians
    of peak 1; a joint outside the frame gives an all-zero map."""
    xs = torch.arange(size, dtype=torch.float32, device=joints2d.device)
    gx, gy = joints2d[..., 0, None], joints2d[..., 1, None]  # (B, J, 1)
    ex = torch.exp(-((xs - gx) ** 2) / (2 * sigma**2))      # (B, J, size)
    ey = torch.exp(-((xs - gy) ** 2) / (2 * sigma**2))
    hm = ey[..., :, None] * ex[..., None, :]                 # (B, J, H, W)
    x, y = joints2d[..., 0], joints2d[..., 1]
    valid = (x >= 0) & (x < size) & (y >= 0) & (y < size)
    return hm * valid[..., None, None]


def joint_heatmap_targets(j2d_left: torch.Tensor, j2d_right: torch.Tensor, size: int,
                          img_size: int) -> torch.Tensor:
    """The aux heatmap head's target (`renderih_tpu/train/trainer.py:129-138`,
    `renderih_tpu/data/synthetic.py:159-163`): (B, 21, 2) image-pixel joints of each hand
    -> (B, size, size, 42) NHWC, the left hand's 21 Gaussians then the
    right's, joints scaled by size / img_size, sigma max(size / 32, 1)."""
    j_all = torch.cat([j2d_left, j2d_right], dim=1)
    hms = gaussian_heatmaps(j_all * (size / float(img_size)), size=size,
                            sigma=max(size / 32.0, 1.0))
    return hms.permute(0, 2, 3, 1)


def heatmap_argmax(heatmaps: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, J, H, W) -> integer peaks (B, J, 2) as xy, and the peak values (B, J)."""
    b, j, h, w = heatmaps.shape
    flat = heatmaps.reshape(b, j, h * w)
    idx = flat.argmax(dim=-1)  # the first maximum, as jnp.argmax
    vals = flat.gather(-1, idx[..., None])[..., 0]
    xy = torch.stack([idx % w, idx // w], dim=-1).to(torch.float32)
    return xy, vals


def decode_heatmaps_dark(heatmaps: torch.Tensor) -> torch.Tensor:
    """Sub-pixel peaks (B, J, 2) by the DARK Taylor expansion of the log
    heatmap around the integer peak (`taylor`, `dataset/inference.py:34-59`);
    the integer peak near the border and where the Hessian is singular."""
    b, j, h, w = heatmaps.shape
    xy, _ = heatmap_argmax(heatmaps)
    lh = torch.log(torch.clamp(heatmaps, min=1e-10))
    px, py = xy[..., 0].long(), xy[..., 1].long()
    inb = (px > 1) & (px < w - 2) & (py > 1) & (py < h - 2)
    pxc, pyc = px.clamp(2, w - 3), py.clamp(2, h - 3)
    bi = torch.arange(b, device=heatmaps.device)[:, None]
    ji = torch.arange(j, device=heatmaps.device)[None, :]

    def at(dy: int, dx: int) -> torch.Tensor:
        return lh[bi, ji, pyc + dy, pxc + dx]

    dx = 0.5 * (at(0, 1) - at(0, -1))
    dy = 0.5 * (at(1, 0) - at(-1, 0))
    dxx = 0.25 * (at(0, 2) - 2 * at(0, 0) + at(0, -2))
    dxy = 0.25 * (at(1, 1) - at(-1, 1) - at(1, -1) + at(-1, -1))
    dyy = 0.25 * (at(2, 0) - 2 * at(0, 0) + at(-2, 0))
    det = dxx * dyy - dxy * dxy
    ok = inb & (det.abs() > 1e-12)
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)),
                          torch.zeros_like(det))
    # offset = -H^-1 grad
    off = torch.stack([-(dyy * dx - dxy * dy) * inv_det,
                       -(-dxy * dx + dxx * dy) * inv_det], dim=-1).clamp(-1.0, 1.0)
    return xy + torch.where(ok[..., None], off, torch.zeros_like(off))
