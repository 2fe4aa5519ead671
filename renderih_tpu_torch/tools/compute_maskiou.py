"""Per-sample inter-hand mask IoU over a packed split (counterpart of
`tools/compute_maskiou.py`; the reference's `utils/compute_maskiou.py` +
`utils/get_maskiou.py`).

Each hand's ground-truth mesh is rasterised alone at `--res`² and the IoU
of the two masks is taken per sample; the vector buckets eval metrics by
interaction severity (`apps/eval_interhand.py --iou`). Camera: where the
packed labels carry per-frame intrinsics `camera_in` (real data, whose
v3d_* are camera-space), the masks go through that pinhole camera, as the
reference renders them (`utils/compute_maskiou.py:190-198`,
`PerspectiveCameras` from `cameraIn`); otherwise through the packed v2d
and z (the orthographic approximation). The faces are those of
`make_synthetic_assets()`, as the JAX tool takes them.

    python -m renderih_tpu_torch.tools.compute_maskiou --data DIR --split test --out iou.npy
        [--res 64] [--bs 64] [--device cpu]

Runs on the card unless `--device cpu`; without a card the default raises.
`main(argv)` returns the vector it saved.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from renderih_tpu_torch.assets import make_synthetic_assets
from renderih_tpu_torch.data.interhand import IMG_SIZE, PackedInterHand
from renderih_tpu_torch.ops.projection import pinhole_project
from renderih_tpu_torch.render.rasterize import pick_row_block, rasterize_orthographic
from renderih_tpu_torch.serve import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data", required=True, help="packed dataset directory")
    p.add_argument("--split", default="test")
    p.add_argument("--out", required=True, help="the IoU vector (.npy)")
    p.add_argument("--res", type=int, default=64,
                   help="mask resolution (IoU is resolution-insensitive)")
    p.add_argument("--bs", type=int, default=64)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def mask_iou(v2d_l, z_l, v2d_r, z_r, faces_l, faces_r, res: int) -> torch.Tensor:
    """IoU (B,) of the two hands' silhouettes at res², from pixel
    coordinates (B, V, 2) and depths (B, V) of each hand."""
    def mask(v2d, z, faces):
        ones = torch.ones(v2d.shape[:2] + (1,), dtype=v2d.dtype, device=v2d.device)
        return rasterize_orthographic(v2d, z, ones, faces, height=res, width=res,
                                      row_block=pick_row_block(v2d.shape[0], res, res,
                                                               faces.shape[0]))[1]

    ml, mr = mask(v2d_l, z_l, faces_l), mask(v2d_r, z_r, faces_r)
    inter = torch.sum(ml & mr, dim=(1, 2))
    union = torch.sum(ml | mr, dim=(1, 2))
    return inter.float() / torch.clamp_min(union, 1).float()


def main(argv=None) -> np.ndarray:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    assets = make_synthetic_assets()  # faces only, as the JAX tool
    faces_l = assets.left.mano.faces.long().to(device)
    faces_r = assets.right.mano.faces.long().to(device)
    dataset = PackedInterHand.load(args.data, args.split, use_native=False)
    res, sc = args.res, args.res / IMG_SIZE
    perspective = "camera_in" in dataset.labels
    n = len(dataset.labels["v3d_left"])
    ious = np.zeros(n, np.float32)
    print(f"camera: {'pinhole (cameraIn)' if perspective else 'orthographic'}", flush=True)

    def on(key, idx):
        return torch.from_numpy(np.ascontiguousarray(dataset.labels[key][idx])).to(device)

    with torch.no_grad():
        for start in range(0, n, args.bs):
            idx = np.arange(start, min(start + args.bs, n))
            if perspective:
                cam = on("camera_in", idx)
                uv_l, z_l = pinhole_project(on("v3d_left", idx), cam)
                uv_r, z_r = pinhole_project(on("v3d_right", idx), cam)
            else:
                uv_l, z_l = on("v2d_left", idx), on("v3d_left", idx)[..., 2]
                uv_r, z_r = on("v2d_right", idx), on("v3d_right", idx)[..., 2]
            ious[idx] = mask_iou(uv_l * sc, z_l, uv_r * sc, z_r, faces_l, faces_r,
                                 res).cpu().numpy()
            if start % (args.bs * 10) == 0:
                print(f"{start}/{n}", flush=True)
    np.save(args.out, ious)
    print(f"saved {n} IoUs -> {args.out} (mean {ious.mean():.3f}, >0.67: "
          f"{(ious >= 0.67).mean():.2%})", flush=True)
    return ious


if __name__ == "__main__":
    main(sys.argv[1:])
