"""Pack any per-frame hand_dict dataset into the packed layout
(counterpart of `tools/dataset_gen/handdict_gen.py`).

Covers the reference datasets that store one npy dict per frame with
`left`/`right` sub-dicts (verts3d/joints3d/verts2d/joints2d[/pose/shape])
next to a jpg: InterHand-style processed data
(`dataset/interhand.py:249-268`), the Ego3DHands and H2O3D refinements
and the RenderIH synthetic set. Layouts (auto-detected):
  A: {data}/{split}/img/{i}.jpg + {data}/{split}/ori_handdict/{i}.npy
  B: {data}/all/{i}.npy with dict['img'] embedded (BGR, Tzionas-style)

  python -m renderih_tpu_torch.tools.dataset_gen.handdict_gen --data DIR \
      --split test --out P/ [--from_joints [--ik_iters 200 --ik_batch 256] [--device cpu]]

`--from_joints`: frames with joints3d but no verts3d get MANO parameters
fitted by the batched IK + Adam refinement (`mano/ik.py`) on `--device`
(the card by default), `--ik_batch` hands at a time, and verts3d/pose/
shape filled from the fit. As in the JAX tool, the fit is to the
synthetic MANO of `make_synthetic_assets(seed=0)` (built here by
`make_synthetic_mano`, the same model), not to a real one. Without
`--from_joints` the tool is host code only.
"""

from __future__ import annotations

import argparse
import os
from glob import glob

import numpy as np

from renderih_tpu_torch.data.image_io import imread_rgb, resize_bilinear_u8
from renderih_tpu_torch.data.interhand import IMG_SIZE, LABEL_KEYS, _label_shape


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--data", required=True)
    p.add_argument("--split", default="test")
    p.add_argument("--out", required=True)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--from_joints", action="store_true",
                   help="fit MANO (pose/shape/verts) to frames that only have "
                        "joints3d, via mano/ik.py")
    p.add_argument("--ik_iters", type=int, default=200)
    p.add_argument("--ik_batch", type=int, default=256)
    p.add_argument("--device", default="cuda",
                   help="where --from_joints fits: the card (default) or 'cpu'")
    return p


def fit_joints_only(labels: dict, ik_rows: dict, iters: int, batch: int, device) -> None:
    """Fill v3d/pose/shape of the joints-only rows from an IK fit of j3d."""
    import torch

    from renderih_tpu_torch.mano.ik import fit_mano_to_joints, mano_from_fit
    from renderih_tpu_torch.mano.params import make_synthetic_mano, to_device

    for hand in ("left", "right"):
        rows = np.asarray(ik_rows[hand], np.int64)
        if not len(rows):
            continue
        model = to_device(make_synthetic_mano(seed=0, is_right=hand == "right"), device)
        for s in range(0, len(rows), batch):
            rr = rows[s:s + batch]
            tgt = torch.as_tensor(labels[f"j3d_{hand}"][rr], device=device)
            fit = fit_mano_to_joints(model, tgt, iters=iters)
            v, _ = mano_from_fit(model, fit, tgt)
            labels[f"v3d_{hand}"][rr] = v.cpu().numpy()
            labels[f"pose_{hand}"][rr] = torch.cat([fit.root_aa, fit.pose_aa], -1).cpu().numpy()
            labels[f"shape_{hand}"][rr] = fit.shape.cpu().numpy()
            print(f"IK {hand}: fitted {s + len(rr)}/{len(rows)} (mean joint residual "
                  f"{float(fit.joint_err.mean()) * 1e3:.2f} mm at template scale)")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = None
    if args.from_joints:
        from renderih_tpu_torch.serve import resolve_device

        device = resolve_device(args.device)

    layout_a = os.path.isdir(os.path.join(args.data, args.split, "ori_handdict"))
    if layout_a:
        n = len(glob(os.path.join(args.data, args.split, "ori_handdict", "*.npy")))

        def read(i):
            img = imread_rgb(os.path.join(args.data, args.split, "img", f"{i}.jpg"))
            hd = np.load(os.path.join(args.data, args.split, "ori_handdict", f"{i}.npy"),
                         allow_pickle=True)[()]
            return img, hd
    else:
        n = len(glob(os.path.join(args.data, "all", "*.npy")))

        def read(i):
            d = np.load(os.path.join(args.data, "all", f"{i}.npy"), allow_pickle=True)[()]
            img = d["img"]
            if img.ndim == 3 and img.shape[-1] == 3:
                img = img[..., ::-1]  # assume BGR on disk
            return img, d

    if args.limit:
        n = min(n, args.limit)
    print(f"{n} frames ({'layout A' if layout_a else 'layout B'})")

    os.makedirs(args.out, exist_ok=True)
    images = np.memmap(os.path.join(args.out, f"{args.split}_images.u8"), dtype=np.uint8,
                       mode="w+", shape=(n, IMG_SIZE, IMG_SIZE, 3))
    labels = {k: np.zeros((n,) + _label_shape(k), np.float32) for k in LABEL_KEYS}

    ik_rows = {"left": [], "right": []}  # joints-only frames per hand
    for i in range(n):
        img, hd = read(i)
        if img.shape[:2] != (IMG_SIZE, IMG_SIZE):
            img = resize_bilinear_u8(img, (IMG_SIZE, IMG_SIZE))
        images[i] = img
        for hand in ("left", "right"):
            h = hd[hand]
            labels[f"j3d_{hand}"][i] = h["joints3d"]
            if "verts3d" in h:
                labels[f"v3d_{hand}"][i] = h["verts3d"]
            elif args.from_joints:
                ik_rows[hand].append(i)
            if "verts2d" in h:
                labels[f"v2d_{hand}"][i] = h["verts2d"]
                labels[f"j2d_{hand}"][i] = h["joints2d"]
            if "pose" in h:
                labels[f"pose_{hand}"][i] = np.asarray(h["pose"]).ravel()[:48]
            if "shape" in h:
                labels[f"shape_{hand}"][i] = np.asarray(h["shape"]).ravel()[:10]
        if (i + 1) % 2000 == 0:
            print(f"{i + 1}/{n}")

    if args.from_joints:
        fit_joints_only(labels, ik_rows, args.ik_iters, args.ik_batch, device)
    images.flush()
    np.savez(os.path.join(args.out, f"{args.split}_labels.npz"), **labels)
    print(f"packed {n} -> {args.out}")
    return n


if __name__ == "__main__":
    main()
