"""Ego3DHands / H2O3D raw-dataset converters -> the packed layout
(counterpart of `tools/dataset_gen/other_datasets_gen.py`).

* Ego3DHands (`utils/dataset_gen/ego3dhand_dataloader.py:220-320`):
  per-sequence dirs holding `color_new.png` + normalized `location_2d.npy`
  + canonical `location_3d_canonical.npy` (22 rows, row 0 dropped).
  Joints-only labels: verts/pose stay zero and `joints_only` is recorded
  in `{split}_meta.json`. Host code only.

* H2O3D (`utils/dataset_gen/h2o3d_dataloader.py:99-296`): the official
  `{root}/{mode}.txt` file list, `{mode}/{seq}/rgb/{f}.jpg` +
  `{mode}/{seq}/meta/{f}.pkl` with `camMat`, `{right,left}HandJoints3D`,
  `{right,left}HandPose/Trans`, `handBeta`. OpenGL -> OpenCV swap (negate
  y and z, `h2o3d_utils/preprocessing.py:435-437`), pinhole projection,
  and, when MANO npz files are given, MANO vertices computed on `--device`
  (the card by default), batched over the kept frames.

Both write {split}_images.u8 + {split}_labels.npz + {split}_meta.json.

  python -m renderih_tpu_torch.tools.dataset_gen.other_datasets_gen ego3d --data DIR --out P/
  python -m renderih_tpu_torch.tools.dataset_gen.other_datasets_gen h2o3d --data DIR \
      --mode train --out P/ [--mano-left L.npz --mano-right R.npz [--device cpu]]
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
from glob import glob

import numpy as np

from renderih_tpu_torch.data.image_io import imread_rgb, warp_affine_u8
from renderih_tpu_torch.data.interhand import IMG_SIZE, LABEL_KEYS, _label_shape
from renderih_tpu_torch.mano.params import NEW_JOINT_ORDER
from renderih_tpu_torch.tools.dataset_gen.interhand_gen import (
    cam_project,
    cut_img_matrix,
    load_manos,
    run_mano,
)

# OpenGL -> OpenCV camera frame (negate y and z), reference
# `h2o3d_utils/preprocessing.py:435-437`.
_SWAP = np.diag([1.0, -1.0, -1.0])


def _alloc(out_dir: str, split: str, n: int):
    os.makedirs(out_dir, exist_ok=True)
    images = np.memmap(os.path.join(out_dir, f"{split}_images.u8"), dtype=np.uint8,
                       mode="w+", shape=(n, IMG_SIZE, IMG_SIZE, 3))
    labels = {k: np.zeros((n,) + _label_shape(k), np.float32) for k in LABEL_KEYS}
    return images, labels


def _finish(out_dir: str, split: str, images, labels, n: int, meta: dict):
    images.flush()
    np.savez(os.path.join(out_dir, f"{split}_labels.npz"),
             **{k: v[:n] for k, v in labels.items()})
    meta["count"] = n
    with open(os.path.join(out_dir, f"{split}_meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    print(f"packed {n} frames -> {out_dir}")


def _read_or_none(path: str):
    """The RGB image, or None where cv.imread would return None."""
    try:
        return imread_rgb(path)
    except FileNotFoundError:
        return None


def convert_ego3d(args) -> int:
    seq_dirs = sorted(d for d in glob(os.path.join(args.data, "*"))
                      if os.path.isfile(os.path.join(d, "color_new.png")))
    if args.limit:
        seq_dirs = seq_dirs[:args.limit]
    images, labels = _alloc(args.out, args.split, len(seq_dirs))

    n = 0
    for d in seq_dirs:
        j2d = np.load(os.path.join(d, "location_2d.npy"))[:, 1:]
        j3d = np.load(os.path.join(d, "location_3d_canonical.npy"))[:, 1:]
        rgb = _read_or_none(os.path.join(d, "color_new.png"))
        if rgb is None or np.sum(j2d[0]) == 0 or np.sum(j2d[1]) == 0:
            continue
        h, w = rgb.shape[:2]
        # normalized (row, col) -> pixel (x, y) (`ego3dhand_dataloader.py:251-255`)
        j2d = j2d.astype(np.float64)
        j2d[..., 0] *= h
        j2d[..., 1] *= w
        j2d = j2d[..., ::-1]
        # canonical 3D: x10 scale, axis flips + xy swap (`:256-262`)
        j3d = j3d.astype(np.float64) * 10.0
        j3d[..., 2] *= -1.0
        j3d[..., 0] *= -1.0
        j3d = j3d[..., [1, 0, 2]]

        M = cut_img_matrix(list(j2d.reshape(-1, 21, 2)), radio=0.8)
        images[n] = warp_affine_u8(rgb, M, (IMG_SIZE, IMG_SIZE))
        hom = lambda x: np.concatenate([x, np.ones_like(x[:, :1])], -1) @ M.T
        # Ego3DHands order: hand 0 = left, hand 1 = right (`:310-320`)
        for hi, hand in ((0, "left"), (1, "right")):
            labels[f"j3d_{hand}"][n] = j3d[hi]
            labels[f"j2d_{hand}"][n] = hom(j2d[hi])
        n += 1

    _finish(args.out, args.split, images, labels, n,
            {"source": "ego3dhands", "joints_only": True})
    return n


def convert_h2o3d(args) -> int:
    mode = "evaluation" if args.mode == "test" else args.mode
    with open(os.path.join(args.data, mode + ".txt")) as f:
        files = [ln.strip() for ln in f if ln.strip()]
    if args.limit:
        files = files[:args.limit]

    mano = device = None
    if args.mano_left and args.mano_right:
        from renderih_tpu_torch.serve import resolve_device

        device = resolve_device(getattr(args, "device", None))
        mano = load_manos(args.mano_left, args.mano_right, device)

    images, labels = _alloc(args.out, args.split, len(files))
    order = list(NEW_JOINT_ORDER)  # raw H2O3D = MANO16+tips ordering

    # the frames whose files exist, whose meta unpickles and whose joints
    # are whole (the image is read below; an unreadable one is skipped)
    kept = []
    for fname in files:
        seq, frame = fname.split("/")[:2]
        img_path = os.path.join(args.data, mode, seq, "rgb", frame + ".jpg")
        meta_path = os.path.join(args.data, mode, seq, "meta", frame + ".pkl")
        if not (os.path.isfile(img_path) and os.path.isfile(meta_path)):
            continue
        try:
            with open(meta_path, "rb") as f:
                anno = pickle.load(f, encoding="latin1")
        except Exception as e:  # corrupt pkl: the reference skips too (:148-151)
            print(f"skip {meta_path}: {e}")
            continue
        joints = {hand: np.asarray(anno[f"{hand}HandJoints3D"], np.float64)
                  for hand in ("left", "right")}
        if any(j.shape != (21, 3) or not np.all(np.isfinite(j)) for j in joints.values()):
            continue
        kept.append((img_path, anno, joints))

    verts = {}
    if mano is not None and kept:
        for hand in ("left", "right"):
            pose = np.stack([np.asarray(a[f"{hand}HandPose"], np.float64).ravel()
                             for _, a, _ in kept]).reshape(len(kept), 48)
            trans = np.stack([np.asarray(a[f"{hand}HandTrans"], np.float64).ravel()
                              for _, a, _ in kept]).reshape(len(kept), 3)
            shape = np.stack([np.asarray(a["handBeta"], np.float64).ravel()
                              for _, a, _ in kept]).reshape(len(kept), 10)
            verts[hand] = (run_mano(mano[hand], pose, shape, trans, device)[0], pose, shape)

    n = 0
    for k, (img_path, anno, joints) in enumerate(kept):
        rgb = _read_or_none(img_path)
        if rgb is None:
            continue
        cam = np.asarray(anno["camMat"], np.float64)
        focal = (cam[0, 0], cam[1, 1])
        princpt = (cam[0, 2], cam[1, 2])
        per_hand, all2d = {}, []
        for hand in ("left", "right"):
            j_cam = joints[hand][order] @ _SWAP.T
            j2d = cam_project(j_cam, focal, princpt)
            if mano is not None:
                v_gl, pose_all, shape_all = verts[hand]
                v_cam = v_gl[k] @ _SWAP.T
                v2d = cam_project(v_cam, focal, princpt)
                pose, shape = pose_all[k], shape_all[k]
            else:
                v_cam, v2d = np.zeros((778, 3)), np.zeros((778, 2))
                pose, shape = np.zeros(48), np.zeros(10)
            per_hand[hand] = (v_cam, j_cam, v2d, j2d, pose, shape)
            all2d.append(j2d)

        M = cut_img_matrix(all2d, radio=0.7)  # the reference uses 0.7 (:66)
        images[n] = warp_affine_u8(rgb, M, (IMG_SIZE, IMG_SIZE))
        hom = lambda x: np.concatenate([x, np.ones_like(x[:, :1])], -1) @ M.T
        for hand in ("left", "right"):
            v_cam, j_cam, v2d, j2d, pose, shape = per_hand[hand]
            labels[f"v3d_{hand}"][n] = v_cam
            labels[f"j3d_{hand}"][n] = j_cam
            labels[f"v2d_{hand}"][n] = hom(v2d) if mano is not None else v2d
            labels[f"j2d_{hand}"][n] = hom(j2d)
            labels[f"pose_{hand}"][n] = pose[:48]
            labels[f"shape_{hand}"][n] = shape[:10]
        n += 1

    _finish(args.out, args.split, images, labels, n,
            {"source": "h2o3d", "joints_only": mano is None})
    return n


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)

    e = sub.add_parser("ego3d")
    e.add_argument("--data", required=True)
    e.add_argument("--split", default="train")
    e.add_argument("--out", required=True)
    e.add_argument("--limit", type=int, default=None)
    e.set_defaults(fn=convert_ego3d)

    h = sub.add_parser("h2o3d")
    h.add_argument("--data", required=True)
    h.add_argument("--mode", default="train", choices=["train", "test", "val"])
    h.add_argument("--split", default="train", help="output split name for the packed files")
    h.add_argument("--out", required=True)
    h.add_argument("--mano-left", default=None)
    h.add_argument("--mano-right", default=None)
    h.add_argument("--limit", type=int, default=None)
    h.add_argument("--device", default="cuda",
                   help="where MANO runs (with --mano-*): the card (default) or 'cpu'")
    h.set_defaults(fn=convert_h2o3d)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
