"""InterHand2.6M preprocessing: official release -> packed training data
(counterpart of `tools/dataset_gen/interhand_gen.py`).

One pass of the reference's two-pass generator
(`utils/dataset_gen/interhand.py:88-318`): read the official JSONs
(InterHand2.6M_{split}_data.json / _camera.json / _MANO_NeuralAnnot.json),
keep the frames of `--hand_type` whose MANO fits are present, run MANO for
vertices and joints, transform world -> camera, project, crop to 256² with
`cut_img` (bbox ratio 0.8) and store images + per-hand
verts3d/joints3d/verts2d/joints2d/pose/shape.

MANO runs on `--device` (the card by default; `cpu` for the plain
version), batched over the hands of a chunk of frames, in float64 with its
output rounded to float32 (the JAX tool's dtype): the crop matrix is made
from the projected vertices, so float32 MANO, whose last bits depend on
the device's summation order, would crop the card's and the CPU's images
a rounding apart; this way both devices pack the same bytes. The images
are decoded and cropped on the host by `data/image_io.py` (no cv2).

  python -m renderih_tpu_torch.tools.dataset_gen.interhand_gen --data ROOT \
      --split train --mano-left mano_left.npz --mano-right mano_right.npz --out P/

Requires the converted MANO npz files and the official tree
{root}/images/{split}/... and {root}/annotations/{split}/...
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from renderih_tpu_torch.data.image_io import imread_rgb, warp_affine_u8
from renderih_tpu_torch.data.interhand import IMG_SIZE, LABEL_KEYS, _label_shape
from renderih_tpu_torch.mano.layer import mano_forward
from renderih_tpu_torch.mano.params import ManoModel
from renderih_tpu_torch.ops.rotation import rodrigues

HAND_BBOX_RATIO = 0.8  # reference `dataset/dataset_utils.py:5` via gen (0.8)
MANO_CHUNK = 1024      # frames whose hands go through one MANO forward


def cut_img_matrix(label2d_list, radio=HAND_BBOX_RATIO, img_size=IMG_SIZE):
    """The affine crop matrix of `cut_img` (`dataset/dataset_utils.py:12-42`)."""
    mins = np.min([l.min(axis=0) for l in label2d_list], axis=0)
    maxs = np.max([l.max(axis=0) for l in label2d_list], axis=0)
    mid = (mins + maxs) / 2
    L = np.max(maxs - mins) / 2 / radio
    return img_size / 2 / L * np.array([[1, 0, L - mid[0]], [0, 1, L - mid[1]]], np.float64)


def world_to_cam(world, R, t):
    """InterHand camera: x_cam = R (x_world - t). R: (3,3), t: (3,)."""
    return (world - t[None]) @ R.T


def cam_project(cam_pts, focal, princpt):
    uv = cam_pts[:, :2] / cam_pts[:, 2:3]
    return uv * np.asarray(focal)[None] + np.asarray(princpt)[None]


def validate_mano_entry(entry, cap, frame, hand):
    """Check one NeuralAnnot hand fit; return (pose48, shape10, trans3).

    Official schema: pose = 48 floats (3 global + 45 hand, flat-hand mean
    excluded), shape = 10, trans = 3 (metres). Exports that nest these one
    level deep ((1, 48) lists) are accepted; anything else fails loudly.
    """
    where = f"NeuralAnnot capture {cap} frame {frame} hand '{hand}'"
    if not isinstance(entry, dict):
        raise ValueError(f"{where}: expected a dict, got {type(entry).__name__}")
    out = []
    for key, want in (("pose", 48), ("shape", 10), ("trans", 3)):
        if key not in entry:
            raise ValueError(f"{where}: missing '{key}'")
        try:
            arr = np.asarray(entry[key], np.float64).reshape(-1)
        except (TypeError, ValueError) as e:
            raise ValueError(f"{where}: non-numeric '{key}': {e}") from None
        if arr.size != want:
            raise ValueError(f"{where}: '{key}' has {arr.size} values, expected {want}")
        if not np.all(np.isfinite(arr)):
            raise ValueError(f"{where}: non-finite values in '{key}'")
        out.append(arr)
    return tuple(out)


def run_mano(model: ManoModel, pose48, shape10, trans3, device) -> tuple:
    """MANO forward of N hands on `device` (the float64 model of
    `load_manos` already there), in chunks of MANO_CHUNK: pose48 (N, 48)
    axis-angle (root first), shape10 (N, 10), trans3 (N, 3), each taken as
    float32 as the JAX tool takes them -> numpy float32 (verts (N, 778, 3),
    joints (N, 21, 3)) in the MANO root frame plus trans."""
    n = len(pose48)
    verts = np.empty((n, 778, 3), np.float32)
    joints = np.empty((n, 21, 3), np.float32)

    def arg(a, sl):
        return torch.as_tensor(np.asarray(a[sl], np.float32).astype(np.float64), device=device)

    with torch.no_grad():
        for s in range(0, n, MANO_CHUNK):
            sl = slice(s, min(s + MANO_CHUNK, n))
            p = arg(pose48, sl)
            v, j = mano_forward(model, rodrigues(p[:, :3]), p[:, 3:], arg(shape10, sl),
                                trans=arg(trans3, sl), center_idx=None, use_pca=False)
            verts[sl] = v.cpu().numpy()
            joints[sl] = j.cpu().numpy()
    return verts, joints


def load_manos(left_path: str, right_path: str, device) -> dict:
    """Both MANO models in float64 on `device`, the left one with the
    shapedirs fix (made in float32, as the JAX tool makes it)."""
    from renderih_tpu_torch.mano.params import fix_left_shapedirs, load_mano_npz

    right = load_mano_npz(right_path, is_right=True)
    left = fix_left_shapedirs(load_mano_npz(left_path, is_right=False), right)
    return {hand: m._replace(**{k: v.to(device, torch.float64)
                                for k, v in m._asdict().items()
                                if isinstance(v, torch.Tensor) and v.is_floating_point()})
            for hand, m in (("left", left), ("right", right))}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--data", required=True, help="official InterHand2.6M root")
    p.add_argument("--split", default="train")
    p.add_argument("--mano-left", required=True)
    p.add_argument("--mano-right", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--hand_type", default="interacting",
                   choices=["interacting", "right", "left", "all"],
                   help="which frames to pack; 'right'/'left' packs single-hand frames "
                        "with the absent hand zeroed (reference `utils/interhand_single.py`)")
    p.add_argument("--device", default="cuda",
                   help="where MANO runs: the card (default) or 'cpu'")
    return p


def main(argv=None) -> int:
    from renderih_tpu_torch.serve import resolve_device

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    mano = load_manos(args.mano_left, args.mano_right, device)

    ann_dir = os.path.join(args.data, "annotations", args.split)
    with open(os.path.join(ann_dir, f"InterHand2.6M_{args.split}_data.json")) as f:
        data = json.load(f)
    with open(os.path.join(ann_dir, f"InterHand2.6M_{args.split}_camera.json")) as f:
        cameras = json.load(f)
    with open(os.path.join(ann_dir, f"InterHand2.6M_{args.split}_MANO_NeuralAnnot.json")) as f:
        mano_params = json.load(f)

    images_by_id = {im["id"]: im for im in data["images"]}
    selected = []
    for ann in data["annotations"]:
        ht = ann.get("hand_type")
        if args.hand_type != "all" and ht != args.hand_type:
            continue
        hands_needed = ("left", "right") if ht == "interacting" else (ht,)
        if ann.get("image_id") not in images_by_id:
            raise ValueError(
                f"annotation id {ann.get('id')} references image_id "
                f"{ann.get('image_id')!r}, which is not in the 'images' "
                f"table of InterHand2.6M_{args.split}_data.json")
        im = images_by_id[ann["image_id"]]
        mp = mano_params.get(str(im["capture"]), {}).get(str(im["frame_idx"]))
        if not mp or any(mp.get(h) is None for h in hands_needed):
            continue
        selected.append((ann, im, hands_needed))
        if args.limit and len(selected) >= args.limit:
            break
    n = len(selected)
    print(f"{n} '{args.hand_type}' frames with MANO")

    os.makedirs(args.out, exist_ok=True)
    labels = {k: np.zeros((n,) + _label_shape(k), np.float32) for k in LABEL_KEYS}
    if n == 0:  # valid empty pack (np.memmap cannot map zero bytes)
        open(os.path.join(args.out, f"{args.split}_images.u8"), "wb").close()
        np.savez(os.path.join(args.out, f"{args.split}_labels.npz"), **labels)
        print(f"packed 0 samples -> {args.out}")
        return 0

    # every frame's camera and MANO entries, checked before any work
    frames = []
    for ann, im, hands in selected:
        cap, frame, cam = str(im["capture"]), str(im["frame_idx"]), str(im["camera"])
        if cap not in cameras or cam not in cameras[cap].get("campos", {}):
            raise ValueError(f"camera {cam!r} of capture {cap!r} missing from "
                             f"InterHand2.6M_{args.split}_camera.json")
        fits = {}
        for hand in hands:
            pose, shape, trans = validate_mano_entry(mano_params[cap][frame][hand],
                                                     cap, frame, hand)
            # NeuralAnnot's hand pose excludes the flat-hand mean; the
            # reference folds it back (`utils/dataset_gen/interhand.py:164-167`
            # with `models/manolayer.py:163-181`), so MANO runs at
            # annot45 + hands_mean and that is the stored pose
            pose = np.concatenate(
                [pose[:3], pose[3:48] + mano[hand].hands_mean.cpu().numpy().astype(np.float64)])
            fits[hand] = (pose, shape, trans)
        frames.append((ann, im, fits))

    images = np.memmap(os.path.join(args.out, f"{args.split}_images.u8"), dtype=np.uint8,
                       mode="w+", shape=(n, IMG_SIZE, IMG_SIZE, 3))
    for s in range(0, n, MANO_CHUNK):
        chunk = frames[s:s + MANO_CHUNK]
        world = {}
        for hand in ("left", "right"):
            rows = [k for k, (_, _, fits) in enumerate(chunk) if hand in fits]
            if rows:
                pose, shape, trans = (np.stack([chunk[k][2][hand][q] for k in rows])
                                      for q in range(3))
                v, j = run_mano(mano[hand], pose, shape, trans, device)
                world[hand] = {k: (v[r], j[r]) for r, k in enumerate(rows)}
        for k, (ann, im, fits) in enumerate(chunk):
            i = s + k
            cap, cam = str(im["capture"]), str(im["camera"])
            campos = np.asarray(cameras[cap]["campos"][cam], np.float64) / 1000.0
            camrot = np.asarray(cameras[cap]["camrot"][cam], np.float64)
            focal = cameras[cap]["focal"][cam]
            princpt = cameras[cap]["princpt"][cam]
            img_path = os.path.join(args.data, "images", args.split, im["file_name"])
            try:
                rgb = imread_rgb(img_path)
            except FileNotFoundError:
                raise FileNotFoundError(
                    f"image for annotation {ann['id']} missing or unreadable: "
                    f"{img_path}") from None

            per_hand, all2d = {}, []
            for hand, (pose, shape, _) in fits.items():
                v_w, j_w = world[hand][k]
                v_c = world_to_cam(v_w, camrot, campos)
                j_c = world_to_cam(j_w, camrot, campos)
                v2d = cam_project(v_c, focal, princpt)
                j2d = cam_project(j_c, focal, princpt)
                per_hand[hand] = (v_c, j_c, v2d, j2d, pose, shape)
                all2d += [v2d, j2d]

            M = cut_img_matrix(all2d)
            images[i] = warp_affine_u8(rgb, M, (IMG_SIZE, IMG_SIZE))
            for hand, (v_c, j_c, v2d, j2d, pose, shape) in per_hand.items():
                hom = lambda x: np.concatenate([x, np.ones_like(x[:, :1])], -1) @ M.T
                labels[f"v3d_{hand}"][i] = v_c
                labels[f"j3d_{hand}"][i] = j_c
                labels[f"v2d_{hand}"][i] = hom(v2d)
                labels[f"j2d_{hand}"][i] = hom(j2d)
                labels[f"pose_{hand}"][i] = pose[:48]
                labels[f"shape_{hand}"][i] = shape[:10]
            if (i + 1) % 1000 == 0:
                print(f"{i + 1}/{n}")

    images.flush()
    np.savez(os.path.join(args.out, f"{args.split}_labels.npz"), **labels)
    print(f"packed {n} samples -> {args.out}")
    return n


if __name__ == "__main__":
    main()
