"""Packed InterHand-style dataset (counterpart of
`renderih_tpu/data/interhand.py`): the layout, its reader, the converter
from the reference's per-frame layout, and a small synthetic writer.

  {out}/{split}_images.u8   uint8 (N, 256, 256, 3), RGB
  {out}/{split}_labels.npz  float32 arrays, one per LABEL_KEYS entry

`PackedInterHand` reads random batches through the native reader
(`data/native_reader.py`, a GIL-free threaded gather) or, with
`use_native=False`, by slicing a memmap; augmentation happens on the
device (`data/pipeline.py`). `pack_reference_dataset` converts the
reference's preprocessed per-frame layout ({split}/img/{i}.jpg +
{split}/ori_handdict/{i}.npy) with the port's own image reader
(`data/image_io.py`, no cv2).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np
import torch

IMG_SIZE = 256  # reference `dataset/dataset_utils.py:4`

LABEL_KEYS = (
    "v3d_left", "j3d_left", "v2d_left", "j2d_left",
    "v3d_right", "j3d_right", "v2d_right", "j2d_right",
    "pose_left", "shape_left", "pose_right", "shape_right",
)

_SHAPES = {
    "v3d": (778, 3), "j3d": (21, 3), "v2d": (778, 2), "j2d": (21, 2),
    "pose": (48,), "shape": (10,),
}


def _label_shape(key: str) -> tuple:
    return _SHAPES[key.split("_")[0]]


@dataclass
class PackedInterHand:
    images: np.ndarray  # uint8 memmap (N, 256, 256, 3)
    labels: dict        # str -> float32 (N, ...)
    reader: object = None  # native_reader.PackedReader, or None: gather from `images`

    def __len__(self) -> int:
        return self.images.shape[0]

    @property
    def nbytes(self) -> int:
        """Bytes of the split: images and labels."""
        return self.images.nbytes + sum(v.nbytes for v in self.labels.values())

    def batch(self, idx: np.ndarray) -> dict:
        """numpy arrays of samples `idx`: 'img_u8' and every label."""
        if self.reader is not None:
            img = self.reader.gather(np.asarray(idx, np.int64))
        else:
            img = np.asarray(self.images[idx])
        out = {"img_u8": img}
        for k, v in self.labels.items():
            out[k] = np.asarray(v[idx])
        return out

    @classmethod
    def load(cls, root: str, split: str, use_native: bool = True) -> "PackedInterHand":
        """The split `{root}/{split}_*`. With `use_native` (the default, as
        in the JAX package) batches gather through the native reader, which
        is built here if need be; a failed build raises rather than falling
        back to the memmap, which `use_native=False` asks for."""
        labels = dict(np.load(os.path.join(root, f"{split}_labels.npz")))
        n = labels[LABEL_KEYS[0]].shape[0]
        path = os.path.join(root, f"{split}_images.u8")
        images = np.memmap(path, dtype=np.uint8, mode="r", shape=(n, IMG_SIZE, IMG_SIZE, 3))
        reader = None
        if use_native:
            from renderih_tpu_torch.data.native_reader import PackedReader

            reader = PackedReader(path, (IMG_SIZE, IMG_SIZE, 3))
        return cls(images=images, labels=labels, reader=reader)


def load_reference_sample(data_path: str, split: str, idx: int):
    """One sample of the reference's preprocessed layout: the RGB image
    `{split}/img/{idx}.jpg` and the hand dict `{split}/ori_handdict/{idx}.npy`."""
    from renderih_tpu_torch.data.image_io import imread_rgb

    img = imread_rgb(os.path.join(data_path, split, "img", f"{idx}.jpg"))
    hand_dict = np.load(os.path.join(data_path, split, "ori_handdict", f"{idx}.npy"),
                        allow_pickle=True)[()]
    return img, hand_dict


def pack_reference_dataset(data_path: str, split: str, out_dir: str,
                           limit: int | None = None,
                           mano_left: str | None = None,
                           mano_right: str | None = None) -> int:
    """Convert the reference per-file layout into packed arrays; returns the
    number of samples ({split}/anno/*.pkl counts them).

    The reference's `ori_handdict` stores the hand pose as 45 PCA
    coefficients plus a root rotation matrix `R`
    (`utils/dataset_gen/interhand.py:164-175`). The packed `pose_*` is the
    evaluated axis-angle [rodrigues(R), pca45 @ hands_components +
    hands_mean] in float64, so converting pose labels needs the MANO npz
    files (`mano_left`/`mano_right`); without them pose/shape stay zero.
    Images that are not 256² are resized (bilinear, as cv2 does). The
    per-frame intrinsics `camera_in` (N, 3, 3) are written only when every
    frame has a camera.
    """
    from glob import glob

    from renderih_tpu_torch.data.image_io import resize_bilinear_u8, rodrigues_np

    mano = None
    if mano_left and mano_right:
        from renderih_tpu_torch.mano.params import load_mano_npz

        mano = {"left": load_mano_npz(mano_left, is_right=False),
                "right": load_mano_npz(mano_right, is_right=True)}

    os.makedirs(out_dir, exist_ok=True)
    n = len(glob(os.path.join(data_path, split, "anno", "*.pkl")))
    if limit:
        n = min(n, limit)
    images = np.memmap(os.path.join(out_dir, f"{split}_images.u8"), dtype=np.uint8,
                       mode="w+", shape=(n, IMG_SIZE, IMG_SIZE, 3))
    labels = {k: np.zeros((n,) + _label_shape(k), np.float32) for k in LABEL_KEYS}
    # post-crop pinhole intrinsics ('camera' in ori_handdict,
    # `utils/dataset_gen/interhand.py:288`); v3d_* of real data are
    # camera-space vertices
    camera_in = np.zeros((n, 3, 3), np.float32)
    have_camera = True

    for i in range(n):
        img, hd = load_reference_sample(data_path, split, i)
        if img.shape[:2] != (IMG_SIZE, IMG_SIZE):
            img = resize_bilinear_u8(img, (IMG_SIZE, IMG_SIZE))
        images[i] = img
        if "camera" in hd.get("left", {}):
            camera_in[i] = np.asarray(hd["left"]["camera"], np.float32)
        else:
            have_camera = False
        for hand in ("left", "right"):
            labels[f"v3d_{hand}"][i] = hd[hand]["verts3d"]
            labels[f"j3d_{hand}"][i] = hd[hand]["joints3d"]
            labels[f"v2d_{hand}"][i] = hd[hand]["verts2d"]
            labels[f"j2d_{hand}"][i] = hd[hand]["joints2d"]
            if mano is not None and "pose" in hd[hand]:
                root_aa = rodrigues_np(np.asarray(hd[hand]["R"], np.float64).reshape(3, 3))
                pca = np.asarray(hd[hand]["pose"], np.float64).reshape(45)
                m = mano[hand]
                axis = (pca @ m.hands_components.numpy().astype(np.float64)
                        + m.hands_mean.numpy().astype(np.float64))
                labels[f"pose_{hand}"][i] = np.concatenate([root_aa, axis])
                labels[f"shape_{hand}"][i] = np.asarray(hd[hand]["shape"],
                                                        np.float32).reshape(10)
    images.flush()
    if have_camera and n > 0:
        labels["camera_in"] = camera_in
    np.savez(os.path.join(out_dir, f"{split}_labels.npz"), **labels)
    return n


def _render_images(assets, batch: dict, seed: int, device: torch.device) -> np.ndarray:
    """Renders of the labelled hands over procedural backgrounds, uint8,
    8 samples a chunk: per-vertex template-coordinate albedo (stable
    correspondence colours, the dense-colour stand-in) under each sample's
    generating camera."""
    from renderih_tpu_torch.assets import _dense_color_from_template
    from renderih_tpu_torch.render.backgrounds import random_background
    from renderih_tpu_torch.render.renderer import TwoHandRenderer

    renderer = TwoHandRenderer(assets, img_size=IMG_SIZE, device=device)
    albedo_one = torch.from_numpy(np.concatenate([
        _dense_color_from_template(assets.left.mano),
        _dense_color_from_template(assets.right.mano)]).astype(np.float32)).to(device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    n = batch["v3d_left"].shape[0]
    out = np.empty((n, IMG_SIZE, IMG_SIZE, 3), np.uint8)
    for s in range(0, n, 8):
        sl = slice(s, min(s + 8, n))
        take = {k: v[sl].to(device) for k, v in batch.items() if k.startswith(("cam_", "v3d_"))}
        m = take["v3d_left"].shape[0]
        with torch.no_grad():
            rgb, mask = renderer.render_rgb_orth(
                {"left": take["cam_scale_left"], "right": take["cam_scale_right"]},
                {"left": take["cam_trans_left"], "right": take["cam_trans_right"]},
                take["v3d_left"], take["v3d_right"],
                albedo=albedo_one.expand(m, -1, -1))
            bg = random_background(gen, m, IMG_SIZE)
            img01 = torch.where(mask[..., None] > 0, rgb, bg)
            out[sl] = torch.clamp(img01 * 255.0 + 0.5, 0, 255).to(torch.uint8).cpu().numpy()
    return out


def make_synthetic_packed(root: str, split: str, assets, n: int = 64, seed: int = 0,
                          render_images: bool = False, reuse: bool = True,
                          scene: bool | None = None,
                          device: torch.device | str = "cpu") -> PackedInterHand:
    """Write a small synthetic packed dataset (tests / smoke runs).

    Labels from `synthetic_batch` on a generator seeded with `seed`. With
    `render_images` the images are renders of the labelled hands over
    procedural backgrounds, made on `device` (a learnable image->pose
    task); otherwise uint8 noise from `np.random.default_rng(seed)`.
    `scene` (default: follow `render_images`) picks the shared-camera
    interacting-hands layout. `reuse` keeps a dataset already written with
    the same (n, seed, render_images, scene)."""
    from renderih_tpu_torch.data.synthetic import synthetic_batch

    os.makedirs(root, exist_ok=True)
    if scene is None:
        scene = render_images
    meta_path = os.path.join(root, f"{split}_meta.json")
    meta = {"n": n, "seed": seed, "render_images": bool(render_images),
            "scene": bool(scene), "albedo": "dense_v1"}
    if reuse and os.path.exists(meta_path):
        with open(meta_path) as f:
            try:
                same = json.load(f) == meta
            except json.JSONDecodeError:
                same = False  # malformed meta: regenerate
        if same:
            return PackedInterHand.load(root, split)
    with torch.no_grad():
        batch = synthetic_batch(assets, torch.Generator().manual_seed(seed), batch_size=n,
                                img_size=IMG_SIZE, with_cam=render_images, with_img=False,
                                scene=scene)
    images = np.memmap(os.path.join(root, f"{split}_images.u8"), dtype=np.uint8,
                       mode="w+", shape=(n, IMG_SIZE, IMG_SIZE, 3))
    if render_images:
        images[:] = _render_images(assets, batch, seed, torch.device(device))
    else:
        images[:] = np.random.default_rng(seed).integers(0, 255, images.shape,
                                                         dtype=np.uint8)
    images.flush()
    labels = {k: np.zeros((n,) + _label_shape(k), np.float32) for k in LABEL_KEYS}
    for k in ("v3d_left", "j3d_left", "v2d_left", "j2d_left",
              "v3d_right", "j3d_right", "v2d_right", "j2d_right"):
        labels[k] = batch[k].numpy().astype(np.float32)
    np.savez(os.path.join(root, f"{split}_labels.npz"), **labels)
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    return PackedInterHand.load(root, split)
