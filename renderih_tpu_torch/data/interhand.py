"""Packed InterHand-style dataset (counterpart of
`renderih_tpu/data/interhand.py`): the layout, its reader and a small
synthetic writer.

  {out}/{split}_images.u8   uint8 (N, 256, 256, 3), RGB
  {out}/{split}_labels.npz  float32 arrays, one per LABEL_KEYS entry

`PackedInterHand` reads random batches by slicing a memmap; augmentation
happens on the device (`data/pipeline.py`). The reference-layout
converter (`pack_reference_dataset`, cv2) is not ported.
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

    def __len__(self) -> int:
        return self.images.shape[0]

    @property
    def nbytes(self) -> int:
        """Bytes of the split: images and labels."""
        return self.images.nbytes + sum(v.nbytes for v in self.labels.values())

    def batch(self, idx: np.ndarray) -> dict:
        """numpy arrays of samples `idx`: 'img_u8' and every label."""
        out = {"img_u8": np.asarray(self.images[idx])}
        for k, v in self.labels.items():
            out[k] = np.asarray(v[idx])
        return out

    @classmethod
    def load(cls, root: str, split: str) -> "PackedInterHand":
        labels = dict(np.load(os.path.join(root, f"{split}_labels.npz")))
        n = labels[LABEL_KEYS[0]].shape[0]
        images = np.memmap(os.path.join(root, f"{split}_images.u8"), dtype=np.uint8,
                           mode="r", shape=(n, IMG_SIZE, IMG_SIZE, 3))
        return cls(images=images, labels=labels)


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
