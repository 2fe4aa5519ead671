"""Pack the Tzionas hand-hand dataset into the packed layout (counterpart
of `tools/dataset_gen/tzionas_gen.py`).

Input: the reference's processed Tzionas layout, per-frame
`{data}/all/{i}.npy` dicts holding `img` (BGR) + per-hand
verts3d/joints3d[/verts2d/joints2d] (`Tzionas_dataset`,
`apps/eval_tzionas.py:28-54`). Host code only.

  python -m renderih_tpu_torch.tools.dataset_gen.tzionas_gen --data DIR --out P/
"""

from __future__ import annotations

import argparse
import os
from glob import glob

import numpy as np

from renderih_tpu_torch.data.image_io import resize_bilinear_u8
from renderih_tpu_torch.data.interhand import IMG_SIZE, LABEL_KEYS, _label_shape


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--data", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--split", default="test")
    args = p.parse_args(argv)

    n = len(glob(os.path.join(args.data, "all", "*.npy")))
    print(f"{n} Tzionas frames")
    os.makedirs(args.out, exist_ok=True)
    images = np.memmap(os.path.join(args.out, f"{args.split}_images.u8"), dtype=np.uint8,
                       mode="w+", shape=(n, IMG_SIZE, IMG_SIZE, 3))
    labels = {k: np.zeros((n,) + _label_shape(k), np.float32) for k in LABEL_KEYS}

    for i in range(n):
        d = np.load(os.path.join(args.data, "all", f"{i}.npy"), allow_pickle=True)[()]
        img = d["img"]
        if img.shape[:2] != (IMG_SIZE, IMG_SIZE):
            img = resize_bilinear_u8(img, (IMG_SIZE, IMG_SIZE))
        images[i] = img[..., ::-1] if img.shape[-1] == 3 else img  # BGR -> RGB
        for hand in ("left", "right"):
            hd = d[hand]
            labels[f"v3d_{hand}"][i] = hd["verts3d"]
            labels[f"j3d_{hand}"][i] = hd["joints3d"]
            if "verts2d" in hd:
                labels[f"v2d_{hand}"][i] = hd["verts2d"]
                labels[f"j2d_{hand}"][i] = hd["joints2d"]
    images.flush()
    np.savez(os.path.join(args.out, f"{args.split}_labels.npz"), **labels)
    print(f"packed -> {args.out}")
    return n


if __name__ == "__main__":
    main()
