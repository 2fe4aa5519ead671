"""Layout of the packed InterHand-style dataset (copied from
`renderih_tpu/data/interhand.py`; the loaders wait for the training
slice):

  {out}/{split}_images.u8   uint8 (N, 256, 256, 3), RGB
  {out}/{split}_labels.npz  float32 arrays, one per LABEL_KEYS entry
"""

from __future__ import annotations

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
