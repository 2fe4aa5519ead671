"""MANO model parameters as torch tensors: loading and synthetic fixtures.

Counterpart of `renderih_tpu/mano/params.py`. The official MANO pickles
are not shipped; users convert them once to an npz (the JAX package's
`convert_mano_pkl` writes the same layout) and everything reads the npz.
`make_synthetic_mano` builds a deterministic random hand with the exact
MANO shapes (778 verts, 16-joint tree, 45-dim PCA pose space) from numpy,
bit-identical to the JAX package's fixture for the same seed.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Kinematic tree: 16 joints (root + 3 per finger x 5).
MANO_PARENTS: tuple = (-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14)

# Fingertip vertices appended after the 16 skeleton joints
# (reference `models/manolayer.py:296`).
TIP_VERTEX_IDS: tuple = (745, 317, 444, 556, 673)

# Reorder (16 joints + 5 tips) into the 21-joint convention
# (reference `models/manolayer.py:110-115`).
NEW_JOINT_ORDER: tuple = (
    0,
    13, 14, 15, 16,
    1, 2, 3, 17,
    4, 5, 6, 18,
    10, 11, 12, 19,
    7, 8, 9, 20,
)

NUM_VERTS = 778
NUM_JOINTS = 21
NUM_SKEL_JOINTS = 16


class ManoModel(NamedTuple):
    """MANO parameters as CPU tensors (float32; `faces` int64)."""

    v_template: torch.Tensor        # (778, 3)
    shapedirs: torch.Tensor         # (778, 3, 10)
    posedirs: torch.Tensor          # (778, 3, 135)
    J_regressor: torch.Tensor       # (16, 778) dense
    weights: torch.Tensor           # (778, 16) LBS weights
    hands_components: torch.Tensor  # (45, 45) PCA basis (rows are components)
    hands_components_inv: torch.Tensor  # (45, 45)
    hands_mean: torch.Tensor        # (45,)
    faces: torch.Tensor             # (F, 3)
    is_right: bool


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def fix_left_shapedirs(left: ManoModel, right: ManoModel) -> ManoModel:
    """The MANO left-hand shapedirs sign fix: the released MANO_LEFT.pkl
    shares shapedirs[:, 0, :] with the right hand, so the x-component is
    negated when the two agree (`dataset/interhand.py:22-25`). Returns a
    corrected copy."""
    diff = (left.shapedirs[:, 0, :] - right.shapedirs[:, 0, :]).abs().sum()
    if diff >= 1:
        return left
    fixed = left.shapedirs.clone()
    fixed[:, 0, :] *= -1.0
    return left._replace(shapedirs=fixed)


def load_mano_npz(npz_path: str, is_right: bool | None = None) -> ManoModel:
    """Load a converted MANO npz into a `ManoModel`."""
    data = np.load(npz_path)
    parents = tuple(int(p) for p in data["kintree_parents"])
    if parents != MANO_PARENTS:
        raise ValueError(f"unexpected MANO kinematic tree: {parents}")
    hc = np.asarray(data["hands_components"], np.float32)
    right = bool(data["is_right"]) if is_right is None else is_right
    return ManoModel(
        v_template=_f32(data["v_template"]),
        shapedirs=_f32(data["shapedirs"]),
        posedirs=_f32(data["posedirs"]),
        J_regressor=_f32(data["J_regressor"]),
        weights=_f32(data["weights"]),
        hands_components=_f32(hc),
        hands_components_inv=_f32(np.linalg.inv(hc)),
        hands_mean=_f32(data["hands_mean"]),
        faces=torch.from_numpy(np.asarray(data["faces"], np.int64)),
        is_right=right,
    )


def _fibonacci_sphere(n: int) -> np.ndarray:
    """Deterministic, well-spread points on the unit sphere."""
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    golden = np.pi * (1.0 + 5.0**0.5)
    theta = golden * i
    return np.stack(
        [np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi), np.cos(phi)],
        axis=-1,
    )


def make_synthetic_mano(seed: int = 0, is_right: bool = True) -> ManoModel:
    """Deterministic random hand model with exact MANO shapes.

    A convex-hull triangulation of 778 sphere points (watertight, 1552
    faces); the left hand is the mirror of the right, so both coarsen to
    identical graph level sizes. Blend shapes, skinning weights and the
    PCA basis are random but structurally valid.
    """
    rng = np.random.default_rng(seed + (1000 if is_right else 0))
    scale = 0.1  # ~10 cm hand
    pts = _fibonacci_sphere(NUM_VERTS) * scale
    from scipy.spatial import ConvexHull

    hull = ConvexHull(pts)
    faces = np.asarray(hull.simplices, np.int32)
    # Orient faces outward (hull simplices have arbitrary winding).
    tri = pts[faces]
    normals = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    centers = tri.mean(axis=1)
    flip = (normals * centers).sum(-1) < 0
    faces[flip] = faces[flip][:, ::-1]

    j_centers = _fibonacci_sphere(NUM_SKEL_JOINTS) * (scale * 0.5)
    j_centers[0] = 0.0

    if not is_right:  # mirror geometry for the left hand
        pts = pts * np.array([-1.0, 1.0, 1.0])
        faces = faces[:, ::-1].copy()
        j_centers = j_centers * np.array([-1.0, 1.0, 1.0])

    # Smooth LBS weights: softmax over negative distance to joint centers.
    d = np.linalg.norm(pts[:, None, :] - j_centers[None, :, :], axis=-1)
    logits = -d / (0.25 * scale)
    weights = np.exp(logits - logits.max(axis=1, keepdims=True))
    weights /= weights.sum(axis=1, keepdims=True)

    # J_regressor: normalized weights of each joint's nearest 20 vertices.
    j_reg = np.zeros((NUM_SKEL_JOINTS, NUM_VERTS))
    for j in range(NUM_SKEL_JOINTS):
        nearest = np.argsort(d[:, j])[:20]
        w = 1.0 / (d[nearest, j] + 1e-3)
        j_reg[j, nearest] = w / w.sum()

    shapedirs = rng.normal(0.0, 0.02 * scale, (NUM_VERTS, 3, 10))
    posedirs = rng.normal(0.0, 0.002 * scale, (NUM_VERTS, 3, 135))
    hands_components = np.linalg.qr(rng.normal(size=(45, 45)))[0] * 2.0
    hands_mean = rng.normal(0.0, 0.1, (45,))

    return ManoModel(
        v_template=_f32(pts),
        shapedirs=_f32(shapedirs),
        posedirs=_f32(posedirs),
        J_regressor=_f32(j_reg),
        weights=_f32(weights),
        hands_components=_f32(hands_components),
        hands_components_inv=_f32(np.linalg.inv(hands_components)),
        hands_mean=_f32(hands_mean),
        faces=torch.from_numpy(np.asarray(faces, np.int64)),
        is_right=is_right,
    )


def joint_regressor_21(J_regressor: torch.Tensor | np.ndarray) -> torch.Tensor:
    """Extend the (16, 778) regressor with fingertip one-hots and reorder
    into the 21-joint convention (reference `common/utils/mano.py:14-37`)."""
    j = np.asarray(J_regressor, np.float32)
    tips = np.zeros((5, j.shape[1]), np.float32)
    for row, vid in enumerate(TIP_VERTEX_IDS):
        tips[row, vid] = 1.0
    full = np.concatenate([j, tips], axis=0)
    return _f32(full[list(NEW_JOINT_ORDER)])
