"""MANO surface anchors and the anchor-based contact search (counterpart of
`renderih_tpu/optimize/anchors.py`).

The reference's pose optimiser drives its contact loss through ~108
surface anchors per hand, recovered barycentrically from designated
triangles (`anchorutils.py:38-65`), and matches sub-hand anchors to
main-hand anchors with normal gating, a cosine elasticity window and
4-nearest re-matching (`batch_optimize_mocap_origin.py:62-132`). Here the
per-anchor loops are one masked (A_sub, A_main) distance matrix and a
top-k.

  * The shipped `merged_vertex_assignment.txt` has all-zero classes, so
    the class logic reduces to a uniform `elasti *= 0.3`; `classes` is
    kept in the spec for converted real assets.
  * Normals are per-anchor triangle normals; the sub hand's are negated.
  * With `prev`, only the previously matched ids are re-measured, at the
    wider 0.02 hysteresis radius (`:77-93`).
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import numpy as np
import torch


class AnchorSpec(NamedTuple):
    tri_idx: torch.Tensor   # (A, 3) int64: vertex ids of the defining triangle
    weights: torch.Tensor   # (A, 2) f32: barycentric edge weights
    classes: torch.Tensor   # (A,) int64: region class per anchor

    def to(self, device) -> "AnchorSpec":
        return AnchorSpec(*(t.to(device) for t in self))


def load_anchor_txt(anchor_dir: str) -> AnchorSpec:
    """The reference's anchor asset directory (`face_vertex_idx.txt`,
    `anchor_weight.txt`, `merged_vertex_assignment.txt`)."""
    tri = np.loadtxt(os.path.join(anchor_dir, "face_vertex_idx.txt"), dtype=np.int64)
    w = np.loadtxt(os.path.join(anchor_dir, "anchor_weight.txt"))
    cls = np.loadtxt(os.path.join(anchor_dir, "merged_vertex_assignment.txt"),
                     dtype=np.int64)
    return AnchorSpec(torch.from_numpy(tri), torch.from_numpy(np.asarray(w, np.float32)),
                      torch.from_numpy(cls))


def make_synthetic_anchors(faces: np.ndarray, verts: np.ndarray,
                           n_anchors: int = 108) -> AnchorSpec:
    """Deterministic anchors for the synthetic hand: `n_anchors` faces
    spread by farthest-point sampling over face centres, each anchor at
    its face's centroid (weights 1/3, 1/3); classes zero like the shipped
    asset."""
    faces = np.asarray(faces)
    verts = np.asarray(verts)
    centers = verts[faces].mean(axis=1)
    chosen = [0]
    d = np.linalg.norm(centers - centers[0], axis=-1)
    for _ in range(n_anchors - 1):
        nxt = int(np.argmax(d))
        chosen.append(nxt)
        d = np.minimum(d, np.linalg.norm(centers - centers[nxt], axis=-1))
    tri = faces[np.asarray(chosen)].astype(np.int64)
    w = np.full((n_anchors, 2), 1.0 / 3.0, np.float32)
    return AnchorSpec(torch.from_numpy(tri), torch.from_numpy(w),
                      torch.zeros((n_anchors,), dtype=torch.int64))


def recover_anchors(verts: torch.Tensor, spec: AnchorSpec) -> torch.Tensor:
    """(V, 3) -> (A, 3): o + w1 (v1 - o) + w2 (v2 - o)."""
    tri = verts[spec.tri_idx]
    o = tri[:, 0]
    return (o + spec.weights[:, 0:1] * (tri[:, 1] - o)
            + spec.weights[:, 1:2] * (tri[:, 2] - o))


def anchor_normals(verts: torch.Tensor, spec: AnchorSpec,
                   flip: bool = False) -> torch.Tensor:
    """Unit normal of each anchor's triangle; `flip` for the sub hand."""
    tri = verts[spec.tri_idx]
    n = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0], dim=-1)
    n = n / (torch.linalg.norm(n, dim=-1, keepdim=True) + 1e-12)
    return -n if flip else n


class AnchorMatch(NamedTuple):
    idx: torch.Tensor             # (A_sub, K) matched main-anchor ids
    elasti: torch.Tensor          # (A_sub, K) cosine-window elasticity (masked)
    mask: torch.Tensor            # (A_sub, K) f32 validity
    vertex_contact: torch.Tensor  # (A_sub,) f32 any-contact flag


_BIG = 1e3


def search_anchor_pairs(main_anchors: torch.Tensor, sub_anchors: torch.Tensor,
                        main_normals: torch.Tensor, sub_normals: torch.Tensor,
                        radius: float = 0.015, k: int = 4,
                        prev: AnchorMatch | None = None) -> AnchorMatch:
    """Normal-gated K-nearest anchor matching.

    Pairs whose normals are not opposed (dot > -0.6) are excluded; pairs
    within `radius` get elasticity 0.5 cos(pi d / radius) + 0.5, times the
    uniform 0.3; the K nearest per sub anchor are kept. With `prev`, only
    the previously matched ids count, at the 0.02 hysteresis radius."""
    d = torch.linalg.norm(sub_anchors[:, None, :] - main_anchors[None, :, :], dim=-1)
    if prev is not None:
        radius = 0.02
        idx = prev.idx
        dk = torch.gather(d, 1, idx)
        dk = torch.where(prev.mask > 0, dk, torch.full_like(dk, _BIG))
    else:
        against = torch.einsum("ad,bd->ab", sub_normals, main_normals) > -0.6
        d = torch.where(against, torch.full_like(d, _BIG), d)
        neg, idx = torch.topk(-d, k, dim=1, sorted=True)
        dk = -neg
    contact_able = dk < radius
    elasti = torch.where(contact_able, 0.5 * torch.cos(math.pi * dk / radius) + 0.5,
                         torch.zeros_like(dk))
    elasti = elasti * 0.3  # shipped classes are all zero: uniform factor
    mask = (elasti > 0.0).to(dk.dtype)
    vertex_contact = (mask.sum(-1) > 0).to(dk.dtype)
    return AnchorMatch(idx=idx, elasti=elasti, mask=mask, vertex_contact=vertex_contact)


def anchor_contact_loss(verts_main: torch.Tensor, verts_sub: torch.Tensor,
                        spec_main: AnchorSpec, spec_sub: AnchorSpec,
                        match: AnchorMatch) -> torch.Tensor:
    """sum(e ||sub_a - main_a[idx]||²) / max(sum(mask), 1), anchors from the
    live vertices so the gradient reaches both hands."""
    a_main = recover_anchors(verts_main, spec_main)
    a_sub = recover_anchors(verts_sub, spec_sub)
    diff = a_sub[:, None, :] - a_main[match.idx]
    per = torch.sum(diff * diff, dim=-1)
    return torch.sum(match.elasti * match.mask * per) / torch.clamp_min(match.mask.sum(), 1.0)
