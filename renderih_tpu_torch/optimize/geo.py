"""Two-hand pose refinement: contact and anti-penetration optimisation
(counterpart of `renderih_tpu/optimize/geo.py`).

Given two MANO parameter sets, refine them so that the hands touch
without interpenetrating while the pose stays plausible. The loss terms
mirror the reference's `geo_optimizer_both_batch.py` / `geo_loss.py`:
contact (matched vertex pairs, or anchors), repulsion along A's normals,
SDF anti-penetration (`ops/sdf.py`; kernel B3 on the card, two fields per
loss evaluation), edge preservation, pose/shape regularisation towards
the start, per-joint angle limits and an optional naturalness prior: a
Gaussian fitted to plausible poses, or the trained discriminator's
(`make_gan_pose_prior`, the port's copy of the artifact at
`POSE_PRIOR_PATH`).

The optimiser is Adam (optax's `adam(lr)`: betas 0.9/0.999, eps 1e-8)
over all eight tensors of both hands. Pose is axis-angle.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from renderih_tpu_torch.mano.layer import mano_forward
from renderih_tpu_torch.mano.params import to_device
from renderih_tpu_torch.models.aux_nets import PoseDiscriminator
from renderih_tpu_torch.ops.rotation import rodrigues
from renderih_tpu_torch.ops.sdf import sdf_penetration_loss
from renderih_tpu_torch.optimize.anchors import (
    anchor_contact_loss,
    anchor_normals,
    recover_anchors,
    search_anchor_pairs,
)
from renderih_tpu_torch.render.renderer import vertex_normals as _vertex_normals
from renderih_tpu_torch.utils.weights import flax_module_state_dict


class GeoWeights(NamedTuple):
    contact: float = 10.0      # reference: contact x 10
    repulsion: float = 0.5     # reference: repulsion x 0.5
    sdf: float = 100.0
    edge: float = 100.0
    pose_reg: float = 1.0
    shape_reg: float = 0.1
    angle_limit: float = 10.0
    prior: float = 0.01        # naturalness prior (pose_prior_fn) weight


def anchor_pairs(verts_a: torch.Tensor, verts_b: torch.Tensor,
                 thresh: float = 0.01) -> tuple[torch.Tensor, torch.Tensor]:
    """For each A-vertex its nearest B-vertex, and weight 1 where the pair
    is closer than `thresh` (0 elsewhere). The squared distance is expanded
    as a² - 2ab + b², as the JAX package does, so near-ties pick the same
    neighbour."""
    d2 = (torch.sum(verts_a ** 2, -1)[:, None] - 2.0 * verts_a @ verts_b.T
          + torch.sum(verts_b ** 2, -1)[None, :])
    idx = torch.argmin(d2, dim=-1)
    dist = torch.sqrt(torch.clamp_min(torch.gather(d2, 1, idx[:, None])[:, 0], 0))
    return idx, (dist < thresh).to(verts_a.dtype)


def contact_loss(verts_a, verts_b, idx_b, weight) -> torch.Tensor:
    """Attract matched pairs: weighted mean of ||v_a - v_b[idx]||²."""
    diff = verts_a - verts_b[idx_b]
    per = torch.sum(diff * diff, -1)
    return torch.sum(weight * per) / torch.clamp_min(weight.sum(), 1.0)


def repulsion_loss(verts_a, faces_a, verts_b, constant: float = 0.05,
                   threshold: float = 0.015) -> torch.Tensor:
    """Push B-vertices out along A's normals: for each B-vertex, the offset
    to its nearest A-vertex dotted with A's normal there, penalised as
    constant * exp(clip(-inner))² (`FieldLoss.repulsion_loss`)."""
    idx_a, _ = anchor_pairs(verts_b, verts_a, thresh=math.inf)
    normals_a = _vertex_normals(verts_a, faces_a)
    offset = verts_b - verts_a[idx_a]
    inner = torch.sum(offset * normals_a[idx_a], -1)
    val = constant * torch.exp(torch.clamp(-inner, -threshold, threshold)) ** 2
    return torch.sum(val)


def edge_lengths(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """(F, 3) lengths of each face's edges 0-1, 1-2, 2-0."""
    tri = verts[faces]
    e = torch.stack([tri[:, 0] - tri[:, 1], tri[:, 1] - tri[:, 2],
                     tri[:, 2] - tri[:, 0]], 1)
    return torch.sqrt(torch.sum(e * e, -1) + 1e-12)


def edge_preserve_loss(verts, faces, ref_edge_len) -> torch.Tensor:
    return torch.mean((edge_lengths(verts, faces) - ref_edge_len) ** 2)


def pose_angle_limit_loss(pose_aa: torch.Tensor,
                          limit: float = math.pi / 2) -> torch.Tensor:
    """Penalise per-joint rotation angles beyond `limit`."""
    angles = torch.sqrt(torch.sum(pose_aa.reshape(-1, 3) ** 2, -1) + 1e-12)
    return torch.sum(torch.clamp_min(angles - limit, 0.0) ** 2)


def make_gaussian_pose_prior(poses_aa: torch.Tensor, eps: float = 1e-3):
    """Fit a Gaussian to (N, 45) plausible poses; return the differentiable
    Mahalanobis energy `pose_aa (45,) -> scalar` (the analytic stand-in for
    the reference's GAN-discriminator naturalness score), on the poses'
    device."""
    mean = torch.mean(poses_aa, dim=0)
    centered = poses_aa - mean
    cov = centered.T @ centered / max(len(poses_aa) - 1, 1)
    prec = torch.linalg.inv(cov + eps * torch.eye(cov.shape[0], dtype=cov.dtype,
                                                  device=cov.device))

    def prior(pose_aa: torch.Tensor) -> torch.Tensor:
        d = pose_aa - mean
        return d @ prec @ d

    return prior


# the trained discriminator shipped with the port (a copy of the JAX
# package's artifact, made by `tools/train_pose_prior.py`)
POSE_PRIOR_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                               "assets_data", "pose_prior.npz")


def make_gan_pose_prior(params: dict, device: torch.device | str = "cpu"):
    """Trained-discriminator naturalness energy (reference
    `pose_data_optimize/Ver2Code/Discriminator/discrim.py:66-105`; the
    weights from `tools/train_pose_prior.py`, as `load_pose_prior` reads
    them). Returns a differentiable energy `pose_aa (45,) -> scalar` on
    `device`: softplus of the negated mean per-joint plus mean overall
    realism logit of `PoseDiscriminator` on the pose's rotations, so that
    plausible poses sit near 0 and the gradient points toward realism."""
    disc = PoseDiscriminator()
    disc.load_state_dict(flax_module_state_dict(params))
    disc.requires_grad_(False)
    disc.to(device)

    def prior(pose_aa: torch.Tensor) -> torch.Tensor:
        per_joint, overall = disc(rodrigues(pose_aa.reshape(1, 15, 3)))
        return F.softplus(-(per_joint.mean() + overall.mean()))

    return prior


def save_pose_prior(params, path: str) -> None:
    """Flatten nested discriminator params into an npz artifact."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else k, v)
        else:
            flat[prefix] = np.asarray(node)

    walk("", params)
    np.savez(path, **flat)


def load_pose_prior(path: str) -> dict:
    """An npz artifact back into the nested params dict (numpy arrays)."""
    flat = np.load(path)
    params: dict = {}
    for key in flat.files:
        node = params
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = flat[key]
    return params


class HandVars(NamedTuple):
    pose: torch.Tensor     # (45,) axis-angle
    shape: torch.Tensor    # (10,)
    trans: torch.Tensor    # (3,)
    root_aa: torch.Tensor  # (3,)


# (repulsion_mult, contact_mult, n_iter) per attempt; anchors searched
# fresh before attempts 0 and 3, re-matched with hysteresis before 1 and 2
# (`batch_optimize_mocap_origin.py:460-506`).
REFERENCE_SCHEDULE = ((1.0, 1.0, 50), (0.1, 15.0, 40),
                      (30.0, 0.1, 75), (1.0, 5.0, 50))


def hand_forward(model, hv: HandVars):
    """One hand's MANO vertices and joints (778, 3), (21, 3) in the
    uncentred MANO frame plus `trans`."""
    v, j = mano_forward(model, rodrigues(hv.root_aa[None]), hv.pose[None],
                        hv.shape[None], trans=hv.trans[None], center_idx=None,
                        use_pca=False)
    return v[0], j[0]


def make_refine_loss(assets, left: HandVars, right: HandVars,
                     weights: GeoWeights = GeoWeights(), sdf_grid_size: int = 24,
                     pose_prior_fn=None, anchors=None):
    """The refinement's objective around the start (left, right).

    Returns (loss_fn, match_fn): `loss_fn((l, r), match=None,
    contact_mult=1.0, repulsion_mult=1.0) -> (total, terms)`, and with
    `anchors` = (AnchorSpec_left, AnchorSpec_right) `match_fn((l, r),
    prev=None) -> AnchorMatch` (right is the main hand, left the sub
    hand); without anchors `match_fn` is None and contact pulls the vertex
    pairs closer than 0.01 at the start. The MANO models and specs move to
    the start's device here, once.
    """
    device = left.pose.device
    mano_l = to_device(assets.left.mano, device)
    mano_r = to_device(assets.right.mano, device)
    faces_l, faces_r = mano_l.faces, mano_r.faces

    with torch.no_grad():
        v_l0, _ = hand_forward(mano_l, left)
        v_r0, _ = hand_forward(mano_r, right)
        ref_edge_l = edge_lengths(v_l0, faces_l)
        ref_edge_r = edge_lengths(v_r0, faces_r)
        idx_lr, w_lr = anchor_pairs(v_l0, v_r0, thresh=0.01)

    match_fn = None
    if anchors is not None:
        spec_l, spec_r = (spec.to(device) for spec in anchors)

        def match_fn(params, prev=None):
            l, r = params
            with torch.no_grad():
                v_l, _ = hand_forward(mano_l, l)
                v_r, _ = hand_forward(mano_r, r)
                return search_anchor_pairs(
                    recover_anchors(v_r, spec_r), recover_anchors(v_l, spec_l),
                    anchor_normals(v_r, spec_r), anchor_normals(v_l, spec_l, flip=True),
                    prev=prev)

    def loss_fn(params, match=None, contact_mult=1.0, repulsion_mult=1.0):
        l, r = params
        v_l, _ = hand_forward(mano_l, l)
        v_r, _ = hand_forward(mano_r, r)
        if match is not None:
            contact = anchor_contact_loss(v_r, v_l, spec_r, spec_l, match)
        else:
            contact = contact_loss(v_l, v_r, idx_lr, w_lr)
        terms = {
            "contact": contact,
            "repulsion": repulsion_loss(v_l, faces_l, v_r)
            + repulsion_loss(v_r, faces_r, v_l),
            "sdf": sdf_penetration_loss(v_l[None], v_r[None], faces_l, sdf_grid_size)
            + sdf_penetration_loss(v_r[None], v_l[None], faces_r, sdf_grid_size),
            "edge": edge_preserve_loss(v_l, faces_l, ref_edge_l)
            + edge_preserve_loss(v_r, faces_r, ref_edge_r),
            "pose_reg": torch.sum((l.pose - left.pose) ** 2)
            + torch.sum((r.pose - right.pose) ** 2),
            "shape_reg": torch.sum((l.shape - left.shape) ** 2)
            + torch.sum((r.shape - right.shape) ** 2),
            "angle": pose_angle_limit_loss(l.pose) + pose_angle_limit_loss(r.pose),
        }
        if pose_prior_fn is not None:
            terms["prior"] = pose_prior_fn(l.pose) + pose_prior_fn(r.pose)
        total = (weights.contact * contact_mult * terms["contact"]
                 + weights.repulsion * repulsion_mult * terms["repulsion"]
                 + weights.sdf * terms["sdf"]
                 + weights.edge * terms["edge"]
                 + weights.pose_reg * terms["pose_reg"]
                 + weights.shape_reg * terms["shape_reg"]
                 + weights.angle_limit * terms["angle"])
        if pose_prior_fn is not None:
            total = total + weights.prior * terms["prior"]
        return total, terms

    return loss_fn, match_fn


def _adam(loss_fn, params, iters: int, lr: float, **loss_kw):
    """`iters` Adam steps from `params` (a fresh optimiser state, as optax's
    `tx.init` at each call), then the loss terms at the result."""
    leaves = [t.detach().clone().requires_grad_(True) for hv in params for t in hv]

    def unflatten(ts):
        return HandVars(*ts[:4]), HandVars(*ts[4:])

    opt = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    for _ in range(iters):
        opt.zero_grad(set_to_none=True)
        total, _ = loss_fn(unflatten(leaves), **loss_kw)
        total.backward()
        opt.step()
    out = unflatten([t.detach() for t in leaves])
    with torch.no_grad():
        _, terms = loss_fn(out, **loss_kw)
    return out, {k: v.detach() for k, v in terms.items()}


def optimize_two_hands(assets, left: HandVars, right: HandVars, n_iter: int = 300,
                       lr: float = 1e-2, weights: GeoWeights = GeoWeights(),
                       sdf_grid_size: int = 24, pose_prior_fn=None, anchors=None,
                       schedule=None):
    """Jointly refine both hands; returns (left', right', final loss terms).

    Runs where the start's tensors lie. Without `anchors`, `n_iter` Adam
    steps on the vertex-pair contact. With `anchors` (AnchorSpec_left,
    AnchorSpec_right) it runs `schedule` (default REFERENCE_SCHEDULE):
    per attempt (repulsion_mult, contact_mult, iters), with the anchors
    searched fresh before attempts 0 and 3 and re-matched with hysteresis
    before 1 and 2, and a fresh Adam state in each attempt. Every loss
    evaluation builds two SDF fields, so one attempt of `iters` steps makes
    2 * iters + 2 `sdf_grid` calls.
    """
    loss_fn, match_fn = make_refine_loss(assets, left, right, weights, sdf_grid_size,
                                         pose_prior_fn, anchors)
    params = (left, right)
    if match_fn is None:
        (left_out, right_out), terms = _adam(loss_fn, params, n_iter, lr)
        return left_out, right_out, terms

    match, terms = None, None
    sched = schedule if schedule is not None else REFERENCE_SCHEDULE
    for attempt, (rep_mult, con_mult, iters) in enumerate(sched):
        if attempt in (0, 3) or match is None:
            match = match_fn(params)
        else:
            match = match_fn(params, match)
        params, terms = _adam(loss_fn, params, iters, lr, match=match,
                              contact_mult=con_mult, repulsion_mult=rep_mult)
    left_out, right_out = params
    return left_out, right_out, terms
