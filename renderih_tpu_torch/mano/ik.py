"""Joints -> MANO parameters: batched analytic IK + gradient refinement
(counterpart of `renderih_tpu/mano/ik.py`).

Reference capability: `utils/mano_from_3djoint/AIK.py:16-103` (adaptive
twist-swing IK, one hand at a time) and
`utils/mano_from_3djoint/convert2mano.py:160-204` (200-step Adam
refinement of pose + shape against the target joints). Everything is
batched over hands and runs on the device of the tensors given (the
ManoModel must be there too, `mano/params.py:to_device`): the kinematic
recursion is level-parallel (3 iterations of (B, 5, ...) math, as
`mano/layer.py`), the global rotation is Horn's quaternion closed form
(`eval/metrics.py:_umeyama_rotation`, no SVD), and the refinement is Adam
on axis-angle with a linearly decayed learning rate, stepped by hand with
optax's conventions (below).

Joint convention: the pipeline-wide 21-joint order (mano/params.py
NEW_JOINT_ORDER = wrist, thumb..tip, index..tip, middle..tip, ring..tip,
pinky..tip), the reference's SNAP order
(`utils/mano_from_3djoint/config.py:84-124`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from renderih_tpu_torch.eval.metrics import _umeyama_rotation
from renderih_tpu_torch.mano.layer import mano_forward
from renderih_tpu_torch.mano.params import ManoModel
from renderih_tpu_torch.ops.rotation import rodrigues, rodrigues_inverse

# 21-joint (SNAP) tree, grouped by depth. Finger order inside each level:
# thumb, index, middle, ring, pinky.
_MCP = (1, 5, 9, 13, 17)          # level 1 (children of the wrist)
_LEVELS = (
    (2, 6, 10, 14, 18),           # level 2
    (3, 7, 11, 15, 19),           # level 3
    (4, 8, 12, 16, 20),           # level 4 (fingertips)
)
# Skeleton pose slot (0..14, MANO joint id - 1) holding the local rotation
# computed at each level, per finger: the rotation swinging the bone into
# level-k joints lives at the level-(k-1) parent's slot (reference
# `config.py:126-132` ID2ROT). MANO finger blocks: index 1-3, middle 4-6,
# pinky 7-9, ring 10-12, thumb 13-15.
_POSE_SLOTS = (
    (12, 0, 3, 9, 6),             # rotations at the MCPs
    (13, 1, 4, 10, 7),            # rotations at the PIPs
    (14, 2, 5, 11, 8),            # rotations at the DIPs
)

# optax.adam's defaults
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def _safe_normalize(v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + eps)


def _normalize_target(template: torch.Tensor, joints: torch.Tensor) -> torch.Tensor:
    """Rescale (|j9 - j0| -> template scale) and re-anchor at the template
    wrist (`convert2mano.py:167-169`)."""
    t = template.float()
    p = joints.float()
    ratio = torch.linalg.norm(t[9] - t[0]) / (
        torch.linalg.norm(p[:, 9] - p[:, 0], dim=-1) + 1e-9)
    p = p * ratio[:, None, None]
    return p - p[:, :1] + t[0]


def _adaptive_ik_normalized(template: torch.Tensor, p: torch.Tensor):
    """Twist-swing sweep on a normalized target. Returns (root_rotmat
    (B, 3, 3), locals (B, 15, 3, 3), q (B, 21, 3)): the rotations and the
    rigid-chain joint positions the IK itself predicts (tips included)."""
    b = p.shape[0]
    t = template.float()
    mcp = list(_MCP)
    # global rotation from the five wrist->MCP directions (Horn; the
    # reference uses Arun's SVD, `AIK.py:46-67`)
    dirs_t = t[mcp] - t[0]                         # (5, 3)
    dirs_p = p[:, mcp] - p[:, :1]                  # (B, 5, 3)
    r0, _ = _umeyama_rotation(torch.einsum("fi,bfj->bij", dirs_t, dirs_p))

    r_pa = r0[:, None].expand(b, 5, 3, 3)
    q_pa = torch.einsum("bij,fj->bfi", r0, dirs_t) + t[0]  # MCP positions
    t_pa = t[mcp]
    locals_out = torch.zeros((b, 15, 3, 3), dtype=torch.float32, device=p.device)
    q_out = torch.zeros((b, 21, 3), dtype=torch.float32, device=p.device)
    q_out[:, 0] = t[0]
    q_out[:, mcp] = q_pa
    for child_ids, slots in zip(_LEVELS, _POSE_SLOTS):
        child = list(child_ids)
        delta_t = t[child] - t_pa                                  # (5, 3)
        # parent-frame offset of the observed child joint: R^T (p - q)
        delta_p = torch.einsum("bfji,bfj->bfi", r_pa, p[:, child] - q_pa)
        axis = _safe_normalize(torch.cross(delta_t.expand_as(delta_p), delta_p, dim=-1))
        denom = ((torch.linalg.norm(delta_t, dim=-1) + 1e-8)
                 * (torch.linalg.norm(delta_p, dim=-1) + 1e-8))
        cos_a = torch.clamp(torch.einsum("fi,bfi->bf", delta_t, delta_p) / denom, -1.0, 1.0)
        r_local = rodrigues(axis * torch.arccos(cos_a)[..., None])  # (B, 5, 3, 3)
        r_k = torch.einsum("bfij,bfjk->bfik", r_pa, r_local)
        q_k = torch.einsum("bfij,fj->bfi", r_k, delta_t) + q_pa
        locals_out[:, list(slots)] = r_local
        q_out[:, child] = q_k
        r_pa, q_pa, t_pa = r_k, q_k, t[child]
    return r0, locals_out, q_out


def adaptive_ik(template: torch.Tensor, joints: torch.Tensor, tip_iters: int = 0,
                model: ManoModel | None = None):
    """Twist-swing analytic IK, batched.

    template (21, 3) zero-pose MANO joints; joints (B, 21, 3) targets in
    the same order, in any unit and offset (they are rescaled to the
    template and re-anchored at its wrist). `tip_iters` fingertip sweeps
    (need `model`): the 5 tips are skinned vertices off the rigid chain, so
    each sweep measures that offset with one `mano_forward` and re-aims the
    distal swing at `tip_target - offset`.

    Returns (root_rotmat (B, 3, 3), rotmats (B, 15, 3, 3)) in MANO skeleton
    order, consumable by `mano_forward(..., pose=rotmats)`. Matches
    `AIK.adaptive_IK` with the twist fixed at zero.
    """
    p = _normalize_target(template, joints)
    r0, locals_out, q = _adaptive_ik_normalized(template, p)
    tips = list(_LEVELS[-1])
    b = joints.shape[0]
    for _ in range(tip_iters):
        assert model is not None, "tip_iters needs the ManoModel"
        _, j_fwd = mano_forward(model, r0, locals_out,
                                torch.zeros((b, 10), device=joints.device),
                                center_idx=None, use_pca=False)
        j_fwd = j_fwd - j_fwd[:, :1] + p[:, :1]  # template-anchored
        offset = j_fwd[:, tips] - q[:, tips]     # skinning offset
        p = p.clone()
        p[:, tips] = _normalize_target(template, joints)[:, tips] - offset
        r0, locals_out, q = _adaptive_ik_normalized(template, p)
    return r0, locals_out


def ik_template(model: ManoModel, shape: torch.Tensor | None = None) -> torch.Tensor:
    """Zero-pose 21 joints for `adaptive_ik` (optionally shape-dependent),
    on the model's device."""
    dev = model.v_template.device
    shape = torch.zeros((1, 10), device=dev) if shape is None else shape.reshape(1, 10)
    eye = torch.eye(3, device=dev)[None]
    _, j = mano_forward(model, eye, torch.zeros((1, 45), device=dev), shape,
                        center_idx=None, use_pca=False)
    return j[0]


class IKFit(NamedTuple):
    root_aa: torch.Tensor    # (B, 3) global wrist axis-angle
    pose_aa: torch.Tensor    # (B, 45) local pose axis-angle
    shape: torch.Tensor      # (B, 10)
    joint_err: torch.Tensor  # (B,) mean |joint residual| after the fit


@torch.no_grad()
def ik_from_joints(model: ManoModel, joints: torch.Tensor, tip_iters: int = 2) -> IKFit:
    """Analytic-only fit (no gradient refinement): joints -> IKFit."""
    template = ik_template(model)
    r0, rotmats = adaptive_ik(template, joints, tip_iters=tip_iters, model=model)
    b = joints.shape[0]
    root_aa = rodrigues_inverse(r0)
    pose_aa = rodrigues_inverse(rotmats).reshape(b, 45)
    shape = torch.zeros((b, 10), device=joints.device)
    err = _joint_residual(model, root_aa, pose_aa, shape, joints)
    return IKFit(root_aa, pose_aa, shape, err)


def _joint_residual(model, root_aa, pose_aa, shape, target):
    _, j = mano_forward(model, rodrigues(root_aa), pose_aa, shape,
                        center_idx=None, use_pca=False)
    j = j - j[:, :1]
    tgt = target.float() - target[:, :1].float()
    t0 = ik_template(model)  # match scales the way the IK does (unit-agnostic)
    ratio = torch.linalg.norm(t0[9] - t0[0]) / (torch.linalg.norm(tgt[:, 9], dim=-1) + 1e-9)
    return (j - tgt * ratio[:, None, None]).abs().mean(dim=(1, 2))


def fit_mano_to_joints(model: ManoModel, joints: torch.Tensor, iters: int = 200,
                       lr: float = 1e-1, shape_reg: float = 2e-3,
                       pose_reg: float = 1e-3) -> IKFit:
    """AIK initialization + Adam refinement of pose and shape.

    The reference (`convert2mano.py:177-204`) optimizes raw rotation-matrix
    entries and re-orthogonalizes; this optimizes axis-angle directly (the
    parameters MANO consumes). `pose_reg` weakly pulls the pose toward the
    swing-only initialization: 21 joints cannot observe bone twist, and
    the regularizer pins that null space at zero twist.

    The steps are optax.adam(optax.linear_schedule(lr, 0, iters)) exactly:
    step t (from 0) moves by -lr·(1 - t/iters)·m̂/(√v̂ + 1e-8), with m̂ and
    v̂ the bias-corrected moments (b1 0.9, b2 0.999) after the step's own
    gradient.
    """
    b = joints.shape[0]
    dev = joints.device
    with torch.no_grad():
        template = ik_template(model)
        r0, rotmats = adaptive_ik(template, joints, tip_iters=2, model=model)
        # normalized target: template scale, root-relative
        tgt = joints.float()
        ratio = torch.linalg.norm(template[9] - template[0]) / (
            torch.linalg.norm(tgt[:, 9] - tgt[:, 0], dim=-1) + 1e-9)
        tgt = (tgt - tgt[:, :1]) * ratio[:, None, None]
        params = [rodrigues_inverse(r0), rodrigues_inverse(rotmats).reshape(b, 45),
                  torch.zeros((b, 10), device=dev)]
    pose_init = params[1].clone()
    mu = [torch.zeros_like(x) for x in params]
    nu = [torch.zeros_like(x) for x in params]
    b1, b2 = torch.tensor(_B1, device=dev), torch.tensor(_B2, device=dev)

    for t in range(iters):
        root, pose, shape = (x.detach().requires_grad_(True) for x in params)
        _, j = mano_forward(model, rodrigues(root), pose, shape, center_idx=None,
                            use_pca=False)
        j = j - j[:, :1]
        loss = ((j - tgt).abs().mean() + shape_reg * (shape ** 2).mean()
                + pose_reg * ((pose - pose_init) ** 2).mean())
        grads = torch.autograd.grad(loss, (root, pose, shape))
        with torch.no_grad():
            step = -lr * (1.0 - t / iters)
            c1, c2 = 1 - b1 ** (t + 1), 1 - b2 ** (t + 1)
            for k, g in enumerate(grads):
                mu[k] = (1 - _B1) * g + _B1 * mu[k]
                nu[k] = (1 - _B2) * (g * g) + _B2 * nu[k]
                update = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + _EPS)
                params[k] = params[k] + step * update
    with torch.no_grad():
        err = _joint_residual(model, *params, joints)
    return IKFit(params[0], params[1], params[2], err)


@torch.no_grad()
def mano_from_fit(model: ManoModel, fit: IKFit, target_joints: torch.Tensor):
    """MANO on a fit, mapped back into the target's frame: the IK works at
    template scale anchored at the template wrist, so rescale by the
    target's |j9 - j0| and re-anchor at the target wrist. Returns (verts
    (B, 778, 3), joints (B, 21, 3))."""
    v, j = mano_forward(model, rodrigues(fit.root_aa), fit.pose_aa, fit.shape,
                        center_idx=None, use_pca=False)
    template = ik_template(model)
    t_len = torch.linalg.norm(template[9] - template[0])
    tgt = target_joints.float()
    scale = (torch.linalg.norm(tgt[:, 9] - tgt[:, 0], dim=-1) / (t_len + 1e-9))[:, None, None]
    v = (v - j[:, :1]) * scale + tgt[:, :1]
    j = (j - j[:, :1]) * scale + tgt[:, :1]
    return v, j
