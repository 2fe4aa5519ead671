"""MANO forward pass (counterpart of `renderih_tpu/mano/layer.py`).

Same inputs and outputs as the reference's `ManoLayer.forward`
(`models/manolayer.py:250-322`). The 16-step kinematic chain is composed
level by level: the tree has depth 3 below the root with one joint per
finger on each level, so the global transforms are three batched
(B, 5, 4, 4) products. Blend shapes and skinning are einsums.
"""

from __future__ import annotations

import torch

from renderih_tpu_torch.mano.params import (
    KINEMATIC_LEVELS,
    NEW_JOINT_ORDER,
    TIP_VERTEX_IDS,
    ManoModel,
)
from renderih_tpu_torch.ops.rotation import rodrigues

# new_skel knuckle overrides (reference `models/manolayer.py:316-320`)
_NEW_SKEL_JOINTS = (5, 9, 13, 17)
_NEW_SKEL_VERTS = ((63, 144), (271, 220), (148, 290), (770, 83))

# stacked order [root] + level 1 + level 2 + level 3 -> joint order 0..15
_STACK_ORDER = (0,) + KINEMATIC_LEVELS[0] + KINEMATIC_LEVELS[1] + KINEMATIC_LEVELS[2]
_UNSTACK = tuple(_STACK_ORDER.index(j) for j in range(16))


def pca_to_axis(model: ManoModel, pca: torch.Tensor) -> torch.Tensor:
    """PCA pose coefficients (..., ncomps) -> 45-dim axis-angle."""
    ncomps = pca.shape[-1]
    return pca @ model.hands_components[:ncomps] + model.hands_mean


def axis_to_pca(model: ManoModel, axis: torch.Tensor) -> torch.Tensor:
    """45-dim axis-angle -> full 45-dim PCA coefficients."""
    return (axis - model.hands_mean) @ model.hands_components_inv


def pose_to_rotmats(model: ManoModel, pose: torch.Tensor,
                    use_pca: bool = True) -> torch.Tensor:
    """Pose (..., ncomps) or (..., 45) axis-angle -> (..., 15, 3, 3)."""
    axis = pca_to_axis(model, pose) if use_pca else pose
    return rodrigues(axis.reshape(axis.shape[:-1] + (15, 3)))


def _compose_kinematics(local: torch.Tensor) -> torch.Tensor:
    """Local joint SE(3)s (B, 16, 4, 4), root = 0 -> global (B, 16, 4, 4).
    The parent of each level-k joint is the same finger's level-(k-1)
    joint; level 0's parent is the root."""
    g_root = local[:, 0]
    l1, l2, l3 = (list(level) for level in KINEMATIC_LEVELS)
    g1 = torch.einsum("bij,bfjk->bfik", g_root, local[:, l1])
    g2 = torch.einsum("bfij,bfjk->bfik", g1, local[:, l2])
    g3 = torch.einsum("bfij,bfjk->bfik", g2, local[:, l3])
    stacked = torch.cat([g_root[:, None], g1, g2, g3], dim=1)
    return stacked[:, list(_UNSTACK)]


def mano_forward(
    model: ManoModel,
    root_rotmat: torch.Tensor,
    pose: torch.Tensor,
    shape: torch.Tensor,
    trans: torch.Tensor | None = None,
    scale: torch.Tensor | None = None,
    center_idx: int | None = 9,
    use_pca: bool = True,
    new_skel: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pose/shape -> (verts (B, 778, 3), joints (B, 21, 3)).

    root_rotmat (B, 3, 3); pose (B, ncomps) PCA coefficients, (B, 45)
    axis-angle with `use_pca=False`, or (B, 15, 3, 3) rotation matrices;
    shape (B, 10); trans (B, 3) applied last; scale (B,) applied after
    centring on joint `center_idx` (9 = middle MCP; None keeps the MANO
    root frame); `new_skel` replaces 4 knuckle joints by vertex midpoints.
    """
    bs = root_rotmat.shape[0]
    dtype, device = root_rotmat.dtype, root_rotmat.device

    rotmats = pose if pose.dim() == 4 else pose_to_rotmats(model, pose, use_pca)

    v_shaped = model.v_template + torch.einsum("vds,bs->bvd", model.shapedirs, shape)
    j_tpose = torch.einsum("jv,bvd->bjd", model.J_regressor, v_shaped)
    eye = torch.eye(3, dtype=dtype, device=device)
    pose_feat = (rotmats - eye).reshape(bs, 135)
    v_tpose = v_shaped + torch.einsum("vdp,bp->bvd", model.posedirs, pose_feat)

    # local SE(3) per joint: [R | (I - R) j], each joint a fixed point of
    # its own transform
    all_rot = torch.cat([root_rotmat[:, None], rotmats], dim=1)  # (B, 16, 3, 3)
    t_local = torch.einsum("bjmn,bjn->bjm", eye - all_rot, j_tpose)
    top = torch.cat([all_rot, t_local[..., None]], dim=-1)  # (B, 16, 3, 4)
    bottom = torch.zeros((bs, 16, 1, 4), dtype=dtype, device=device)
    bottom[..., 3] = 1.0
    local = torch.cat([top, bottom], dim=-2)

    g = _compose_kinematics(local)

    j_posed = torch.einsum("bjmn,bjn->bjm", g[:, :, :3, :3], j_tpose) + g[:, :, :3, 3]
    t_verts = torch.einsum("vj,bjmn->bvmn", model.weights, g)  # (B, 778, 4, 4)
    v_out = (torch.einsum("bvmn,bvn->bvm", t_verts[:, :, :3, :3], v_tpose)
             + t_verts[:, :, :3, 3])

    # 21 joints = 16 skeleton + 5 fingertip vertices, reordered
    tips = v_out[:, list(TIP_VERTEX_IDS)]
    j_out = torch.cat([j_posed, tips], dim=1)[:, list(NEW_JOINT_ORDER)]

    if center_idx is not None:
        center = j_out[:, center_idx:center_idx + 1]
        v_out = v_out - center
        j_out = j_out - center
    if scale is not None:
        v_out = v_out * scale[:, None, None]
        j_out = j_out * scale[:, None, None]
    if trans is not None:
        v_out = v_out + trans[:, None, :]
        j_out = j_out + trans[:, None, :]
    if new_skel:
        j_out = j_out.clone()
        for joint, (va, vb) in zip(_NEW_SKEL_JOINTS, _NEW_SKEL_VERTS):
            j_out[:, joint] = (v_out[:, va] + v_out[:, vb]) / 2.0
    return v_out, j_out
