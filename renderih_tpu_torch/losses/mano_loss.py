"""MANO-parameter losses of the `decoder="mano"` variant (counterpart of
`renderih_tpu/losses/mano_loss.py`; reference `ManoLoss` /
`mano_loss_GCN`, `core/Loss_mano.py:62-335`): on top of the graph loss,

  * pose: MSE between the rotation matrices of the predicted 6D pose and
    of the label's axis-angle pose (16 joints, the root included);
  * shape: MSE on the 10 betas, and an L2 regulariser on them x 0.005;
  * root_rel: MSE on the inter-hand root offset.
"""

from __future__ import annotations

import torch

from renderih_tpu_torch.ops.rotation import rodrigues, rot6d_to_rotmat


def pose_rotmat_loss(pred_pose_aa: torch.Tensor, gt_pose_aa: torch.Tensor) -> torch.Tensor:
    """MSE between Rodrigues matrices; poses (..., 48) axis-angle."""
    pr = rodrigues(pred_pose_aa.reshape(-1, 3))
    gr = rodrigues(gt_pose_aa.reshape(-1, 3))
    return ((pr - gr) ** 2).mean()


def pose6d_rotmat_loss(pred_pose6d: torch.Tensor, gt_pose_aa: torch.Tensor) -> torch.Tensor:
    """MSE between 6D-predicted and label rotation matrices: pred (B, 96) =
    16 x 6D, label (B, 48) axis-angle (root + 15 joints)."""
    pr = rot6d_to_rotmat(pred_pose6d.reshape(-1, 6))
    gr = rodrigues(gt_pose_aa.reshape(-1, 3))
    return ((pr - gr) ** 2).mean()


def mano_param_losses(out, batch: dict, shape_reg: float = 0.005) -> dict:
    """The terms 'pose', 'shape' and 'shape_reg', each the mean of the two
    hands'; `out` has `mano_pose`/`mano_shape`, `batch` 'pose_{hand}'
    (B, 48) and 'shape_{hand}' (B, 10)."""
    terms = {"pose": 0.0, "shape": 0.0, "shape_reg": 0.0}
    for hand in ("left", "right"):
        shape = out.mano_shape[hand]
        terms["pose"] += 0.5 * pose6d_rotmat_loss(out.mano_pose[hand], batch[f"pose_{hand}"])
        terms["shape"] += 0.5 * ((shape - batch[f"shape_{hand}"]) ** 2).mean()
        terms["shape_reg"] += 0.5 * shape_reg * (shape**2).mean()
    return terms


def root_rel_loss(pred_root_rel: torch.Tensor, gt_root_rel: torch.Tensor) -> torch.Tensor:
    return ((pred_root_rel - gt_root_rel) ** 2).mean()
