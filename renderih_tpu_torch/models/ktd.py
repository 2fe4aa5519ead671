"""KTD: the kinematics-aware MANO parameter head (counterpart of
`renderih_tpu/models/ktd.py`).

A chain of tiny regressors where each joint's 6D rotation is predicted
from the shared hidden feature concatenated with the predictions of all
its kinematic ancestors (`common/myhand/decoder_ktd.py:26-110`, ancestor
table `:6-23`), plus shape and orthographic camera heads. The 16 steps are
16 small GEMMs, as in the JAX package. Parameter names are the JAX
module's (`fc1`, `fc2`, `decshape`, `deccam`; its `joint_reg{j}` are
`joint_reg.{j}` here): `utils/weights.py:ktd_state_dict_from_jax`.
"""

from __future__ import annotations

import torch
from torch import nn

from renderih_tpu_torch.mano.layer import mano_forward
from renderih_tpu_torch.models.layers import Linear
from renderih_tpu_torch.ops.dropout import dropout
from renderih_tpu_torch.ops.projection import orthographic_project
from renderih_tpu_torch.ops.rotation import rot6d_to_rotmat

# Ancestor indices per MANO joint (root, then index/middle/pinky/ring/
# thumb chains of 3), reference `decoder_ktd.py:6-23`.
HAND_ANCESTORS: tuple = (
    (),
    (0,), (0, 1), (0, 1, 2),
    (0,), (0, 4), (0, 4, 5),
    (0,), (0, 7), (0, 7, 8),
    (0,), (0, 10), (0, 10, 11),
    (0,), (0, 13), (0, 13, 14),
)


def _small_(linear: nn.Linear) -> None:
    """flax `variance_scaling(1e-4, "fan_avg", "uniform")` on a Linear, bias 0."""
    fan_avg = (linear.in_features + linear.out_features) / 2
    bound = (3e-4 / fan_avg) ** 0.5
    nn.init.uniform_(linear.weight, -bound, bound)
    nn.init.zeros_(linear.bias)


class KTDHead(nn.Module):
    """Single-hand KTD regressor: global feature (B, in_dim) -> (pose6d
    (B, 96), shape (B, 10), cam (B, 3)), float32. The chain's and the two
    heads' weights start near 0 (flax's 1e-4 variance scaling)."""

    def __init__(self, in_dim: int, hidden_dim: int = 1024, dropout: float = 0.5):
        super().__init__()
        self.dropout = dropout
        self.fc1 = Linear(in_dim, hidden_dim)
        self.fc2 = Linear(hidden_dim, hidden_dim)
        self.decshape = Linear(hidden_dim, 10)
        self.deccam = Linear(hidden_dim, 3)
        self.joint_reg = nn.ModuleList(Linear(hidden_dim + 6 * len(anc), 6)
                                       for anc in HAND_ANCESTORS)
        for head in (self.decshape, self.deccam, *self.joint_reg):
            _small_(head)

    def forward(self, x: torch.Tensor):
        x = dropout(self.fc1(x), self.dropout, self.training)
        x = dropout(self.fc2(x), self.dropout, self.training)
        shape = self.decshape(x)
        cam = self.deccam(x)
        poses = []
        for reg, ancestors in zip(self.joint_reg, HAND_ANCESTORS):
            poses.append(reg(torch.cat([x] + [poses[a] for a in ancestors], -1)))
        pose6d = torch.cat(poses, -1)
        return pose6d.float(), shape.float(), cam.float()


def ktd_mano_outputs(model, pose6d: torch.Tensor, shape: torch.Tensor,
                     cam: torch.Tensor, img_size: int = 256) -> dict:
    """The chain's output -> MANO vertices and joints and their 2D
    reprojection (`decoder_ktd.py:96-140` `get_output`). pose6d (B, 96),
    shape (B, 10), cam (B, 3) = scale, trans2d."""
    b = pose6d.shape[0]
    rotmats = rot6d_to_rotmat(pose6d.reshape(b, 16, 6))
    verts, joints = mano_forward(model, rotmats[:, 0], rotmats[:, 1:], shape, use_pca=False)
    scale, trans2d = cam[:, 0], cam[:, 1:]
    return {"verts3d": verts, "joints3d": joints,
            "joints2d": orthographic_project(scale, trans2d, joints, img_size),
            "rotmats": rotmats, "shape": shape, "scale": scale, "trans2d": trans2d}
