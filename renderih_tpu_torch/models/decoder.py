"""Two-hand graph decoder head (counterpart of `renderih_tpu/models/decoder.py`).

Global feature -> per-hand vertex tokens -> DualGraph trunk -> coarse 3D
verts -> learned V_out -> 778 upsample -> orthographic projection, plus
per-hand camera (scale, trans2d) heads (`decoder_lijun_graph.py:151-320`).
Names follow the upstream state_dict: `gf_layer_left.{0,1}`, `dual_gcn.*`,
`coord_head`, `avg_head`, `params_head`, `unsample_layer.weight` (sic).
With `decoder="mano"` the MANO-parameter head `param_regressor` runs on
each hand's final vertices (`decoder_lijun_newgraph.py`); its names are
the JAX module's (no upstream checkpoint carries it). The trunk's
variant `use_cheby` is `models/dual_graph.py`'s.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from renderih_tpu_torch.models.dual_graph import DualGraph
from renderih_tpu_torch.models.layers import LayerNorm, Linear
from renderih_tpu_torch.ops.projection import orthographic_project


class DecoderOutput(NamedTuple):
    verts3d: dict          # {'left','right'}: (B, 778, 3)
    verts2d: dict          # {'left','right'}: (B, 778, 2)
    scale: dict            # {'left','right'}: (B,)
    trans2d: dict          # {'left','right'}: (B, 2)
    coarse_verts3d: dict   # {'left','right'}: list[(B, V_out, 3)]
    coarse_verts2d: dict   # projections of the above
    mano_pose: dict | None = None   # {'left','right'}: (B, 96), 16 x 6D (decoder="mano")
    mano_shape: dict | None = None  # {'left','right'}: (B, 10)
    aux: dict | None = None         # {'hms','mask','dense'} (HandNet's aux heads)


class ParamRegressor(nn.Module):
    """778x3 coordinates -> MANO pose (16 x 6D rotations) and shape (10):
    Linear 1024, Linear 512, then a pose branch (`pose_fc1` 128, `pose_fc2`
    96) and a shape branch (`shape_fc1` 128, `shape_fc2` 10), hard-swish
    after every layer but the two last (`ParamRegressor`,
    `decoder_lijun_graph.py:117-149`). The 6D -> matrix conversion is the
    loss's. `dense.{0,1}` are the JAX module's `Dense_0`/`Dense_1`."""

    def __init__(self, num_verts: int = 778):
        super().__init__()
        self.dense = nn.ModuleList([Linear(num_verts * 3, 1024), Linear(1024, 512)])
        self.pose_fc1 = Linear(512, 128)
        self.pose_fc2 = Linear(128, 16 * 6)
        self.shape_fc1 = Linear(512, 128)
        self.shape_fc2 = Linear(128, 10)

    def forward(self, verts: torch.Tensor):
        h = verts.reshape(verts.shape[0], -1)
        for layer in self.dense:
            h = F.hardswish(layer(h))
        pose6d = self.pose_fc2(F.hardswish(self.pose_fc1(h)))
        shape = self.shape_fc2(F.hardswish(self.shape_fc1(h)))
        return pose6d, shape


class GraphDecoder(nn.Module):
    """The full decoder head; the PE tokens come in through `forward`."""

    def __init__(self, verts_nums: tuple, global_dim: int, img_dims: tuple,
                 gcn_in_dims: tuple = (512, 256, 128),
                 gcn_out_dims: tuple = (256, 128, 64),
                 img_sizes: tuple = (8, 16, 32),
                 grid_f_dims: tuple = (256, 128, 64), grid_size: int = 8,
                 graph_layer_num: int = 4, n_heads: int = 4,
                 dropout: float = 0.05, num_verts: int = 778,
                 img_size: int = 256, bbox_dim: int = 0,
                 with_mano_head: bool = False, dtype: torch.dtype = torch.float32,
                 use_cheby: bool = False, graph_k: int = 2,
                 laplacians: tuple | None = None):
        super().__init__()
        self.verts_nums = tuple(verts_nums)
        self.img_size = img_size
        self.dtype = dtype
        fin = global_dim + bbox_dim
        self.gf_layer_left = nn.Sequential(
            Linear(fin, gcn_in_dims[0] - 3), LayerNorm(gcn_in_dims[0] - 3, eps=1e-6))
        self.gf_layer_right = nn.Sequential(
            Linear(fin, gcn_in_dims[0] - 3), LayerNorm(gcn_in_dims[0] - 3, eps=1e-6))
        self.dual_gcn = DualGraph(
            self.verts_nums, tuple(gcn_in_dims), tuple(gcn_out_dims),
            tuple(img_sizes), tuple(img_dims), tuple(grid_f_dims), grid_size,
            graph_layer_num, n_heads, dropout, dtype, use_cheby, graph_k, laplacians)
        c_out = gcn_out_dims[-1]
        # camera heads shared across hands (`decoder_lijun_graph.py:221-223`)
        self.avg_head = Linear(self.verts_nums[-1], 1)
        self.params_head = Linear(c_out, 3)
        self.coord_head = Linear(c_out, 3)
        self.unsample_layer = Linear(self.verts_nums[-1], num_verts, bias=False)
        self.param_regressor = ParamRegressor(num_verts) if with_mano_head else None

    def _tokens(self, gf_layer: nn.Module, global_feature: torch.Tensor,
                pe: torch.Tensor) -> torch.Tensor:
        h = gf_layer(global_feature.to(self.dtype))
        bs, v_in = h.shape[0], self.verts_nums[0]
        return torch.cat([h[:, None].expand(bs, v_in, h.shape[-1]),
                          pe[None].to(h.dtype).expand(bs, v_in, 3)], dim=-1)

    def _camera(self, feat: torch.Tensor):
        # avg_head pools over the VERTEX axis (`decoder.py:161-163`)
        pooled = self.avg_head(feat.transpose(-1, -2))[..., 0]  # (B, C)
        p = self.params_head(pooled)
        return p[:, 0], p[:, 1:]

    def forward(self, global_feature: torch.Tensor, fmaps: list,
                pe_left: torch.Tensor, pe_right: torch.Tensor,
                bbox_info: torch.Tensor | None = None) -> DecoderOutput:
        if bbox_info is not None:
            # CLIFF-style conditioning (`common/myhand/bbox_decoder.py`)
            global_feature = torch.cat(
                [global_feature, bbox_info.to(global_feature.dtype)], -1)
        lf = self._tokens(self.gf_layer_left, global_feature, pe_left)
        rf = self._tokens(self.gf_layer_right, global_feature, pe_right)
        lf, rf, _ = self.dual_gcn(lf, rf, fmaps[: len(self.verts_nums)])
        # heads run in f32 whatever the trunk dtype (`decoder.py:144-147`)
        feats = {"left": lf.float(), "right": rf.float()}

        scale, trans2d, verts3d, verts2d = {}, {}, {}, {}
        coarse3d, coarse2d = {}, {}
        for hand, feat in feats.items():
            scale[hand], trans2d[hand] = self._camera(feat)
            coarse = self.coord_head(feat)
            coarse3d[hand] = [coarse]
            coarse2d[hand] = [orthographic_project(
                scale[hand], trans2d[hand], coarse, self.img_size)]
            verts3d[hand] = self.unsample_layer(
                coarse.transpose(1, 2)).transpose(1, 2)
            verts2d[hand] = orthographic_project(
                scale[hand], trans2d[hand], verts3d[hand], self.img_size)
        mano_pose = mano_shape = None
        if self.param_regressor is not None:
            mano_pose, mano_shape = {}, {}
            for hand in feats:
                mano_pose[hand], mano_shape[hand] = self.param_regressor(verts3d[hand])
        return DecoderOutput(verts3d=verts3d, verts2d=verts2d, scale=scale,
                             trans2d=trans2d, coarse_verts3d=coarse3d,
                             coarse_verts2d=coarse2d, mano_pose=mano_pose,
                             mano_shape=mano_shape)
