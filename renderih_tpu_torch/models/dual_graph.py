"""Dual-graph coarse-to-fine decoder trunk (counterpart of
`renderih_tpu/models/dual_graph.py`, MLP flavour).

Three stages of per-hand vertex processing (61 -> 122 -> 244 nodes on the
synthetic mesh, 63 -> 126 -> 252 on MANO): positional embedding +
GraphLayer (residual MLP blocks) + image cross attention + cross-hand
attention, with nearest-neighbour vertex upsampling between stages
(`common/myhand/model_attn/DualGraph_lijun.py:89-207`). Names follow the
upstream state_dict: `layers.{i}.graph_left.GCN_blocks.{j}.*`,
`layers.{i}.img_ex_left.*`, `layers.{i}.attn.*`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from renderih_tpu_torch.graph.ops import graph_upsample
from renderih_tpu_torch.models.attention import ImgEx, InterAttn
from renderih_tpu_torch.models.layers import Linear
from renderih_tpu_torch.ops.dropout import dropout

_LN_EPS = 1e-6


class GcnResBlock(nn.Module):
    """Residual vertex block, MLP flavour: the Laplacian is unused
    (`DualGraph_lijun.py:28-58`)."""

    def __init__(self, in_dim: int, out_dim: int, dropout: float = 0.01):
        super().__init__()
        self.norm1 = nn.LayerNorm(in_dim, eps=_LN_EPS)
        self.fc1 = Linear(in_dim, out_dim)
        self.norm2 = nn.LayerNorm(out_dim, eps=_LN_EPS)
        self.fc2 = Linear(out_dim, out_dim)
        self.shortcut = Linear(in_dim, out_dim)
        self.norm3 = nn.LayerNorm(out_dim, eps=_LN_EPS)
        self.dropout = dropout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(F.relu(self.norm1(x)))
        h = self.fc2(F.relu(self.norm2(h)))
        h = dropout(h, self.dropout, self.training)
        return self.norm3(h + self.shortcut(x))


class GraphLayer(nn.Module):
    """Stack of residual vertex blocks with inter-block ReLU."""

    def __init__(self, in_dim: int, out_dim: int, num_blocks: int = 4,
                 dropout: float = 0.01):
        super().__init__()
        self.GCN_blocks = nn.ModuleList(
            GcnResBlock(in_dim if i == 0 else out_dim, out_dim, dropout)
            for i in range(num_blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        last = len(self.GCN_blocks) - 1
        for i, block in enumerate(self.GCN_blocks):
            x = block(x)
            if i != last:
                x = F.relu(x)
        return x


class DualGraphLayer(nn.Module):
    """One decoder stage: PE + per-hand GraphLayer + img attn + inter attn."""

    def __init__(self, verts_num: int, verts_in_dim: int, verts_out_dim: int,
                 num_blocks: int, img_size: int, grid_size: int, img_dim: int,
                 grid_f_dim: int, n_heads: int = 4, dropout: float = 0.01,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.verts_num = verts_num
        self.dtype = dtype
        self.position_embeddings = nn.Embedding(verts_num, verts_in_dim)
        self.graph_left = GraphLayer(verts_in_dim, verts_out_dim, num_blocks, dropout)
        self.graph_right = GraphLayer(verts_in_dim, verts_out_dim, num_blocks, dropout)
        args = (img_size, grid_size, img_dim, grid_f_dim, verts_out_dim,
                n_heads, dropout)
        self.img_ex_left = ImgEx(*args)
        self.img_ex_right = ImgEx(*args)
        self.attn = InterAttn(verts_out_dim, n_heads, dropout)

    def forward(self, lf: torch.Tensor, rf: torch.Tensor, img_f: torch.Tensor):
        if lf.shape[1] != self.verts_num or rf.shape[1] != self.verts_num:
            raise ValueError(f"expected {self.verts_num} vertex tokens, got "
                             f"{lf.shape[1]} and {rf.shape[1]}")
        pos = self.position_embeddings.weight
        lf = (lf + pos).to(self.dtype)
        rf = (rf + pos).to(self.dtype)
        img_f = img_f.to(self.dtype)
        lf = self.img_ex_left(img_f, self.graph_left(lf))
        rf = self.img_ex_right(img_f, self.graph_right(rf))
        return self.attn(lf, rf)


class DualGraph(nn.Module):
    """The 3-stage trunk with x2 vertex upsampling between stages."""

    def __init__(self, verts_nums: tuple, verts_in_dims: tuple,
                 verts_out_dims: tuple, img_sizes: tuple, img_dims: tuple,
                 grid_f_dims: tuple, grid_size: int = 8, num_blocks: int = 4,
                 n_heads: int = 4, dropout: float = 0.01,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers = nn.ModuleList(
            DualGraphLayer(verts_nums[i], verts_in_dims[i], verts_out_dims[i],
                           num_blocks, img_sizes[i], grid_size, img_dims[i],
                           grid_f_dims[i], n_heads, dropout, dtype)
            for i in range(len(verts_in_dims)))

    def forward(self, lf: torch.Tensor, rf: torch.Tensor, img_f_list: list):
        if len(img_f_list) != len(self.layers):
            raise ValueError(f"{len(self.layers)} stages need as many feature "
                             f"maps, got {len(img_f_list)}")
        outs = []
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            lf, rf = layer(lf, rf, img_f_list[i])
            outs.append((lf, rf))
            if i != last:
                lf = graph_upsample(lf, 2)
                rf = graph_upsample(rf, 2)
        return lf, rf, outs
