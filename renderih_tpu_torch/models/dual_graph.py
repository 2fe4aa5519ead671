"""Dual-graph coarse-to-fine decoder trunk (counterpart of
`renderih_tpu/models/dual_graph.py`).

Three stages of per-hand vertex processing (61 -> 122 -> 244 nodes on the
synthetic mesh, 63 -> 126 -> 252 on MANO): positional embedding +
GraphLayer (residual blocks) + image cross attention + cross-hand
attention, with nearest-neighbour vertex upsampling between stages
(`common/myhand/model_attn/DualGraph_lijun.py:89-207`). Names follow the
upstream state_dict: `layers.{i}.graph_left.GCN_blocks.{j}.*`,
`layers.{i}.img_ex_left.*`, `layers.{i}.attn.*`.

Two block flavours (`use_cheby`): MLP residual blocks (the flagship,
`DualGraph_lijun.py:28-58`; no Laplacian) and Chebyshev graph-conv blocks
(`common/myhand/model_attn/gcn.py:72-110`), which read each stage's
Laplacians [left, right] from a buffer of the stage (not in the
state_dict: they come from the assets).

`model.paired_lr` builds this same trunk: the JAX package's hand-stacked
trunk computes the same function, and its parameters load through
`utils/weights.py`, which unstacks them into the upstream keys.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from renderih_tpu_torch.graph.ops import cheby_basis, graph_upsample
from renderih_tpu_torch.models.attention import ImgEx, InterAttn
from renderih_tpu_torch.models.layers import LayerNorm, Linear
from renderih_tpu_torch.ops.dropout import dropout

_LN_EPS = 1e-6


class GcnResBlock(nn.Module):
    """Residual vertex block. MLP flavour: fc1/fc2 on relu(LN(x)); the
    Laplacian is unused. Chebyshev flavour: fc1 (in * K -> out) and fc2
    (out * K -> out) on the Chebyshev bases, upstream's `fc1`/`fc2`.

    Reference quirk of the Chebyshev flavour (`gcn.py:103-104`): norm1 is
    built, and its output is dropped; the first conv sees the raw x. The
    JAX package computes it and XLA drops it as dead code; here it is not
    computed. norm1 is kept for the checkpoint layout, and no gradient
    reaches it (the train step gives it a zero gradient, so that AdamW
    decays it as optax does)."""

    def __init__(self, in_dim: int, out_dim: int, dropout: float = 0.01,
                 use_cheby: bool = False, graph_k: int = 2):
        super().__init__()
        self.use_cheby = use_cheby
        self.k = graph_k
        k = graph_k if use_cheby else 1
        self.norm1 = LayerNorm(in_dim, eps=_LN_EPS)
        self.fc1 = Linear(in_dim * k, out_dim)
        self.norm2 = LayerNorm(out_dim, eps=_LN_EPS)
        self.fc2 = Linear(out_dim * k, out_dim)
        self.shortcut = Linear(in_dim, out_dim)
        self.norm3 = LayerNorm(out_dim, eps=_LN_EPS)
        self.dropout = dropout

    def forward(self, x: torch.Tensor, laplacian: torch.Tensor | None = None) -> torch.Tensor:
        if self.use_cheby:
            h = self.fc1(cheby_basis(x, laplacian, self.k))
            h = self.fc2(cheby_basis(F.relu(self.norm2(h)), laplacian, self.k))
        else:
            h = self.fc1(F.relu(self.norm1(x)))
            h = self.fc2(F.relu(self.norm2(h)))
        h = dropout(h, self.dropout, self.training)
        return self.norm3(h + self.shortcut(x))


class GraphLayer(nn.Module):
    """Stack of residual vertex blocks with inter-block ReLU."""

    def __init__(self, in_dim: int, out_dim: int, num_blocks: int = 4,
                 dropout: float = 0.01, use_cheby: bool = False, graph_k: int = 2):
        super().__init__()
        self.GCN_blocks = nn.ModuleList(
            GcnResBlock(in_dim if i == 0 else out_dim, out_dim, dropout, use_cheby,
                        graph_k)
            for i in range(num_blocks))

    def forward(self, x: torch.Tensor, laplacian: torch.Tensor | None = None) -> torch.Tensor:
        last = len(self.GCN_blocks) - 1
        for i, block in enumerate(self.GCN_blocks):
            x = block(x, laplacian)
            if i != last:
                x = F.relu(x)
        return x


class DualGraphLayer(nn.Module):
    """One decoder stage: PE + per-hand GraphLayer + img attn + inter attn.
    `laplacians` ((V, V) left, (V, V) right) for the Chebyshev blocks."""

    def __init__(self, verts_num: int, verts_in_dim: int, verts_out_dim: int,
                 num_blocks: int, img_size: int, grid_size: int, img_dim: int,
                 grid_f_dim: int, n_heads: int = 4, dropout: float = 0.01,
                 dtype: torch.dtype = torch.float32, use_cheby: bool = False,
                 graph_k: int = 2, laplacians: tuple | None = None):
        super().__init__()
        self.verts_num = verts_num
        self.dtype = dtype
        self.position_embeddings = nn.Embedding(verts_num, verts_in_dim)
        graph = lambda: GraphLayer(verts_in_dim, verts_out_dim, num_blocks, dropout,
                                   use_cheby, graph_k)
        self.graph_left, self.graph_right = graph(), graph()
        args = (img_size, grid_size, img_dim, grid_f_dim, verts_out_dim,
                n_heads, dropout)
        self.img_ex_left = ImgEx(*args)
        self.img_ex_right = ImgEx(*args)
        self.attn = InterAttn(verts_out_dim, n_heads, dropout)
        if not use_cheby:
            self.laplacian = None
        else:
            if laplacians is None or any(lap.shape != (verts_num, verts_num)
                                         for lap in laplacians):
                raise ValueError(f"use_cheby needs a ({verts_num}, {verts_num}) "
                                 "Laplacian a hand for this stage")
            # filled by copy, so that a model built on the meta device has one
            self.register_buffer("laplacian", torch.empty(2, verts_num, verts_num),
                                 persistent=False)
            with torch.no_grad():
                self.laplacian.copy_(torch.stack(list(laplacians)))

    def forward(self, lf: torch.Tensor, rf: torch.Tensor, img_f: torch.Tensor):
        if lf.shape[1] != self.verts_num or rf.shape[1] != self.verts_num:
            raise ValueError(f"expected {self.verts_num} vertex tokens, got "
                             f"{lf.shape[1]} and {rf.shape[1]}")
        pos = self.position_embeddings.weight
        lf = (lf + pos).to(self.dtype)
        rf = (rf + pos).to(self.dtype)
        img_f = img_f.to(self.dtype)
        lap_l = lap_r = None
        if self.laplacian is not None:
            lap_l, lap_r = self.laplacian.to(self.dtype).unbind(0)
        lf = self.img_ex_left(img_f, self.graph_left(lf, lap_l))
        rf = self.img_ex_right(img_f, self.graph_right(rf, lap_r))
        return self.attn(lf, rf)


class DualGraph(nn.Module):
    """The 3-stage trunk with x2 vertex upsampling between stages.
    `laplacians`: (left, right), each one Laplacian a stage, coarsest
    first (`assets.HandAssets.laplacians_coarse`), for `use_cheby`."""

    def __init__(self, verts_nums: tuple, verts_in_dims: tuple,
                 verts_out_dims: tuple, img_sizes: tuple, img_dims: tuple,
                 grid_f_dims: tuple, grid_size: int = 8, num_blocks: int = 4,
                 n_heads: int = 4, dropout: float = 0.01,
                 dtype: torch.dtype = torch.float32, use_cheby: bool = False,
                 graph_k: int = 2, laplacians: tuple | None = None):
        super().__init__()
        self.layers = nn.ModuleList(
            DualGraphLayer(verts_nums[i], verts_in_dims[i], verts_out_dims[i],
                           num_blocks, img_sizes[i], grid_size, img_dims[i],
                           grid_f_dims[i], n_heads, dropout, dtype, use_cheby, graph_k,
                           None if laplacians is None else (laplacians[0][i], laplacians[1][i]))
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
