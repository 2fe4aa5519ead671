"""Runtime asset bundle as torch tensors: MANO, coarsened graphs, constants.

Counterpart of `renderih_tpu/assets.py`: per-hand MANO models, graph
levels, the positional-encoding colors, the 778 x V_out upsampling
initializer and the 21-joint regressor, built from converted real assets
(`load_assets`) or deterministically synthetic (`make_synthetic_assets`).
Every tensor lives on the CPU; the model copies what it needs to its
device.

The synthetic mesh coarsens to 61/122/244 nodes (real MANO: 63/126/252);
nothing here assumes either.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from renderih_tpu_torch.config import AssetConfig
from renderih_tpu_torch.graph.coarsen import GraphLevels, build_graph_levels
from renderih_tpu_torch.mano.params import (
    ManoModel,
    fix_left_shapedirs,
    joint_regressor_21,
    load_mano_npz,
    make_synthetic_mano,
)


@dataclass(frozen=True)
class HandAssets:
    mano: ManoModel
    graph: GraphLevels
    # (V_coarse, 3) dense-color positional encoding at the coarsest level,
    # mapped to [-1, 1] (reference `get_hand_pe`).
    pe: torch.Tensor
    # (778, V_out) upsampling weight initializer (reference misc/upsample.pkl).
    upsample_init: torch.Tensor
    # (21, 778) joint regressor.
    j_reg_21: torch.Tensor
    # GCN layout -> vertex id (compacted), and vertex id -> GCN slot.
    perm: torch.Tensor
    perm_reverse: torch.Tensor

    @property
    def verts_nums(self) -> tuple:
        counts = self.graph.node_counts
        return (counts[-1], counts[-2], counts[-3])


@dataclass(frozen=True)
class Assets:
    left: HandAssets
    right: HandAssets


def _dense_color_from_template(mano: ManoModel) -> np.ndarray:
    """Synthetic stand-in for misc/v_color.pkl: template coords in [0, 1]."""
    v = mano.v_template.numpy()
    lo, hi = v.min(axis=0), v.max(axis=0)
    return (v - lo) / (hi - lo + 1e-9)


def _coarse_pe(dense_color: np.ndarray, graph: GraphLevels) -> np.ndarray:
    """vert_to_GCN + average-pool the [0,1] colors down to the coarsest
    level, after the [-1, 1] remap (reference `get_hand_pe`)."""
    x = dense_color * 2.0 - 1.0
    gcn = x[graph.perm]  # (N0, 3)
    n_coarse = graph.node_counts[-1]
    p = gcn.shape[0] // n_coarse
    return gcn.reshape(n_coarse, p, 3).mean(axis=1)


def _upsample_from_graph(graph: GraphLevels) -> np.ndarray:
    """Synthetic V_out -> 778 upsampling init from the coarsening tree:
    W[v, n] = 1 where vertex v's level-0 slot folds into coarse node n."""
    n0 = graph.node_counts[0]
    n_out = graph.node_counts[-3]
    p = n0 // n_out
    w = np.zeros((graph.num_verts, n_out), np.float32)
    for v in range(graph.num_verts):
        w[v, graph.perm_reverse[v] // p] = 1.0
    return w


def _build_hand(mano: ManoModel, graph: GraphLevels,
                dense_color: np.ndarray | None = None,
                upsample: np.ndarray | None = None) -> HandAssets:
    if dense_color is None:
        dense_color = _dense_color_from_template(mano)
    if upsample is None:
        upsample = _upsample_from_graph(graph)
    return HandAssets(
        mano=mano,
        graph=graph,
        pe=torch.from_numpy(np.asarray(_coarse_pe(dense_color, graph), np.float32)),
        upsample_init=torch.from_numpy(np.asarray(upsample, np.float32)),
        j_reg_21=joint_regressor_21(mano.J_regressor),
        perm=torch.from_numpy(np.asarray(graph.perm, np.int64)),
        perm_reverse=torch.from_numpy(np.asarray(graph.perm_reverse, np.int64)),
    )


def make_synthetic_assets(seed: int = 0) -> Assets:
    """Deterministic full asset bundle (tests / smoke runs)."""
    right = make_synthetic_mano(seed=seed, is_right=True)
    left = make_synthetic_mano(seed=seed, is_right=False)
    g_right = build_graph_levels(right.faces.numpy(), levels=4)
    g_left = build_graph_levels(left.faces.numpy(), levels=4)
    return Assets(left=_build_hand(left, g_left), right=_build_hand(right, g_right))


def load_assets(cfg: AssetConfig) -> Assets:
    """Load converted real assets; synthetic when the MANO paths are empty."""
    if not cfg.mano_left or not cfg.mano_right:
        return make_synthetic_assets()
    left = load_mano_npz(cfg.mano_left, is_right=False)
    right = load_mano_npz(cfg.mano_right, is_right=True)
    left = fix_left_shapedirs(left, right)

    if cfg.graph_left and cfg.graph_right:
        g_left = GraphLevels.load_npz(cfg.graph_left)
        g_right = GraphLevels.load_npz(cfg.graph_right)
    else:
        g_left = build_graph_levels(left.faces.numpy(), levels=4)
        g_right = build_graph_levels(right.faces.numpy(), levels=4)

    dense = np.load(cfg.dense_color)["color"] if cfg.dense_color else None
    upsample = np.load(cfg.upsample)["weight"] if cfg.upsample else None
    return Assets(
        left=_build_hand(left, g_left, dense, upsample),
        right=_build_hand(right, g_right, dense, upsample),
    )
