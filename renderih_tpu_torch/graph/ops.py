"""Vertex-axis graph operations over the binary-tree layout (counterpart
of `renderih_tpu/graph/ops.py`).

Pooling of size p is a stride-p window reduce over the vertex axis and
upsampling is nearest-neighbour repetition (reference
`models/model_zoo/graph_utils.py:25-54`); the permutations convert between
mesh-vertex order and the padded GCN layout (`GCN_vert_convert`).
`cheby_conv` belongs to the `use_cheby` variant and is not ported yet.
"""

from __future__ import annotations

import torch


def graph_pool_avg(x: torch.Tensor, p: int) -> torch.Tensor:
    """Average-pool vertices in binary-tree order. x: (B, V, F) -> (B, V/p, F)."""
    if p <= 1:
        return x
    b, v, f = x.shape
    return x.reshape(b, v // p, p, f).mean(dim=2)


def graph_pool_max(x: torch.Tensor, p: int) -> torch.Tensor:
    """Max-pool vertices in binary-tree order."""
    if p <= 1:
        return x
    b, v, f = x.shape
    return x.reshape(b, v // p, p, f).amax(dim=2)


def graph_upsample(x: torch.Tensor, p: int) -> torch.Tensor:
    """Nearest-neighbour vertex upsample: each node spawns p children."""
    if p <= 1:
        return x
    return x.repeat_interleave(p, dim=1)


def vert_to_gcn(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Mesh-vertex order -> padded GCN layout. x: (B, 778, F) -> (B, N, F)."""
    return x[:, perm]


def gcn_to_vert(x: torch.Tensor, perm_reverse: torch.Tensor) -> torch.Tensor:
    """Padded GCN layout -> mesh-vertex order. x: (B, N, F) -> (B, 778, F)."""
    return x[:, perm_reverse]
