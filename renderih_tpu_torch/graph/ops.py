"""Vertex-axis graph operations over the binary-tree layout (counterpart
of `renderih_tpu/graph/ops.py`).

`cheby_conv` is the K-order Chebyshev graph convolution of the
`use_cheby` decoder on a dense rescaled Laplacian (reference
`models/model_zoo/graph_utils.py:57-92`); its L.x products are plain
matmuls, as in the JAX package. Pooling of size p is a stride-p window
reduce over the vertex axis and upsampling is nearest-neighbour repetition
(`graph_utils.py:25-54`); the permutations convert between mesh-vertex
order and the padded GCN layout (`GCN_vert_convert`).
"""

from __future__ import annotations

import torch


def cheby_basis(x: torch.Tensor, laplacian: torch.Tensor, k: int = 2) -> torch.Tensor:
    """The K Chebyshev bases T_k(L) x of x (..., V, F), interleaved as the
    reference lays them out (`graph_utils.py:84-89`): x[..., f, k]
    flattened to (..., V, F * K). `laplacian` (V, V), rescaled to the
    spectrum [-1, 1]."""
    bases = [x]
    if k > 1:
        x0, x1 = x, laplacian @ x
        bases.append(x1)
        for _ in range(2, k):
            x0, x1 = x1, 2.0 * (laplacian @ x1) - x0
            bases.append(x1)
    return torch.stack(bases, dim=-1).flatten(-2)


def cheby_conv(x: torch.Tensor, laplacian: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor | None = None, k: int = 2) -> torch.Tensor:
    """K-order Chebyshev graph convolution: x (B, V, Fin), laplacian (V, V),
    weight (Fin * K, Fout), bias (Fout,) -> (B, V, Fout). The decoder's
    blocks hold the weight as a `Linear` (upstream's `fc1`, (Fout, Fin * K))
    applied to `cheby_basis`."""
    out = cheby_basis(x, laplacian, k) @ weight
    return out if bias is None else out + bias


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
