"""Offline mesh-graph coarsening (NumPy/SciPy — runs once, cached to npz).

The port's own copy of `renderih_tpu/graph/coarsen.py` (framework-free).

Algorithmic parity target: `build_graph` in the reference
(`models/model_zoo/coarsening.py:397-428`), which is itself the classic
Graclus/HEM pipeline from spectral_graph_convnets:

  faces -> symmetric binary adjacency -> `levels` rounds of Heavy Edge
  Matching (degree-sorted visit order, normalized-cut pair weight) ->
  singleton padding so every level is a perfect binary tree -> per-level
  normalized Laplacians rescaled by their largest eigenvalue -> the vertex
  permutation between mesh order and the padded GCN layout.

Determinism: visit order is `np.argsort` (stable) of node degree, exactly
as the reference, so regenerating the graph from the same faces yields the
same layout — required for checkpoint-level parity with reference models.

We also ship `load_reference_graph_pkl` so a user who has the original
`misc/graph_{left,right}.pkl` can byte-match the historical layout.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp
from scipy.sparse.linalg import eigsh


@dataclass
class GraphLevels:
    """Multi-level coarsened graph of a hand mesh.

    Attributes:
      laplacians: list of dense rescaled Laplacians, finest (padded mesh
        graph, e.g. 1008 nodes) first, coarsest (e.g. 63 nodes) last.
        Level i has 2x the nodes of level i+1.
      perm: padded-layout -> mesh-vertex index per level-0 node; entries
        >= num_verts are fake padding nodes (stored as -1).
      perm_reverse: mesh-vertex -> padded-layout index (length = padded N).
      mask: 1.0 for real vertices in the level-0 layout, 0.0 for padding.
      num_verts: number of real mesh vertices (778 for MANO).
    """

    laplacians: list = field(default_factory=list)
    perm: np.ndarray = None
    perm_reverse: np.ndarray = None
    mask: np.ndarray = None
    num_verts: int = 0

    @property
    def node_counts(self) -> list:
        return [l.shape[0] for l in self.laplacians]

    def save_npz(self, path: str) -> None:
        data = {
            "perm": self.perm,
            "perm_reverse": self.perm_reverse,
            "mask": self.mask,
            "num_verts": np.asarray(self.num_verts),
            "num_levels": np.asarray(len(self.laplacians)),
        }
        for i, lap in enumerate(self.laplacians):
            data[f"laplacian_{i}"] = lap
        np.savez(path, **data)

    @classmethod
    def load_npz(cls, path: str) -> "GraphLevels":
        data = np.load(path)
        n = int(data["num_levels"])
        return cls(
            laplacians=[data[f"laplacian_{i}"] for i in range(n)],
            perm=data["perm"],
            perm_reverse=data["perm_reverse"],
            mask=data["mask"],
            num_verts=int(data["num_verts"]),
        )


def build_adjacency(faces: np.ndarray, num_verts: int | None = None) -> sp.csr_matrix:
    """Triangle faces -> symmetric binary adjacency (float32 CSR)."""
    if num_verts is None:
        num_verts = int(faces.max()) + 1
    rows = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
    cols = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
    a = sp.coo_matrix(
        (np.ones(len(rows), np.float32), (rows, cols)), shape=(num_verts, num_verts)
    ).tocsr()
    a = a.maximum(a.T)
    a.data[:] = 1.0
    a.setdiag(0)
    a.eliminate_zeros()
    return a


def _hem_one_level(adj: sp.csr_matrix, visit_order: np.ndarray) -> np.ndarray:
    """One round of Heavy Edge Matching.

    Pair weight is the normalized-cut criterion used by Graclus (and the
    reference `HEM_one_level`, second approach): for candidate neighbor j
    of node i, w(i, j) = (2 A_ij + A_ii + A_jj) / (d_i + d_j + eps), where
    d is the (self-loop-included) degree of the *current* graph.
    """
    n = adj.shape[0]
    degree = np.asarray(adj.sum(axis=0)).ravel()
    indptr, indices, data = adj.indptr, adj.indices, adj.data

    # First stored value of each row ~ reference's vv[rowstart[...]] term.
    first_val = np.zeros(n)
    for i in range(n):
        if indptr[i] < indptr[i + 1]:
            first_val[i] = data[indptr[i]]

    marked = np.zeros(n, bool)
    cluster = np.zeros(n, np.int32)
    count = 0
    for i in visit_order:
        if marked[i]:
            continue
        marked[i] = True
        best, best_w = -1, 0.0
        for k in range(indptr[i], indptr[i + 1]):
            j = indices[k]
            if marked[j]:
                continue
            w = (2.0 * data[k] + first_val[i] + first_val[j]) / (
                degree[i] + degree[j] + 1e-9
            )
            if w > best_w:
                best_w, best = w, j
        cluster[i] = count
        if best >= 0:
            cluster[best] = count
            marked[best] = True
        count += 1
    return cluster


def _coarsen_graphs(adj: sp.csr_matrix, levels: int):
    """Repeated HEM. Returns (graphs per level, parent vectors)."""
    graphs = [adj]
    parents = []
    w = adj
    # Initial visit order: ascending degree (reference `HEM`:97-98).
    order = np.argsort(np.asarray(w.sum(axis=0)).ravel(), kind="stable")
    for _ in range(levels):
        cluster = _hem_one_level(w.tocsr(), order)
        parents.append(cluster)
        n_new = int(cluster.max()) + 1
        coo = w.tocoo()
        w = sp.csr_matrix(
            (coo.data, (cluster[coo.row], cluster[coo.col])), shape=(n_new, n_new)
        )
        w.eliminate_zeros()
        graphs.append(w)
        order = np.argsort(np.asarray(w.sum(axis=0)).ravel(), kind="stable")
    return graphs, parents


def _compute_perm(parents: list) -> list:
    """Binary-tree orderings per level (reference `compute_perm`:219-263).

    Children of coarse node i occupy slots [2i, 2i+1] at the next-finer
    level; singletons and holes are padded with fake nodes appended after
    the real ones.
    """
    indices = []
    if parents:
        m_last = int(max(parents[-1])) + 1
        indices.append(list(range(m_last)))
    for parent in parents[::-1]:
        pool = len(parent)
        layer = []
        for i in indices[-1]:
            node = list(np.where(parent == i)[0])
            assert 0 <= len(node) <= 2
            while len(node) < 2:
                node.append(pool)
                pool += 1
            layer.extend(node)
        indices.append(layer)
    return indices[::-1]


def _perm_adjacency(adj: sp.csr_matrix, order: list) -> sp.csr_matrix:
    """Pad with isolated fake nodes and permute into binary-tree order."""
    m = adj.shape[0]
    m_new = len(order)
    coo = adj.tocoo()
    perm = np.argsort(np.asarray(order))
    rows = perm[coo.row]
    cols = perm[coo.col]
    return sp.csr_matrix((coo.data, (rows, cols)), shape=(m_new, m_new))


def _normalized_laplacian(adj: sp.csr_matrix) -> sp.csr_matrix:
    d = np.asarray(adj.sum(axis=0)).ravel()
    d = d + np.spacing(np.float32(0))
    d_inv_sqrt = 1.0 / np.sqrt(d)
    dmat = sp.diags(d_inv_sqrt)
    eye = sp.identity(adj.shape[0], dtype=adj.dtype)
    return (eye - dmat @ adj @ dmat).tocsr()


def _rescale_laplacian(lap: sp.csr_matrix, lmax: float) -> sp.csr_matrix:
    eye = sp.identity(lap.shape[0], format="csr", dtype=lap.dtype)
    return (lap / (lmax / 2.0) - eye).tocsr()


def _cut_perm(perm: np.ndarray, levels: int, num_verts: int) -> np.ndarray:
    """Compact fake slots so avg-pooling sees no zero-padding holes.

    Mirrors the reference `cut_perm` (`models/model_zoo/coarsening.py:379-394`):
    within each binary block, if the first half starts with a fake node the
    block's second half is copied over it (and vice versa), so every slot
    points at a real vertex. Fake entries are -1 before compaction.
    """
    p = np.asarray(perm, np.int64).copy()
    p[p > num_verts - 1] = -1
    for level in range(levels):
        width = 2 ** (level + 1)
        blocks = p.reshape(-1, width)
        mid = width // 2
        for i in range(blocks.shape[0]):
            if blocks[i, 0] == -1:
                blocks[i, :mid] = blocks[i, mid:]
            if blocks[i, mid] == -1:
                blocks[i, mid:] = blocks[i, :mid]
        p = blocks.reshape(-1)
    return p


def build_graph_levels(faces: np.ndarray, levels: int = 4) -> GraphLevels:
    """Faces -> multi-level graph package for the dual-graph decoder.

    Laplacians are returned *finest-first* and dense (the decoder uses the
    three coarsest — 63/126/252 nodes for MANO, 61/122/244 for the
    synthetic mesh — as dense matmuls). Note the reference rescales only the first `levels` Laplacians
    (`build_graph`:413-415); we rescale all of them, which only affects the
    (unused) coarsest-level spectral range, and record lmax per level.
    """
    num_verts = int(faces.max()) + 1
    adj = build_adjacency(faces, num_verts)
    graphs, parents = _coarsen_graphs(adj, levels)
    perms = _compute_perm(parents)

    laplacians = []
    for i, g in enumerate(graphs):
        a = _perm_adjacency(g, perms[i]) if i < levels else g.tocsr()
        a.eliminate_zeros()
        lap = _normalized_laplacian(a)
        lmax = float(eigsh(lap, k=1, which="LM", return_eigenvectors=False)[0])
        laplacians.append(np.asarray(_rescale_laplacian(lap, lmax).todense(), np.float32))

    perm0 = np.asarray(perms[0], np.int64)
    mask = (perm0 < num_verts).astype(np.float32)
    perm_reverse = np.zeros(len(perm0), np.int64)
    for slot, vert in enumerate(perm0):
        perm_reverse[vert] = slot
    perm_cut = _cut_perm(perm0, levels, num_verts)
    assert (perm_cut >= 0).all(), "cut_perm left unresolved fake slots"

    return GraphLevels(
        laplacians=laplacians,
        perm=perm_cut,
        perm_reverse=perm_reverse[:num_verts],
        mask=mask,
        num_verts=num_verts,
    )


def load_reference_graph_pkl(path: str) -> GraphLevels:
    """Load a reference `misc/graph_{left,right}.pkl` for layout parity.

    The pickle layout is documented at `models/model_zoo/coarsening.py:420-426`.
    """
    with open(path, "rb") as f:
        d = pickle.load(f)
    laps = [np.asarray(l.todense(), np.float32) for l in d["coarsen_graphs_L"]]
    perm = np.asarray(d["graph_perm"], np.int64)
    perm_reverse = np.asarray(d["graph_perm_reverse"], np.int64)
    num_verts = int(np.asarray(d["mesh_faces"]).max()) + 1
    return GraphLevels(
        laplacians=laps,
        perm=perm,
        perm_reverse=perm_reverse[:num_verts],
        mask=np.asarray(d["graph_mask"], np.float32),
        num_verts=num_verts,
    )
