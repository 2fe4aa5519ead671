"""Two-hand mesh supervision (counterpart of
`renderih_tpu/losses/graph_loss.py`, itself the reference's `GraphLoss` /
`calc_loss_GCN`, `core/Loss.py:20-277`).

The same terms, weights and semantics as pure functions over the
decoder output:

  * vert2d: MSE on pixels normalized to [-1, 1] (/img_size*2-1).
  * vert3d + regressed-joint: SmoothL1 (beta=1, torch default).
  * face-normal: |cos| between predicted edges and GT face normals.
  * edge length: SmoothL1 on per-edge lengths.
  * coarse multi-level: per-stage SmoothL1/MSE against avg-pool-downsampled
    GT vertices in the GCN layout.
  * upsample-weight anchor: SmoothL1 between the learned 252->778 weight
    and its initializer.
  * camera (off at weight 0): the per-sample orthographic camera refit
    from the labels in closed form.
  * right-hand GT is shifted by `root_rel` before supervision
    (`core/Loss.py:213-214`).

`assets` is an `Assets` whose `j_reg_21`, `mano.faces`, `perm` and
`upsample_init` live on the outputs' device (`assets.assets_to`). The
aux-head losses (`aux_losses`) wait for `with_aux_heads`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from renderih_tpu_torch.graph.ops import graph_pool_avg, vert_to_gcn


class GraphLossWeights(NamedTuple):
    label_3d: float = 100.0
    label_2d: float = 50.0
    normal: float = 10.0
    edge: float = 2000.0
    norm_epoch: int = 50
    upsample: float = 1.0
    # Epoch before which the normal loss is OFF (0 = always on, the
    # reference behavior; a from-scratch divergence lever).
    normal_epoch: int = 0
    # Direct camera supervision (0 = off = reference parity).
    camera: float = 0.0


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float = 1.0) -> torch.Tensor:
    """torch.nn.SmoothL1Loss with reduction='mean'."""
    d = (pred - target).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta).mean()


def _safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False,
               eps: float = 1e-12) -> torch.Tensor:
    """sqrt(sum(x^2) + eps): well-defined gradient at ||x|| = 0.

    `torch.linalg.norm` has a NaN gradient at exactly zero, which training
    hits (coincident predicted vertices make zero-length edges); the NaN
    then poisons the whole step even through zero-weighted terms.
    """
    return torch.sqrt((x * x).sum(dim=dim, keepdim=keepdim) + eps)


def fit_orthographic_cam(v3d: torch.Tensor, v2d: torch.Tensor,
                         img_size: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample closed-form orthographic camera from consistent labels.

    Solves min_{s,t} || s*S*xy + (t*S/2 + S/2) - uv ||^2 (the projection
    of `ops/projection.orthographic_project`): the scale from the
    covariance/variance ratio of centered xy vs centered uv, trans from
    the means. v3d (B, V, 3), v2d (B, V, 2) -> (scale (B,), trans (B, 2)).
    """
    xy = v3d[..., :2]
    xym = xy - xy.mean(dim=-2, keepdim=True)
    uvm = v2d - v2d.mean(dim=-2, keepdim=True)
    s_pix = ((xym * uvm).sum(dim=(-2, -1))
             / torch.clamp((xym * xym).sum(dim=(-2, -1)), min=1e-12))
    scale = s_pix / img_size
    c = v2d.mean(dim=-2) - s_pix[..., None] * xy.mean(dim=-2)
    trans = (c - img_size / 2.0) / (img_size / 2.0)
    return scale, trans


def _face_edges(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """(..., V, 3), (F, 3) -> (..., F, 3 edges, 3) edge vectors."""
    tri = verts[..., faces, :]  # (..., F, 3, 3)
    e0 = tri[..., 0, :] - tri[..., 1, :]
    e1 = tri[..., 1, :] - tri[..., 2, :]
    e2 = tri[..., 2, :] - tri[..., 0, :]
    return torch.stack([e0, e1, e2], dim=-2)


def normal_loss(verts_pred: torch.Tensor, verts_gt: torch.Tensor,
                faces: torch.Tensor) -> torch.Tensor:
    """SmoothL1 of |cos| between predicted edges and GT face normals."""
    edge_gt = _face_edges(verts_gt, faces)
    edge_pred = _face_edges(verts_pred, faces)
    n_gt = torch.linalg.cross(edge_gt[..., 0, :], edge_gt[..., 1, :])
    n_gt = n_gt / _safe_norm(n_gt, dim=-1, keepdim=True)
    e_pred = edge_pred / _safe_norm(edge_pred, dim=-1, keepdim=True)
    cos = torch.einsum("...ed,...d->...e", e_pred, n_gt)
    return smooth_l1(cos, torch.zeros_like(cos))


def edge_length_loss(verts_pred: torch.Tensor, verts_gt: torch.Tensor,
                     faces: torch.Tensor) -> torch.Tensor:
    len_gt = _safe_norm(_face_edges(verts_gt, faces), dim=-1)
    len_pred = _safe_norm(_face_edges(verts_pred, faces), dim=-1)
    return smooth_l1(len_pred, len_gt)


def _norm2d(x: torch.Tensor, img_size: float) -> torch.Tensor:
    return x / img_size * 2.0 - 1.0


def _single_hand_loss(v3d_pred, v2d_pred, v3d_gt, v2d_gt, j_reg_21, faces,
                      img_size) -> dict:
    j_pred = torch.einsum("jv,bvc->bjc", j_reg_21, v3d_pred)
    j_gt = torch.einsum("jv,bvc->bjc", j_reg_21, v3d_gt)
    return {
        "vert2d": ((_norm2d(v2d_pred, img_size) - _norm2d(v2d_gt, img_size)) ** 2).mean(),
        "vert3d": smooth_l1(v3d_pred, v3d_gt),
        # diagnostic only (not in `total`): the 3D error in millimetres
        "vert3d_mm": 1000.0 * _safe_norm(v3d_pred - v3d_gt).mean(),
        "joint": smooth_l1(j_pred, j_gt),
        "normal": normal_loss(v3d_pred, v3d_gt, faces),
        "edge": edge_length_loss(v3d_pred, v3d_gt, faces),
    }


def _coarse_losses(coarse3d_list, coarse2d_list, v3d_gt, v2d_gt, perm,
                   img_size, num_levels: int = 5):
    """Match each predicted coarse level against pooled GT by node count."""
    v3d_gcn = vert_to_gcn(v3d_gt, perm)
    v2d_gcn = vert_to_gcn(v2d_gt, perm)
    gt3d_by_count, gt2d_by_count = {}, {}
    for level in range(num_levels):
        gt3d_by_count[v3d_gcn.shape[1]] = v3d_gcn
        gt2d_by_count[v2d_gcn.shape[1]] = v2d_gcn
        if level < num_levels - 1:
            v3d_gcn = graph_pool_avg(v3d_gcn, 2)
            v2d_gcn = graph_pool_avg(v2d_gcn, 2)
    l3d, l2d = [], []
    for p3d, p2d in zip(coarse3d_list, coarse2d_list):
        g3d = gt3d_by_count[p3d.shape[1]]
        g2d = gt2d_by_count[p2d.shape[1]]
        l3d.append(smooth_l1(p3d, g3d))
        l2d.append(((_norm2d(p2d, img_size) - _norm2d(g2d, img_size)) ** 2).mean())
    return l3d, l2d


def two_hand_graph_loss(out, batch: dict, assets, epoch: int,
                        weights: GraphLossWeights = GraphLossWeights(),
                        upsample_weight: torch.Tensor | None = None,
                        img_size: float = 256.0):
    """Total training loss + per-term dict.

    `batch` keys: 'v3d_left', 'v2d_left', 'v3d_right', 'v2d_right',
    'root_rel' (B, 3). Right-hand GT is expressed root-relative and gets
    `root_rel` added, as in `calc_loss_GCN` (`core/Loss.py:213-214`).
    """
    v3d_gt = {"left": batch["v3d_left"],
              "right": batch["v3d_right"] + batch["root_rel"][:, None, :]}
    v2d_gt = {"left": batch["v2d_left"], "right": batch["v2d_right"]}

    terms: dict = {}
    coarse3d_terms, coarse2d_terms = [], []
    for hand, hand_assets in (("left", assets.left), ("right", assets.right)):
        h = _single_hand_loss(out.verts3d[hand], out.verts2d[hand],
                              v3d_gt[hand], v2d_gt[hand], hand_assets.j_reg_21,
                              hand_assets.mano.faces, img_size)
        for k, v in h.items():
            terms[k] = terms.get(k, 0.0) + 0.5 * v
        c3d, c2d = _coarse_losses(out.coarse_verts3d[hand], out.coarse_verts2d[hand],
                                  v3d_gt[hand], v2d_gt[hand], hand_assets.perm,
                                  img_size)
        if not coarse3d_terms:
            coarse3d_terms = [0.5 * x for x in c3d]
            coarse2d_terms = [0.5 * x for x in c2d]
        else:
            coarse3d_terms = [a + 0.5 * b for a, b in zip(coarse3d_terms, c3d)]
            coarse2d_terms = [a + 0.5 * b for a, b in zip(coarse2d_terms, c2d)]

    zero = torch.zeros((), device=out.verts3d["left"].device)
    terms["upsample_norm"] = (zero if upsample_weight is None
                              else smooth_l1(upsample_weight, assets.left.upsample_init))

    if weights.camera > 0.0:
        cam = 0.0
        for hand in ("left", "right"):
            s_gt, t_gt = fit_orthographic_cam(v3d_gt[hand], v2d_gt[hand], img_size)
            cam = cam + 0.5 * (((out.scale[hand] - s_gt) ** 2).mean()
                               + ((out.trans2d[hand] - t_gt) ** 2).mean())
        terms["camera"] = cam
    else:
        terms["camera"] = zero

    # edge loss gated by epoch (reference alpha, `core/Loss.py:251`);
    # normal optionally gated too (normal_epoch)
    alpha = 0.0 if epoch < weights.norm_epoch else 1.0
    alpha_n = 0.0 if epoch < weights.normal_epoch else 1.0

    total = (weights.label_3d * terms["vert3d"]
             + weights.label_2d * terms["vert2d"]
             + weights.label_3d * terms["joint"]
             + alpha_n * weights.normal * terms["normal"]
             + alpha * weights.edge * terms["edge"]
             + weights.upsample * terms["upsample_norm"]
             + weights.camera * terms["camera"])
    for l3, l2 in zip(coarse3d_terms, coarse2d_terms):
        total = total + weights.label_3d * l3 + weights.label_2d * l2

    terms["coarse3d"] = sum(coarse3d_terms)
    terms["coarse2d"] = sum(coarse2d_terms)
    terms["total"] = total
    return total, terms
