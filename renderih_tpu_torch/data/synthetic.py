"""Synthetic, geometrically consistent training batches (counterpart of
`renderih_tpu/data/synthetic.py`).

Random MANO poses and cameras give batches whose labels are
self-consistent (verts2d are the projection of verts3d under the sampled
camera). Label semantics match the runtime loader (`core/loader.py:
180-219`): 3D labels root-relative (root = joint 9), bone-rescaled to
`bone_length`; `root_rel` is the right-to-left root offset.

`synthetic_draws` makes the random draws from a `torch.Generator` and
`synthetic_from_draws` turns them into a batch, so a caller can feed any
draws; `synthetic_batch` is the two in one. `synthetic_aux_targets` (and
`with_aux=True`) adds the aux heads' targets: joint heatmaps, silhouettes
and densepose renders consistent with the labels.
"""

from __future__ import annotations

import math

import torch

from renderih_tpu_torch.assets import _dense_color_from_template
from renderih_tpu_torch.mano.layer import mano_forward
from renderih_tpu_torch.ops.heatmap import joint_heatmap_targets
from renderih_tpu_torch.ops.projection import orthographic_project
from renderih_tpu_torch.ops.rotation import rodrigues
from renderih_tpu_torch.render.rasterize import pick_row_block, rasterize_orthographic


def _uniform(gen, shape, low: float, high: float) -> torch.Tensor:
    return low + (high - low) * torch.rand(shape, generator=gen, device=gen.device)


def _normal(gen, shape, std: float = 1.0) -> torch.Tensor:
    return std * torch.randn(shape, generator=gen, device=gen.device)


def synthetic_draws(gen: torch.Generator, batch_size: int = 8, img_size: int = 256,
                    with_img: bool = True, scene: bool = False) -> dict:
    """The random draws of `synthetic_batch`, scaled as they are used:
    per hand (suffix _left/_right) root axis-angle N(0, 0.5²) (B, 3), PCA
    pose N(0, 0.3²) (B, 45), shape N(0, 0.5²) (B, 10), camera scale
    U[0.8, 1.5) (B,) and trans2d U[-0.3, 0.3) (B, 2); root_rel N(0, 0.05²)
    (B, 3). With `scene`: phi U[0, 2π), rad U[0.07, 0.18), z N(0, 1) (B,),
    fill U[0.6, 0.9) (B,) and jitter U[-0.05, 0.05) (B, 2). With
    `with_img`: img N(0, 1) (B, S, S, 3)."""
    b = batch_size
    d = {}
    for hand in ("left", "right"):
        d[f"root_{hand}"] = _normal(gen, (b, 3), 0.5)
        d[f"pose_{hand}"] = _normal(gen, (b, 45), 0.3)
        d[f"shape_{hand}"] = _normal(gen, (b, 10), 0.5)
        d[f"scale_{hand}"] = _uniform(gen, (b,), 0.8, 1.5)
        d[f"trans_{hand}"] = _uniform(gen, (b, 2), -0.3, 0.3)
    d["root_rel"] = _normal(gen, (b, 3), 0.05)
    if scene:
        d["phi"] = _uniform(gen, (b,), 0.0, 2 * math.pi)
        d["rad"] = _uniform(gen, (b,), 0.07, 0.18)
        d["z"] = _normal(gen, (b,))
        d["fill"] = _uniform(gen, (b,), 0.60, 0.90)
        d["jitter"] = _uniform(gen, (b, 2), -0.05, 0.05)
    if with_img:
        d["img"] = _normal(gen, (b, img_size, img_size, 3))
    return d


def synthetic_from_draws(assets, draws: dict, img_size: int = 256,
                         bone_length: float = 0.095, with_cam: bool = False,
                         scene: bool = False, with_aux: bool = False) -> dict:
    """The batch of `synthetic_batch` from its draws (see there)."""
    def hand(model, side):
        root = rodrigues(draws[f"root_{side}"])
        v, j = mano_forward(model, root, draws[f"pose_{side}"], draws[f"shape_{side}"],
                            center_idx=9)
        # bone-length normalize: |j9 - j0| -> bone_length
        length = torch.linalg.vector_norm(j[:, 9] - j[:, 0], dim=-1, keepdim=True)
        s = bone_length / (length + 1e-9)
        v = v * s[:, :, None]
        j = j * s[:, :, None]
        scale, trans2d = draws[f"scale_{side}"], draws[f"trans_{side}"]
        return (v, j, orthographic_project(scale, trans2d, v, img_size),
                orthographic_project(scale, trans2d, j, img_size), scale, trans2d)

    v3d_l, j3d_l, v2d_l, j2d_l, sc_l, tr_l = hand(assets.left.mano, "left")
    v3d_r, j3d_r, v2d_r, j2d_r, sc_r, tr_r = hand(assets.right.mano, "right")
    root_rel = draws["root_rel"]

    if scene:
        # the right hand 7-18 cm from the left, mostly in the image plane
        phi, rad = draws["phi"], draws["rad"]
        root_rel = torch.stack([rad * torch.cos(phi), rad * torch.sin(phi),
                                0.02 * draws["z"]], dim=-1)
        v3d_r = v3d_r + root_rel[:, None, :]
        j3d_r = j3d_r + root_rel[:, None, :]
        # one shared camera: the two-hand box fills `fill` of the frame
        xy = torch.cat([v3d_l, v3d_r], dim=1)[..., :2]
        mn, mx = xy.amin(dim=1), xy.amax(dim=1)
        center = 0.5 * (mn + mx)
        half_ext = torch.clamp(0.5 * (mx - mn).amax(dim=-1), min=1e-6)
        sc = draws["fill"] / (2.0 * half_ext)
        tr = -2.0 * sc[:, None] * center + draws["jitter"]
        sc_l = sc_r = sc
        tr_l = tr_r = tr
        v2d_l = orthographic_project(sc, tr, v3d_l, img_size)
        j2d_l = orthographic_project(sc, tr, j3d_l, img_size)
        v2d_r = orthographic_project(sc, tr, v3d_r, img_size)
        j2d_r = orthographic_project(sc, tr, j3d_r, img_size)

    batch = {"v3d_left": v3d_l, "j3d_left": j3d_l, "v2d_left": v2d_l, "j2d_left": j2d_l,
             "v3d_right": v3d_r, "j3d_right": j3d_r, "v2d_right": v2d_r,
             "j2d_right": j2d_r, "root_rel": root_rel}
    if "img" in draws:
        batch["img"] = draws["img"]
    if with_cam:
        # the generating cameras, for rendering images consistent with the
        # labels (never fed to the model)
        batch.update({"cam_scale_left": sc_l, "cam_trans_left": tr_l,
                      "cam_scale_right": sc_r, "cam_trans_right": tr_r})
    if with_aux:
        batch.update(synthetic_aux_targets(
            assets, img_size, {"left": sc_l, "right": sc_r}, {"left": tr_l, "right": tr_r},
            {"left": v3d_l, "right": v3d_r}, {"left": j2d_l, "right": j2d_r}))
    return batch


def synthetic_aux_targets(assets, img_size: int, scale: dict, trans2d: dict, v3d: dict,
                          j2d: dict) -> dict:
    """The aux heads' targets at their resolution S = img_size // 4, from
    each hand's camera, 3-D vertices and 2-D joints: 'hms' (B, S, S, 42),
    the 21 left then 21 right joint Gaussians (sigma max(S/32, 1)); 'mask'
    (B, S, S), the two-hand union silhouette; 'mask_left'/'mask_right',
    each hand's own (which gate its dense half in `aux_losses`); 'dense'
    (B, S, S, 6), each hand's template-coordinate colours rendered inside
    its silhouette, left first. The reference renders these offline
    (`miscellaneous/interhand_ori_gen.py`)."""
    s = img_size // 4

    def hand_dense(hand_assets, sc, tr, v):
        faces = hand_assets.mano.faces
        colors = torch.from_numpy(_dense_color_from_template(hand_assets.mano)).to(
            device=v.device, dtype=torch.float32)
        v2d = orthographic_project(sc, tr, v, s)
        attr, mask, _ = rasterize_orthographic(
            v2d, v[..., 2], colors.expand(v.shape[0], -1, -1), faces, height=s, width=s,
            row_block=pick_row_block(v.shape[0], s, s, faces.shape[0]))
        return attr * mask[..., None], mask.to(torch.float32)

    dense_l, mask_l = hand_dense(assets.left, scale["left"], trans2d["left"], v3d["left"])
    dense_r, mask_r = hand_dense(assets.right, scale["right"], trans2d["right"], v3d["right"])
    return {"hms": joint_heatmap_targets(j2d["left"], j2d["right"], s, img_size),
            "mask": torch.maximum(mask_l, mask_r),
            "mask_left": mask_l, "mask_right": mask_r,
            "dense": torch.cat([dense_l, dense_r], dim=-1)}


def synthetic_batch(assets, gen: torch.Generator, batch_size: int = 8,
                    img_size: int = 256, bone_length: float = 0.095,
                    with_cam: bool = False, with_img: bool = True,
                    scene: bool = False, with_aux: bool = False) -> dict:
    """A synthetic batch on `gen`'s device (the assets' MANO models must be
    there too).

    With `scene=False` (the cheap fixture) each hand gets an independent
    random camera and 3D labels stay per-hand root-relative; `root_rel` is
    noise. With `scene=True` the two hands form one interacting scene, as
    in the real InterHand crops (`core/loader.py:180-219`): the right hand
    at a sampled root offset from the left, one shared orthographic camera
    fit so the pair fills most of the frame, v3d_right/j3d_right in the
    scene frame (left root at the origin). `with_aux` adds the aux heads'
    targets (`synthetic_aux_targets`)."""
    draws = synthetic_draws(gen, batch_size, img_size, with_img, scene)
    return synthetic_from_draws(assets, draws, img_size, bone_length, with_cam, scene,
                                with_aux)
