"""Synthetic two-hand training data on the card (counterpart of
`tools/synth_gen.py`).

  1. sample random two-hand MANO configurations (pose, shape, root,
     offset) and orthographic cameras;
  2. with `--optimize`, refine each sample with the contact/SDF optimiser
     (`optimize/geo.py`, anchor mode, 4 attempts of max(opt_iters // 4, 1)
     Adam steps, SDF grid 16: kernel B3 on the card, 2 fields per step),
     with the Gaussian naturalness prior or, with `--prior gan`, the
     trained discriminator's (`--prior_weights`, the port's copy by default);
  3. render RGB with random skin albedo and a random directional light:
     the rasteriser with Blinn-Phong highlights, or with `--renderer
     pathtrace` the path tracer (`render/pathtrace.py`: a disk area light,
     soft shadows, `--bounces` of interreflection, `--spp` samples a
     pixel); composite over a procedural background or, with
     `--backgrounds DIR`, over augmented images of that directory
     (`BackgroundCorpus`), plus pixel noise;
  4. project the labels with the sampled cameras;
  5. write `{split}_images.u8` (uint8 memmap (N, 256, 256, 3)) and
     `{split}_labels.npz` (LABEL_KEYS), the layout the packed-dataset
     readers load.

    python -m renderih_tpu_torch.tools.synth_gen --out DIR --n 512 [--optimize [--prior gan]]
        [--backgrounds DIR] [--renderer pathtrace [--spp 8] [--bounces 2]]
    python -m renderih_tpu_torch.tools.synth_gen --out DIR --n 2 --device cpu

Runs on the card unless `--device cpu` asks for the plain versions on the
CPU; without a card the default raises. Random draws come from one
`torch.Generator` seeded from `--seed` on the device. `main(argv)` returns
the run's timings and the sampled cameras.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from renderih_tpu_torch.assets import load_assets, manos_to
from renderih_tpu_torch.config import Config
from renderih_tpu_torch.data.interhand import IMG_SIZE, LABEL_KEYS, _label_shape
from renderih_tpu_torch.mano.layer import mano_forward
from renderih_tpu_torch.ops.projection import orthographic_project
from renderih_tpu_torch.ops.rotation import rodrigues
from renderih_tpu_torch.optimize.anchors import make_synthetic_anchors
from renderih_tpu_torch.optimize.geo import (
    POSE_PRIOR_PATH,
    GeoWeights,
    HandVars,
    load_pose_prior,
    make_gan_pose_prior,
    make_gaussian_pose_prior,
    optimize_two_hands,
)
from renderih_tpu_torch.render.backgrounds import (
    BackgroundCorpus,
    random_background,
    random_lighting,
    random_skin_albedo,
)
from renderih_tpu_torch.render.pathtrace import TwoHandPathTracer
from renderih_tpu_torch.render.renderer import TwoHandRenderer
from renderih_tpu_torch.serve import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--n", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--optimize", action="store_true",
                   help="run the contact/SDF refinement on each sample")
    p.add_argument("--opt_iters", type=int, default=60,
                   help="Adam iterations per sample for --optimize")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--prior", choices=("gaussian", "gan"), default="gaussian",
                   help="naturalness prior for --optimize: the analytic Gaussian, or "
                        "the trained discriminator (tools/train_pose_prior.py artifact)")
    p.add_argument("--prior_weights", default=POSE_PRIOR_PATH,
                   help="npz artifact for --prior gan (default: the port's copy)")
    p.add_argument("--backgrounds", default=None,
                   help="directory of background images to composite over (the reference's "
                        "Blender pipeline); procedural backgrounds when omitted")
    p.add_argument("--renderer", choices=("raster", "pathtrace"), default="raster",
                   help="raster: the Phong rasteriser; pathtrace: Monte-Carlo path tracing "
                        "(area-light soft shadows, interreflection; render/pathtrace.py)")
    p.add_argument("--spp", type=int, default=8,
                   help="samples a pixel for --renderer pathtrace")
    p.add_argument("--bounces", type=int, default=2,
                   help="indirect bounces for --renderer pathtrace")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def _sample_raw(gen: torch.Generator, bs: int) -> dict:
    """Raw two-hand configurations and cameras, no geometry."""
    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=gen.device) * std

    def uniform(shape, low, high):
        return torch.rand(shape, generator=gen, device=gen.device) * (high - low) + low

    raw = dict(
        root_l=normal((bs, 3), 0.8), pose_l=normal((bs, 45), 0.4),
        shape_l=normal((bs, 10), 0.6),
        root_r=normal((bs, 3), 0.8), pose_r=normal((bs, 45), 0.4),
        shape_r=normal((bs, 10), 0.6),
        offset=normal((bs, 3), 0.04),  # right hand placed near the left
        scale=uniform((bs,), 0.8, 1.4),
        trans_l=uniform((bs, 2), -0.35, 0.0),
    )
    raw["trans_r"] = raw["trans_l"] + uniform((bs, 2), 0.1, 0.35)
    return raw


def _finalize(raw: dict, gen: torch.Generator, assets, renderer, tracer=None, corpus=None,
              spp: int = 8, bounces: int = 2) -> dict:
    """Parameters -> geometry, labels and the rendered image (the path
    tracer's if `tracer`, over `corpus`'s images if given)."""
    bs = raw["scale"].shape[0]
    size = renderer.img_size
    v_l, j_l = mano_forward(assets.left.mano, rodrigues(raw["root_l"]), raw["pose_l"],
                            raw["shape_l"], center_idx=9, use_pca=False)
    v_r, j_r = mano_forward(assets.right.mano, rodrigues(raw["root_r"]), raw["pose_r"],
                            raw["shape_r"], center_idx=9, use_pca=False)
    v_r = v_r + raw["offset"][:, None]
    j_r = j_r + raw["offset"][:, None]
    scale, trans_l, trans_r = raw["scale"], raw["trans_l"], raw["trans_r"]

    albedo = random_skin_albedo(gen, bs, renderer.num_verts)
    light_dir, light_color, ambient = random_lighting(gen, bs)
    cams = {"left": scale, "right": scale}, {"left": trans_l, "right": trans_r}
    if tracer is not None:
        rgb, mask = tracer.render(*cams, v_l, v_r, albedo, gen, light_dir=light_dir,
                                  spp=spp, n_bounces=bounces)
    else:
        rgb, mask = renderer.render_rgb_orth(
            *cams, v_l, v_r, albedo=albedo, light_dir=light_dir, light_color=light_color,
            ambient=ambient, specular=0.15)
    bg = random_background(gen, bs, size, corpus=corpus)
    noise = torch.randn(rgb.shape, generator=gen, device=gen.device) * 0.02
    img = torch.clamp(torch.where(mask[..., None] > 0, rgb, bg) + noise, 0, 1)
    zeros = torch.zeros((bs, 3), device=scale.device)
    return dict(
        img_u8=(img * 255).to(torch.uint8),
        v3d_left=v_l, j3d_left=j_l,
        v2d_left=orthographic_project(scale, trans_l, v_l, size),
        j2d_left=orthographic_project(scale, trans_l, j_l, size),
        v3d_right=v_r, j3d_right=j_r,
        v2d_right=orthographic_project(scale, trans_r, v_r, size),
        j2d_right=orthographic_project(scale, trans_r, j_r, size),
        pose_left=torch.cat([zeros, raw["pose_l"]], -1), shape_left=raw["shape_l"],
        pose_right=torch.cat([zeros, raw["pose_r"]], -1), shape_right=raw["shape_r"],
    )


def _make_refine(assets, opt_iters: int, device: torch.device, prior_kind: str = "gaussian",
                 prior_weights: str = POSE_PRIOR_PATH):
    """The per-sample refinement (reference `pose_data_optimize` step):
    anchor-based contact with a naturalness prior, the Gaussian or the
    trained discriminator's (`prior_kind` "gan", weights from
    `prior_weights`)."""
    if prior_kind == "gan":
        prior = make_gan_pose_prior(load_pose_prior(prior_weights), device)
    else:
        prior_gen = torch.Generator(device=device).manual_seed(1234)
        prior = make_gaussian_pose_prior(
            torch.randn((256, 45), generator=prior_gen, device=device) * 0.4)
    anchor_specs = tuple(
        make_synthetic_anchors(m.faces.cpu().numpy(), m.v_template.cpu().numpy())
        for m in (assets.left.mano, assets.right.mano))
    iters = max(opt_iters // 4, 1)
    sched = ((1.0, 1.0, iters), (0.1, 15.0, iters), (30.0, 0.1, iters), (1.0, 5.0, iters))

    def root_joint(model, root_aa, pose, shape):
        _, j = mano_forward(model, rodrigues(root_aa[None]), pose[None], shape[None],
                            center_idx=None, use_pca=False)
        return j[0, 9]

    def refine(raw: dict, i: int) -> None:
        """Refine sample i in place. The optimiser's frame is uncentred MANO
        plus trans, aligned to the label frame (each hand centred on its
        joint 9, the right one shifted by the offset) by trans = -j9; the
        refined offset maps back as (trans_r' + j9_r') - (trans_l' + j9_l')."""
        r = {k: v[i] for k, v in raw.items()}
        with torch.no_grad():
            j9_l = root_joint(assets.left.mano, r["root_l"], r["pose_l"], r["shape_l"])
            j9_r = root_joint(assets.right.mano, r["root_r"], r["pose_r"], r["shape_r"])
        left = HandVars(pose=r["pose_l"], shape=r["shape_l"], trans=-j9_l,
                        root_aa=r["root_l"])
        right = HandVars(pose=r["pose_r"], shape=r["shape_r"], trans=-j9_r + r["offset"],
                         root_aa=r["root_r"])
        l2, r2, _ = optimize_two_hands(
            assets, left, right, n_iter=opt_iters, sdf_grid_size=16,
            weights=GeoWeights(), pose_prior_fn=prior, anchors=anchor_specs,
            schedule=sched)
        with torch.no_grad():
            j9_l2 = root_joint(assets.left.mano, l2.root_aa, l2.pose, l2.shape)
            j9_r2 = root_joint(assets.right.mano, r2.root_aa, r2.pose, r2.shape)
            upd = dict(pose_l=l2.pose, shape_l=l2.shape, root_l=l2.root_aa,
                       pose_r=r2.pose, shape_r=r2.shape, root_r=r2.root_aa,
                       offset=(r2.trans + j9_r2) - (l2.trans + j9_l2))
            for k, v in upd.items():
                raw[k][i] = v

    return refine


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    assets = manos_to(load_assets(Config().assets), device)
    renderer = TwoHandRenderer(assets, IMG_SIZE, device=device)
    tracer = (TwoHandPathTracer(assets, IMG_SIZE, device=device)
              if args.renderer == "pathtrace" else None)
    corpus = (BackgroundCorpus(args.backgrounds, IMG_SIZE, device=device)
              if args.backgrounds else None)
    if corpus is not None:
        print(f"background corpus: {corpus.images.shape[0]} images", flush=True)
    refine = (_make_refine(assets, args.opt_iters, device, args.prior, args.prior_weights)
              if args.optimize else None)

    n = args.n
    os.makedirs(args.out, exist_ok=True)
    images = np.memmap(os.path.join(args.out, f"{args.split}_images.u8"), dtype=np.uint8,
                       mode="w+", shape=(n, IMG_SIZE, IMG_SIZE, 3))
    labels = {k: np.zeros((n,) + _label_shape(k), np.float32) for k in LABEL_KEYS}
    camera = {k: np.zeros((n,) + s, np.float32)
              for k, s in (("scale", ()), ("trans_left", (2,)), ("trans_right", (2,)))}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    refine_s = 0.0
    sync()
    t_start = time.perf_counter()
    written = 0
    while written < n:
        bs = min(args.batch, n - written)
        with torch.no_grad():
            raw = _sample_raw(gen, bs)
        if refine is not None:
            sync()
            t0 = time.perf_counter()
            for i in range(bs):
                refine(raw, i)
            sync()
            refine_s += time.perf_counter() - t0
        with torch.no_grad():
            batch = _finalize(raw, gen, assets, renderer, tracer, corpus, args.spp,
                              args.bounces)
        rows = slice(written, written + bs)
        images[rows] = batch["img_u8"].cpu().numpy()
        for k in LABEL_KEYS:
            labels[k][rows] = batch[k].cpu().numpy()
        camera["scale"][rows] = raw["scale"].cpu().numpy()
        camera["trans_left"][rows] = raw["trans_l"].cpu().numpy()
        camera["trans_right"][rows] = raw["trans_r"].cpu().numpy()
        written += bs
        print(f"{written}/{n}", flush=True)

    images.flush()
    np.savez(os.path.join(args.out, f"{args.split}_labels.npz"), **labels)
    seconds = time.perf_counter() - t_start
    print(f"synthetic dataset: {n} samples -> {args.out}", flush=True)
    return dict(n=n, device=str(device), seconds=seconds, refine_seconds=refine_s,
                images_per_s=n / seconds,
                refined_samples_per_s=(n / refine_s) if refine is not None else None,
                camera=camera)


if __name__ == "__main__":
    main(sys.argv[1:])
