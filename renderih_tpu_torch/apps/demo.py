"""Two-hand demo: run the model on images and render mesh overlays
(counterpart of `renderih_tpu/apps/demo.py`; the reference's
`apps/demo.py` + `core/test_utils.py:InterRender`).

Each image is padded to a square, resized to 256² (bilinear, as cv.resize),
normalised and run through `InferenceEngine` (the serving path: B1 and B2
on the card); both predicted meshes are rendered with the predicted
orthographic cameras over the input and written under the input's
basename, plus `<name>_rot<ext>`, a view turned by `--other_view` degrees,
if asked. Images are read and written without cv2 (`data/image_io.py`).

    python -m renderih_tpu_torch.apps.demo --img_path DIR --save_path OUT
        [--cfg C] [--ckpt DIR | --torch_ckpt PTH] [--other_view 60] [--device cpu]

The reference's `--live_demo` (a webcam window) is not ported: it needs a
camera and a window (cv.VideoCapture, cv.imshow), and the port imports no
capture or display library. Its per-frame loop, with the same
constant-acceleration smoothing of the meshes (`apps/demo.py:103-128`),
is `live_loop(frames, show, runner)` for any source of frames.

Runs on the card unless `--device cpu`; without a card the default raises.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from glob import glob

import numpy as np
import torch

from renderih_tpu_torch.apps.weights import add_weight_args, load_eval_weights
from renderih_tpu_torch.assets import load_assets
from renderih_tpu_torch.config import load_config
from renderih_tpu_torch.data.image_io import imread_rgb, imwrite, resize_bilinear_u8
from renderih_tpu_torch.render.renderer import TwoHandRenderer
from renderih_tpu_torch.serve import InferenceEngine, resolve_device

LIVE_DEMO_NOT_PORTED = (
    "--live_demo is not ported: it needs a camera and a window (cv2.VideoCapture, "
    "cv2.imshow), and the port imports no capture or display library. Its per-frame loop "
    "is renderih_tpu_torch.apps.demo.live_loop(frames, show, runner).")


def pad_to_square(img: np.ndarray) -> np.ndarray:
    """Centre an (H, W, C) image on a black square of side max(H, W)."""
    h, w = img.shape[:2]
    if h == w:
        return img
    s = max(h, w)
    out = np.zeros((s, s, img.shape[2]), img.dtype)
    y0, x0 = (s - h) // 2, (s - w) // 2
    out[y0:y0 + h, x0:x0 + w] = img
    return out


class InterRender:
    """Inference and overlay (reference `core/test_utils.py:19-128`): the
    model through `InferenceEngine` at one bucket of 1, the renderer on the
    engine's device. `state_dict` as the engine takes it (default: the
    seed-0 initialisation)."""

    def __init__(self, cfg, assets, state_dict: dict | None = None, img_size: int = 256,
                 device: torch.device | str | None = None):
        self.img_size = img_size
        self.engine = InferenceEngine(cfg, assets, state_dict=state_dict, buckets=(1,),
                                      device=device)
        self.device = self.engine.device
        self.renderer = TwoHandRenderer(assets, img_size, device=self.device)

    def run_model(self, img_rgb_u8: np.ndarray) -> dict:
        """An RGB uint8 image of any size -> the predicted meshes and
        cameras (numpy, batch 1) and the 256² network input."""
        img = resize_bilinear_u8(pad_to_square(img_rgb_u8), (self.img_size, self.img_size))
        out = self.engine.predict(img[None])
        return {"verts_left": out["verts3d_left"], "verts_right": out["verts3d_right"],
                "scale": {h: out[f"scale_{h}"] for h in ("left", "right")},
                "trans2d": {h: out[f"trans2d_{h}"] for h in ("left", "right")},
                "input": img}

    def _on(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=self.device)

    def _u8(self, img01: torch.Tensor) -> np.ndarray:
        return torch.clamp(img01[0] * 255.0, 0, 255).cpu().numpy().astype(np.uint8)

    def render(self, params: dict, alpha: float = 0.9) -> np.ndarray:
        """The meshes over the input, uint8 (S, S, 3)."""
        with torch.no_grad():
            rgb, mask = self.renderer.render_rgb_orth(
                {h: self._on(v) for h, v in params["scale"].items()},
                {h: self._on(v) for h, v in params["trans2d"].items()},
                self._on(params["verts_left"]), self._on(params["verts_right"]))
            bg = self._on(params["input"])[None] / 255.0
            return self._u8(self.renderer.overlay(bg, rgb, mask, alpha))

    def render_other_view(self, params: dict, theta: float = 60.0) -> np.ndarray:
        """A novel view of the predicted meshes on white (reference
        `core/test_utils.py:101-128`): both hands centred on the midpoint
        of their mean vertices, turned about y by `theta` degrees, under a
        fixed scale-3 orthographic camera."""
        with torch.no_grad():
            vl, vr = self._on(params["verts_left"]), self._on(params["verts_right"])
            c = 0.5 * (torch.mean(vl, dim=1) + torch.mean(vr, dim=1))[:, None]
            t = 3.14159 / 180.0 * theta
            rot = self._on(np.asarray([[np.cos(t), 0.0, np.sin(t)], [0.0, 1.0, 0.0],
                                       [-np.sin(t), 0.0, np.cos(t)]], np.float32))
            vl, vr = (vl - c) @ rot, (vr - c) @ rot
            b = vl.shape[0]
            scale = {h: torch.full((b,), 3.0, device=self.device) for h in ("left", "right")}
            trans2d = {h: torch.zeros((b, 2), device=self.device) for h in ("left", "right")}
            rgb, mask = self.renderer.render_rgb_orth(scale, trans2d, vl, vr)
            m = mask[..., None].to(rgb.dtype)
            return self._u8(rgb * m + torch.ones_like(rgb) * (1.0 - m))


class ConstantAccelSmoother:
    """Per-parameter constant-acceleration smoothing (`apps/demo.py:103-128`)."""

    def __init__(self, blend: float = 0.5):
        self.blend = blend
        self.prev = None
        self.vel = None

    def __call__(self, value: np.ndarray) -> np.ndarray:
        if self.prev is None:
            self.prev = value
            self.vel = np.zeros_like(value)
            return value
        predicted = self.prev + self.vel
        smoothed = self.blend * value + (1 - self.blend) * predicted
        self.vel = smoothed - self.prev
        self.prev = smoothed
        return smoothed


def live_loop(frames, show, runner: InterRender) -> int:
    """`--live_demo`'s per-frame loop on any iterable of RGB uint8 frames:
    each frame through the model, its meshes smoothed over time (one
    `ConstantAccelSmoother` a hand), rendered and passed to `show`; a
    truthy return of `show` stops the loop (the window's 'q'). Returns the
    number of frames shown."""
    smoothers: dict = {}
    n = 0
    for rgb in frames:
        params = runner.run_model(rgb)
        for key in ("verts_left", "verts_right"):
            params[key] = smoothers.setdefault(key, ConstantAccelSmoother())(params[key])
        n += 1
        if show(runner.render(params)):
            break
    return n


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cfg", type=str, default=None, help="YAML config (default: Config())")
    add_weight_args(p)
    p.add_argument("--img_path", type=str, default="demo_in")
    p.add_argument("--save_path", type=str, default="demo_out")
    p.add_argument("--live_demo", action="store_true",
                   help="not ported (no camera or window library): see live_loop")
    p.add_argument("--other_view", type=float, default=None,
                   help="also save a novel view rotated by this many degrees")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def main(argv=None) -> dict:
    """Run the demo; returns the images done, the outputs written and the
    seconds taken (model, render and files, after the engine is built)."""
    args = build_parser().parse_args(argv)
    if args.live_demo:
        raise SystemExit(LIVE_DEMO_NOT_PORTED)
    device = resolve_device(args.device)
    cfg = load_config(args.cfg)
    runner = InterRender(cfg, load_assets(cfg.assets), device=device)
    load_eval_weights(runner.engine.model, args)

    os.makedirs(args.save_path, exist_ok=True)
    images = sorted(glob(os.path.join(args.img_path, "*.jpg"))
                    + glob(os.path.join(args.img_path, "*.png")))
    outputs = []
    t0 = time.perf_counter()
    for path in images:
        params = runner.run_model(imread_rgb(path))
        out_path = os.path.join(args.save_path, os.path.basename(path))
        imwrite(out_path, runner.render(params))
        outputs.append(out_path)
        print(f"{path} -> {out_path}", flush=True)
        if args.other_view is not None:
            base, ext = os.path.splitext(out_path)
            imwrite(base + "_rot" + ext, runner.render_other_view(params, theta=args.other_view))
            outputs.append(base + "_rot" + ext)
    return dict(images=len(images), outputs=outputs, seconds=time.perf_counter() - t0,
                device=str(runner.device))


if __name__ == "__main__":
    main(sys.argv[1:])
