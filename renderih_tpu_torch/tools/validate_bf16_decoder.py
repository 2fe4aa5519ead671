"""Trained-accuracy A/B of the bf16 decoder trunk (counterpart of
`tools/validate_bf16_decoder.py`).

`model.decoder_f32=False` (`InferenceEngine(decoder_bf16=True)`,
`serve_http --decoder_bf16`) runs the decoder trunk in bf16. Random
weights amplify any perturbation, so the question is asked of a trained
model, with the JAX tool's protocol:
  1. train the config (default `Config()`: ResNet-50 and the graph
     decoder, bf16 encoder, f32 decoder) with `apps.train` on the
     synthetic packed set (`--n` samples) with augmentation off and a flat
     learning rate after warm-up, so that it memorises the set and its
     error falls low enough for a bf16-sized change to show;
  2. evaluate the same weights with `decoder_f32` True and False
     (`evaluate_packed`, batch 256);
  3. report MPJPE and MPVPE under both, their deltas and the mean vertex
     displacement between the two predictions of the first 64 samples, as
     one JSON line.

    python -m renderih_tpu_torch.tools.validate_bf16_decoder [--steps 600] [--bs 64]
        [--cfg YAML] [--n 256] [--device cpu]

Runs on the card unless `--device cpu`; without a card the default raises.
`main(argv)` returns the report; `run` also returns the trained weights.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import tempfile

import numpy as np
import torch

from renderih_tpu_torch.apps import train as train_app
from renderih_tpu_torch.assets import load_assets
from renderih_tpu_torch.config import dump_config, load_config
from renderih_tpu_torch.data.interhand import PackedInterHand
from renderih_tpu_torch.eval.evaluator import evaluate_packed
from renderih_tpu_torch.models import init_model, model_call_kwargs
from renderih_tpu_torch.ops.image import normalize_imagenet
from renderih_tpu_torch.serve import resolve_device
from renderih_tpu_torch.train.state import checkpoint_state_dict


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--bs", type=int, default=64)
    p.add_argument("--cfg", default=None, help="YAML config (default: Config())")
    p.add_argument("--n", type=int, default=256, help="synthetic samples to memorise")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def memorisation_config(cfg, batch_size: int, checkpoint_dir: str):
    """`cfg` for the memorisation run: batch `batch_size`, the learning rate
    flat after warm-up (the default decay every 80 epochs would freeze a
    4-step-an-epoch run), no augmentation, no epoch checkpoint or eval."""
    cfg = copy.deepcopy(cfg)
    cfg.train.batch_size = batch_size
    cfg.train.lr_decay_step = 10 ** 6
    cfg.data.theta_range = (0.0, 0.0)
    cfg.data.scale_range = (1.0, 1.0)
    cfg.data.uv_range = (0.0, 0.0)
    cfg.data.flip = False
    cfg.data.noise = 0.0
    cfg.train.save_gap = cfg.train.eval_every = 10 ** 9
    cfg.train.log_every = 100
    cfg.train.checkpoint_dir = checkpoint_dir
    return cfg


def run(base_cfg, steps: int, batch_size: int, n: int, device: torch.device) -> tuple:
    """Train on the memorisation set and compare the two decoders; returns
    (the report, the trained state_dict, the set's first 128 images)."""
    with tempfile.TemporaryDirectory(prefix="bf16_val_") as root:
        cfg = memorisation_config(base_cfg, batch_size, os.path.join(root, "ck"))
        yaml = os.path.join(root, "cfg.yaml")
        dump_config(cfg, yaml)
        print(f"training {cfg.model.encoder} on {n} synthetic samples, {steps} steps at batch "
              f"{batch_size} ...", flush=True)
        trained = train_app.main(["--cfg", yaml, "--synthetic", "--synth_n", str(n),
                                  "--steps", str(steps), "--device", str(device)])
        state_dict = checkpoint_state_dict(trained["checkpoint"])
        dataset = PackedInterHand.load(os.path.join(cfg.train.checkpoint_dir, "_synth_data"),
                                       "train", use_native=False)
        assets = load_assets(cfg.assets)
        images = np.array(dataset.images[:128])
        img = normalize_imagenet(torch.from_numpy(images[:64]).to(device).float() / 255.0)
        results, preds = {}, {}
        for decoder_f32 in (True, False):
            tag = "f32" if decoder_f32 else "bf16"
            c = copy.deepcopy(cfg)
            c.model.decoder_f32 = decoder_f32
            model = init_model(c, assets, torch.Generator().manual_seed(0))
            model.load_state_dict(state_dict)
            model = model.to(device, memory_format=torch.channels_last).eval()
            summary = evaluate_packed(c, model, assets, dataset, batch_size=256, device=device)
            results[tag] = summary
            print(f"[decoder {tag}] mpjpe {summary['mpjpe_mm']:.4f} mm  mpvpe "
                  f"{summary['mpvpe_mm']:.4f} mm  pa_mpjpe {summary['pa_mpjpe_mm']:.4f} mm",
                  flush=True)
            with torch.inference_mode():
                out = model(img, **model_call_kwargs(assets, device))
            preds[tag] = {h: out.verts3d[h].float().cpu().numpy() for h in ("left", "right")}
        del dataset  # the memmap, before its directory goes
    disp = np.mean([np.linalg.norm(preds["f32"][h] - preds["bf16"][h], axis=-1).mean()
                    for h in ("left", "right")])
    f32, bf16 = results["f32"], results["bf16"]
    report = {
        "mpjpe_f32_mm": float(f32["mpjpe_mm"]), "mpjpe_bf16_mm": float(bf16["mpjpe_mm"]),
        "mpjpe_delta_mm": float(bf16["mpjpe_mm"] - f32["mpjpe_mm"]),
        "mpvpe_f32_mm": float(f32["mpvpe_mm"]), "mpvpe_bf16_mm": float(bf16["mpvpe_mm"]),
        "mpvpe_delta_mm": float(bf16["mpvpe_mm"] - f32["mpvpe_mm"]),
        "pa_mpjpe_delta_mm": float(bf16["pa_mpjpe_mm"] - f32["pa_mpjpe_mm"]),
        "mean_vert_displacement_mm": float(disp) * 1000.0,
        "steps": steps, "batch": batch_size, "samples": n,
        "final_loss": trained["logged"][-1][1]["total"] if trained["logged"] else None,
    }
    return report, state_dict, images


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    report, _, _ = run(load_config(args.cfg), args.steps, args.bs, args.n, device)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main(sys.argv[1:])
