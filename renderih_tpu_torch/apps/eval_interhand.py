"""InterHand2.6M evaluation CLI (counterpart of
`renderih_tpu/apps/eval_interhand.py`; reference `apps/eval_interhand.py`).

    python -m renderih_tpu_torch.apps.eval_interhand [--cfg C] \
        [--ckpt DIR [--ema] | --torch_ckpt PTH] [--data /path/packed] \
        [--split test] [--iou iou.npy] [--bs 512] [--synthetic] [--json] \
        [--newmpjpe] [--device cuda|cpu] [--mesh_data N]

Runs on the card (`--device cuda`, the default; raises without one) or,
when asked, on the CPU with the kernels' plain versions. `--synthetic`
(or no `--data`) evaluates 256 synthetic samples written to a temporary
directory. `--mesh_data N` evaluates data-parallel over the first N cards
(with `--device cpu`, N replicas on the CPU): `evaluate_packed(mesh=)`.
"""

from __future__ import annotations

import argparse
import json
import tempfile

import numpy as np
import torch

from renderih_tpu_torch.apps.weights import add_weight_args, load_eval_weights
from renderih_tpu_torch.assets import load_assets
from renderih_tpu_torch.config import load_config
from renderih_tpu_torch.data.interhand import PackedInterHand, make_synthetic_packed
from renderih_tpu_torch.eval.evaluator import evaluate_packed, print_summary
from renderih_tpu_torch.models import init_model
from renderih_tpu_torch.parallel.mesh import make_mesh
from renderih_tpu_torch.serve import resolve_device

SYNTHETIC_N = 256


def build_parser(bs: int = 512) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cfg", default=None, help="YAML config (default: Config())")
    add_weight_args(p)
    p.add_argument("--data", default=None, help="packed dataset dir")
    p.add_argument("--split", default="test")
    p.add_argument("--bs", type=int, default=bs)
    p.add_argument("--synthetic", action="store_true",
                   help="evaluate a synthetic split (the default without --data)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def run_eval(args, synthetic_n: int, **kwargs) -> dict:
    """Build the model of `args.cfg` on `args.device`, fill it from the
    weight args and evaluate the split; returns `evaluate_packed`'s
    summary."""
    device = resolve_device(args.device)
    cfg = load_config(args.cfg)
    assets = load_assets(cfg.assets)
    model = init_model(cfg, assets, torch.Generator().manual_seed(0))
    load_eval_weights(model, args)
    model = model.to(device, memory_format=torch.channels_last)
    if args.data and not args.synthetic:
        dataset = PackedInterHand.load(args.data, args.split)
        return evaluate_packed(cfg, model, assets, dataset, batch_size=args.bs,
                               device=device, **kwargs)
    with tempfile.TemporaryDirectory(prefix="renderih_eval_") as root:
        dataset = make_synthetic_packed(root, args.split, assets, n=synthetic_n)
        summary = evaluate_packed(cfg, model, assets, dataset, batch_size=args.bs,
                                  device=device, **kwargs)
        del dataset  # the memmap, before its directory goes
    return summary


def main(argv=None) -> dict:
    p = build_parser()
    p.add_argument("--iou", default=None, help="per-sample inter-hand mask IoU (.npy)")
    p.add_argument("--json", action="store_true", help="print the summary as one JSON line")
    p.add_argument("--newmpjpe", action="store_true",
                   help="root joint 9, length |j9 - j0| "
                        "(reference apps/eval_interhand_newmpjpe.py)")
    p.add_argument("--mesh_data", type=int, default=0,
                   help="evaluate data-parallel over N devices (0: one device)")
    args = p.parse_args(argv)
    iou = np.load(args.iou, allow_pickle=False) if args.iou else None
    mesh = None
    if args.mesh_data:
        device = resolve_device(args.device)
        mesh = make_mesh(data=args.mesh_data, devices=(
            [device] * args.mesh_data if device.type == "cpu"
            else [torch.device("cuda", i) for i in range(torch.cuda.device_count())
                  ][:args.mesh_data]))
    summary = run_eval(args, SYNTHETIC_N, iou=iou, mesh=mesh,
                       convention="newmpjpe" if args.newmpjpe else "default")
    if args.json:
        print(json.dumps({k: float(v) for k, v in summary.items()}), flush=True)
    else:
        print_summary(summary)
    return summary


if __name__ == "__main__":
    main()
