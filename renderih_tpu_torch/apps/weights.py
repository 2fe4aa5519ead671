"""Eval-weight resolution shared by the CLI apps (counterpart of
`renderih_tpu/apps/weights.py`).

Every eval entry point takes the same sources, loaded into a built
`HandNet`:
  --ckpt DIR        a checkpoint directory of the port's trainer
                    (`train/state.py`), optionally --ema
  --torch_ckpt PTH  a reference-layout .pth: a bare state_dict or the
                    reference's {'epoch', 'network'} save
                    (`core/lijun_trainer.py:343-355`)
  neither           the seed-0 initialisation (smoke and synthetic runs)
The JAX package's orbax checkpoints are not read: the port runs where
JAX is not installed.
"""

from __future__ import annotations

import os

import torch

from renderih_tpu_torch.train.state import CHECKPOINT_FILE


def add_weight_args(parser) -> None:
    parser.add_argument("--ckpt", default=None,
                        help="checkpoint directory of the port's trainer (state.pt); "
                             "orbax checkpoints of the JAX package are not read here")
    parser.add_argument("--ema", action="store_true",
                        help="evaluate the EMA parameters of --ckpt (trained with "
                             "train.ema_decay > 0) with its BatchNorm statistics")
    parser.add_argument("--torch_ckpt", default=None,
                        help="reference .pth: a state_dict or {'epoch', 'network'}")


def _skip(key: str) -> bool:
    return key.endswith("num_batches_tracked")


def load_reference_state_dict(model: torch.nn.Module, path: str) -> None:
    """Load a reference .pth into `model`: the {'epoch', 'network'} wrapper
    removed, `module.` (DDP) prefixes stripped, `num_batches_tracked`
    dropped; any other key missing or left over is an error."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    sd = raw["network"] if "network" in raw else raw
    sd = {k.removeprefix("module."): v for k, v in sd.items() if not _skip(k)}
    want = {k for k in model.state_dict() if not _skip(k)}
    missing, unexpected = sorted(want - sd.keys()), sorted(sd.keys() - want)
    if missing or unexpected:
        raise ValueError(f"{path}: does not fit the model: missing {missing[:5]} "
                         f"({len(missing)}), unexpected {unexpected[:5]} ({len(unexpected)})")
    model.load_state_dict(sd, strict=False)


def load_eval_weights(model: torch.nn.Module, args) -> None:
    """Fill `model` (in place) from the parsed weight args; with neither
    --ckpt nor --torch_ckpt it keeps its weights."""
    if args.ema and not args.ckpt:
        raise SystemExit("--ema requires --ckpt")
    if args.ckpt and args.torch_ckpt:
        raise SystemExit("pass --ckpt or --torch_ckpt, not both")
    if args.ckpt:
        blob = torch.load(os.path.join(args.ckpt, CHECKPOINT_FILE), map_location="cpu",
                          weights_only=True)
        model.load_state_dict(blob["model"])
        if args.ema:
            if blob["ema"] is None:
                raise SystemExit(f"--ema: {args.ckpt} was trained without "
                                 "train.ema_decay > 0")
            # the EMA parameters with the checkpoint's BatchNorm statistics
            with torch.no_grad():
                for name, p in model.named_parameters():
                    p.copy_(blob["ema"][name])
    elif args.torch_ckpt:
        load_reference_state_dict(model, args.torch_ckpt)
