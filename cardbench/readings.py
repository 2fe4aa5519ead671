"""The readings that the limits of `correct` are set from, on the card.

    python3 cardbench/readings.py --workload <cell> --seeds 1 2 ... --control-seeds 1 2 3 \
        [--torch-default-seeds 1 2 3] --seconds 3 [--json build/readings.json]

For each seed of `--seeds`, one short run of the cell's traffic through the
program, in one process, and the numbers `correct` compares for the sampled
outputs (`harness/cell.py:numbers`) and for the kept decoder calls
(`Cell.decoder_number`): the lower readings. For each seed of
`--control-seeds`, the same numbers for the control put in the program's place
on the same sampled images: the reference computed one precision below the
configuration's (encoder and mid convolutions in float8 e4m3 for bfloat16, the
decoder in TF32 for float32), and, for the decoder's number, the reference's
decoder in TF32 on the program's decoder inputs: the upper readings. For each
seed of `--torch-default-seeds`, the decoder's number of a program run with
PyTorch's default TF32 flags (cuDNN's float32 convolutions in TF32), which the
benchmark's runs turn off. Every statistic's raw gaps are kept beside them
(`--json`). The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--torch-default-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from cardbench.harness.cell import Cell, decoder_ratio, gap_stats, numbers

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    rows = []
    for seed in sorted(set(args.seeds) | set(args.control_seeds) | set(args.torch_default_seeds)):
        for torch_default in (False, True):
            if seed not in (args.torch_default_seeds if torch_default
                            else set(args.seeds) | set(args.control_seeds)):
                continue
            cell = Cell(args.workload, seed, args.seconds, False)
            if torch_default:  # PyTorch's own defaults
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
                cell.torch_tf32_default = True
            kind = importlib.import_module(f"cardbench.kinds.{cell.traffic['kind']}")
            t0 = time.perf_counter()
            res = kind.run(cell, lambda: 0.0)
            kept = res["decoder_kept"]
            row = {"seed": seed, "torch_tf32_default": torch_default, "failed": res["failed"],
                   "images": len(res["check_rows"]),
                   "decoder_images": sum(len(o["scale_left"]) for _, _, o in kept)}
            if torch_default:
                row["program_decoder_gaps"], row["f32_decoder_gaps"] = cell.decoder_gaps(kept)
            else:
                prec = cell.reference.Precision
                rows_ = res["check_rows"]
                ref32, stated = cell.yardstick(rows_)
                row["stated_gaps"] = stated
                if seed in args.seeds:
                    row["program_gaps"] = gap_stats(res["check_outputs"], ref32)
                    row["program"] = numbers(row["program_gaps"], stated)
                    row["program_decoder_gaps"], row["f32_decoder_gaps"] = cell.decoder_gaps(kept)
                if seed in args.control_seeds:
                    control = cell.reference_outputs(rows_, prec(encoder="fp8", decoder="tf32"))
                    row["control_gaps"] = gap_stats(control, ref32)
                    row["control"] = numbers(row["control_gaps"], stated)
                    row["control_decoder_gaps"], row["f32_decoder_gaps"] = cell.decoder_gaps(
                        kept, prec(decoder="tf32"))
            for side in ("program", "control"):
                if f"{side}_decoder_gaps" in row:
                    row.setdefault(side, {})["decoder"] = decoder_ratio(
                        row[f"{side}_decoder_gaps"], row["f32_decoder_gaps"])
            row["seconds"] = time.perf_counter() - t0
            rows.append(row)
            print(json.dumps(row), flush=True)
            del res, kept
            torch.cuda.empty_cache()
    for side, agg, default in (("program", max, False), ("control", min, False),
                               ("program", max, True)):
        got = [r[side] for r in rows if side in r and r["torch_tf32_default"] == default]
        if got:
            keys = sorted(set().union(*got))
            print(f"{side}{' (torch defaults)' if default else ''} ({agg.__name__} over "
                  f"{len(got)} seeds): "
                  + ", ".join(f"{k} {agg(g[k] for g in got if k in g):.6g}" for k in keys))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
