"""Summarise a training run's metrics.jsonl into a receipt table
(counterpart of `tools/summarize_run.py`).

One row per eval point with the train loss at the nearest logged step,
then the loss and the eval MPJPEs from first to last: the convergence
receipt the reference's in-train eval gives through TensorBoard
(`core/lijun_trainer.py:357-569`). Reads what `apps.train` writes
(`utils/metrics_writer.py`).

    python -m renderih_tpu_torch.tools.summarize_run CKPT_DIR/metrics.jsonl [--markdown]
"""

from __future__ import annotations

import argparse
import json
import sys


def load(path: str):
    """({step: train record}, [eval records]) of a metrics.jsonl."""
    train, evals = {}, []
    with open(path) as f:
        for line in f:
            d = json.loads(line)
            if "train/total" in d:
                train[d["step"]] = d
            if "eval/mpjpe_mm" in d:
                evals.append(d)
    return train, evals


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("path")
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args(argv)
    train, evals = load(args.path)
    steps = sorted(train)
    if not steps:
        print("no train records")
        return

    def nearest_loss(step):
        return train[min(steps, key=lambda x: abs(x - step))]["train/total"]

    cols = ("step", "train_total", "eval_mpjpe_mm", "eval_pa_mpjpe_mm", "eval_mpvpe_mm",
            "eval_mrrpe_mm")
    rows = [(e["step"], nearest_loss(e["step"]), e["eval/mpjpe_mm"], e["eval/pa_mpjpe_mm"],
             e["eval/mpvpe_mm"], e.get("eval/mrrpe_mm", float("nan"))) for e in evals]
    sep = " | " if args.markdown else "  "
    edge, end = ("| ", " |") if args.markdown else ("", "")
    print(edge + sep.join(f"{c:>16}" for c in cols) + end)
    if args.markdown:
        print("|" + "|".join(["---"] * len(cols)) + "|")
    for r in rows:
        print(edge + sep.join(f"{v:16.2f}" if isinstance(v, float) else f"{v:16d}" for v in r)
              + end)
    first, last = train[steps[0]], train[steps[-1]]
    print(f"\ntrain/total: {first['train/total']:.2f} (step {steps[0]}) -> "
          f"{last['train/total']:.2f} (step {steps[-1]})")
    if len(evals) >= 2:
        for k in ("eval/mpjpe_mm", "eval/pa_mpjpe_mm"):
            print(f"{k}: {evals[0][k]:.2f} (step {evals[0]['step']}) -> "
                  f"{evals[-1][k]:.2f} (step {evals[-1]['step']})")


if __name__ == "__main__":
    main(sys.argv[1:])
