"""Find the knee of an online cell once: the highest offered rate at which
completions keep up with arrivals over the window.

    python3 cardbench/sweep.py --workload resnet50_graph.online --rates 500 1000 ... \
        --seconds 10 --seed 1

Runs the cell's traffic at each offered rate in turn (one process; the
traffic file's rate is replaced), and prints for each: the offered and
completed images a second inside the window, the requests still open at the
close, the latency percentiles and the generator's lateness. The benchmark's
own runs do not run this; the rate it finds goes into the traffic file.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from cardbench.harness.cell import Cell
    from cardbench.kinds import online

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    for rate in args.rates:
        cell = Cell(args.workload, args.seed, args.seconds, False)
        cell.traffic = dict(cell.traffic, rate_per_s=rate, check_requests=1)
        res = online.run(cell, lambda: 0.0)
        n = res["notes"]
        row = {"rate": rate, "offered_per_s": n["offered_per_s"],
               "completed_per_s_in_window": n["completed_per_s_in_window"],
               "open_at_close": n["offered"] - n["completed_in_window"],
               "latency_p50_ms": n["latency_p50_ms"], "latency_p95_ms": res["e2e"]["latency_p95_ms"],
               "lateness_p50_ms": n["lateness_p50_ms"], "lateness_max_ms": n["lateness_max_ms"],
               "forwards": n["forwards"], "failed": res["failed"]}
        print(json.dumps(row), flush=True)
        del res
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
