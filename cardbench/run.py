"""One run of one cell of `BENCHMARK.json` on the card.

    python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's inputs from the seed (`harness/cell.py`), runs the traffic's
kind (`kinds/<kind>.py`, the kind named in `traffic/<traffic>.json`) for
`--seconds` after set-up, checks a sample of the outputs against the plain
reference (`reference/`), and prints one JSON object as the last line of
standard output: with `--trace 0` the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics (each read by `metrics/<name>.py` from the
profiled slice and the run's counters) and the breakdown. Every number
compared is printed beside its limit on the last lines of standard error and
under `checked`, the last key of the JSON object.

Exits non-zero, printing no result, where no card (or fewer cards than the cell
asks for) is visible, or where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
KERNEL_SOURCES = ("conv3x3", "fused_attention")


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time of the
    process), or since this module was loaded where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rpartition(")")[2].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def host_line(wall_s: float, cpu_s: float) -> str:
    """How busy this process kept the host over the run. The machine-wide
    counters of /proc/stat are left out: in a sandbox they need not move."""
    return f"host: this process {cpu_s:.2f} CPU s over {wall_s:.2f} s"


def card_line() -> str:
    query = "name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        res = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def load_reader(name: str):
    path = ROOT / "cardbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("cardbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def reported(metric: dict, cell: str) -> bool:
    """Whether a metric of BENCHMARK.json belongs in this cell's result."""
    return "workloads" not in metric or cell in metric["workloads"]


def timeline_line(timeline: tuple, seconds: float) -> str:
    """Requests completed and their median latency in each quarter of the
    window, by the time each completed (or was due, online)."""
    import numpy as np

    at, latency = (np.asarray(a, float) for a in timeline)
    parts = []
    for q in range(4):
        sel = (at >= q * seconds / 4) & (at < (q + 1) * seconds / 4) & np.isfinite(latency)
        med = 1e3 * float(np.median(latency[sel])) if sel.any() else float("nan")
        parts.append(f"{int(sel.sum())} at {med:.1f} ms")
    return "window by quarter: " + ", ".join(parts)


def hold_to_cores(n: int) -> None:
    """Hold this process, and every thread it starts from now on, to the last
    `n` of the CPU cores it may use (a traffic file's `cores`)."""
    allowed = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, allowed[-n:])
    print(f"cores: {sorted(os.sched_getaffinity(0))} of {allowed}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "cardbench" / sub)
    # one host thread for CPU ops: the served path has none worth a pool, and idle
    # pool threads spinning beside the launching thread make its times vary
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path.insert(0, str(ROOT))

    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload} in BENCHMARK.json", file=sys.stderr)
        return 2
    with open(ROOT / "cardbench" / "traffic" / f"{entry['traffic']}.json") as f:
        cores = json.load(f).get("cores")
    if cores:
        hold_to_cores(cores)

    import torch

    torch.set_num_threads(1)

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2

    from renderih_tpu_torch.kernels import _build, conv3x3, fused_attention

    from cardbench.harness.cell import Cell, forbidden_modules

    _build.build(KERNEL_SOURCES)  # the program's nvcc build, one process a source, at once
    cell = Cell(args.workload, args.seed, args.seconds, bool(args.trace))
    kind = importlib.import_module(f"cardbench.kinds.{cell.traffic['kind']}")
    torch.cuda.reset_peak_memory_stats()
    t0, c0 = time.perf_counter(), time.process_time()
    res = kind.run(cell, process_age_s)
    host = host_line(time.perf_counter() - t0, time.process_time() - c0)

    correct, checked = cell.check(res)

    if args.trace:
        metrics = {}
        for m in bench["per_layer"]:
            if reported(m, args.workload):
                value = load_reader(m["name"])(cell, res)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": res["e2e"][m["name"]], "unit": m["unit"]}
                   for m in bench["end_to_end"] if reported(m, args.workload)}

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": entry["chips"],
              "memory_peak_bytes": res["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
              "metrics": metrics, "device": device}
    if args.trace:
        s = res["slice"]
        device.update(busy_s=s.busy_s, window_s=s.wall_s)
        result["breakdown"] = s.breakdown()
        print(f"slice: {s.events} device events, {len(s.forward_batches)} forwards "
              f"{s.forward_batches}, {s.images} images, by range "
              + json.dumps(s.by_range))
    result["checked"] = checked

    print(f"card: {card_line()}")
    print(host)
    print(f"launches: conv3x3 {conv3x3.launches.value} "
          + json.dumps({k: c.value for k, c in conv3x3.routes.items()})
          + f" fused_mha {fused_attention.launches.value}")
    window = res["window"]
    buckets = {b: window["forward_batches"].count(b) for b in sorted(set(window["forward_batches"]))}
    print(f"window: {window['requests']} requests, {window['images']} images in the window, "
          f"forwards by bucket {json.dumps(buckets)}; " + json.dumps(res["notes"]))
    print(timeline_line(res["timeline"], cell.seconds))
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad} (JAX or the JAX package)", file=sys.stderr)
        return 3
    for name, c in checked.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
