"""One `--trace 1` run of a cell with the program's own spans turned on, and
what they show. Temporary: the `benchmark` PR that reads the spans in the
harness itself (`kinds/*.py` turning tracing on over the window,
`harness/trace.py:summarize` keeping the `renderih.*` ranges; ROADMAP §E.3)
deletes this file.

    python3 cardbench/program_trace.py --workload <cell> --seed <n> --seconds <s> \
        [--out FILE]

Runs `run.py` as the benchmark does (`--trace 1`; its own lines and result
line are printed as ever), with the program's tracing
(`renderih_tpu_torch/utils/trace.py`) turned on from the window's open to
the end of the profiled slice: the window runs with the spans and no
profiler, the slice with both. The benchmark's own runs leave tracing off.
Then prints one more line, `program_trace: {...}`, and writes the same
object to `--out`:
  * `window`: this run's end-to-end metrics (spans on) and the window's
    spans: `by_span` ([count, seconds] of each name); `host_enqueue_us`,
    seconds inside `engine.forward` over the rows of the window's forwards,
    in µs an image; online, `queue_wait_ms` (p50, p95 and the largest
    `serve.queue`) and `batcher_busy`, the share of the time from the
    first request's arrival to the last batch's end that the batcher spends
    inside `serve.batch`;
  * `slice`, from the profiled slice's chrome trace and records
    (`summarize`): the idle gaps, those outside every `cardbench.*` range
    named by the innermost program span (`gaps`, `outside_share`); device
    seconds and host launch calls inside each span (`by_span`,
    `launches_by_span`); `launches_per_forward`, those inside
    `engine.forward` over the slice's forwards, beside
    `kernel_launches_per_forward`, B1's and B2's launch counters over the
    same forwards, and `b1_b2_kernels_by_call`, the host call the trace
    shows for each of their kernels; `twins`, device µs an image under
    `model.encoder` + `model.mid_model` and under `model.decoder` against
    the `cardbench.*` ranges' (what `encoder_device_us` and
    `decoder_device_us` read), and online the rows counters' fill
    (`engine.rows` over rows + `engine.pad_rows`) in the window and in the
    slice against the forward counter's (what `batch_fill` reads).
"""

from __future__ import annotations

import argparse
import bisect
import importlib
import json
import os
import re
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PROGRAM = "renderih."
OUTSIDE = "outside any range"
LAUNCH = re.compile(r"Launch|Memcpy|Memset")  # cudaLaunchKernel, cuLaunchKernel, cudaGraphLaunch, ...


def summarize(events: list, spans: list) -> dict:
    """The program's spans on a chrome trace's `traceEvents`, beside the
    harness's own summary (`harness/trace.py:summarize`), which it leaves as
    it is:
      * the records land on the trace's clock by the offset their profiler
        ranges give (`clock_offset_us`);
      * each thread's spans are intervals: the trace's `renderih.*` ranges
        on a thread the profiler recorded, the records placed on the trace
        on a thread it did not (a thread started before the profiler, as the
        batcher's is); waits (`begin` spans, a request id >= 0) are no
        thread's work and are left out;
      * `by_span`: device seconds of the events launched inside each span,
        as the harness ties them to `cardbench.*` ranges;
      * `launches_by_span`: the host's launch calls (kernel launches, async
        copies and sets, graph launches) inside each span. The trace gives
        the runtime calls of a thread it did not record another thread id;
        that id is taken for the record thread whose spans hold most of its
        calls;
      * `gaps`: the idle gaps labelled as the harness labels them (by what
        the host ran when the gap began), except a gap which finds no
        `cardbench.*` range open then ("outside any range"). Such a gap is
        cut where a span or a `cardbench.*` range begins or ends, and each
        piece takes the harness's label where a `cardbench.*` range is open
        at its start, else the innermost span open then with the outermost
        operator of its thread: `<span> / <op>`, or `<span> / unprofiled`
        on a thread the profiler did not record."""
    from cardbench.harness.trace import (DEVICE_CATS, PREFIX, _host_label, _intervals_by_tid,
                                         _open_at, _outermost)
    from renderih_tpu_torch.utils.trace import clock_offset_us

    program = _intervals_by_tid(events, "user_annotation", PROGRAM)
    offset = clock_offset_us([(tid, name[len(PROGRAM):], t0) for tid, ivs in program.items()
                              for t0, _, name in ivs], spans)
    waits = {s.name for s in spans if s.rid >= 0}
    seen = {e["tid"] for e in events if e.get("cat") in ("cpu_op", "user_annotation")}
    work: dict = {tid: [iv for iv in ivs if iv[2][len(PROGRAM):] not in waits]
                  for tid, ivs in program.items()}
    if offset is not None:
        for s in spans:
            if s.rid < 0 and s.tid not in seen:
                work.setdefault(s.tid, []).append((s.start_ns / 1e3 + offset,
                                                   s.end_ns / 1e3 + offset, PROGRAM + s.name))
    for ivs in work.values():
        ivs.sort()

    calls = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    alias = _runtime_threads(calls, work, seen)
    launches, launch_calls = {}, {}
    for e in calls:
        tid, ts = alias.get(e["tid"], e["tid"]), float(e["ts"])
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None:
            launches[corr] = (tid, ts)
        if LAUNCH.search(e.get("name", "")):
            for _, _, name in _open_at(work.get(tid, []), ts):
                key = name[len(PROGRAM):]
                launch_calls[key] = launch_calls.get(key, 0) + 1
    by_span: dict = {}
    device = [e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
    for e in device:
        launch = launches.get((e.get("args") or {}).get("correlation"))
        if launch is not None:
            for _, _, name in _open_at(work.get(launch[0], []), launch[1]):
                key = name[len(PROGRAM):]
                by_span[key] = by_span.get(key, 0.0) + float(e["dur"]) * 1e-6

    ranges = _intervals_by_tid(events, "user_annotation", PREFIX)
    t0, t1, _ = next(iv for ivs in ranges.values() for iv in ivs if iv[2] == PREFIX + "slice")
    ops = {tid: _outermost(ivs) for tid, ivs in _intervals_by_tid(events, "cpu_op").items()}
    edges = sorted({x for table in (work, ranges) for ivs in table.values() for iv in ivs
                    for x in iv[:2]})
    gaps: dict = {}
    for start, end in idle_gaps(device, t0, t1):
        pieces = [(start, end, _host_label(ranges, ops, start))]
        if pieces[0][2] == OUTSIDE:
            cuts = [start] + edges[bisect.bisect_right(edges, start):
                                   bisect.bisect_left(edges, end)] + [end]
            pieces = [(a, b, _host_label(ranges, ops, a)) for a, b in zip(cuts, cuts[1:])]
            pieces = [(a, b, _program_label(work, ops, seen, a) if label == OUTSIDE else label)
                      for a, b, label in pieces]
        for a, b, label in pieces:
            gaps[label] = gaps.get(label, 0.0) + (b - a) * 1e-6
    idle = sum(gaps.values())
    return {"clock_offset_us": offset, "by_span": by_span, "launches_by_span": launch_calls,
            "gaps": gaps, "outside_share": gaps.get(OUTSIDE, 0.0) / idle if idle else None}


def _runtime_threads(calls: list, work: dict, seen: set) -> dict:
    """{runtime thread id: record thread id} for the threads the profiler did
    not record: the trace gives their runtime calls a thread id of its own,
    which is taken for the record thread whose spans hold most of its calls."""
    from cardbench.harness.trace import _open_at

    by_tid: dict = {}
    for e in calls:
        if e["tid"] not in seen:
            by_tid.setdefault(e["tid"], []).append(float(e["ts"]))
    alias = {}
    for tid, times in by_tid.items():
        held = {t: sum(1 for ts in times if _open_at(ivs, ts)) for t, ivs in work.items()
                if t not in seen}
        best = max(held, key=held.get, default=None)
        if best is not None and 2 * held[best] > len(times):
            alias[tid] = best
    return alias


def idle_gaps(device: list, t0: float, t1: float) -> list:
    """The (start, end) of every stretch of [t0, t1] that no device event covers."""
    gaps, last = [], t0
    for start, end in sorted((max(float(e["ts"]), t0), min(float(e["ts"]) + float(e["dur"]), t1))
                             for e in device):
        if end <= start:
            continue
        if start > last:
            gaps.append((last, start))
        last = max(last, end)
    if last < t1:
        gaps.append((last, t1))
    return gaps


def _program_label(work: dict, ops: dict, seen: set, t: float) -> str:
    """The innermost program span open at t on any thread, and what its thread ran."""
    from cardbench.harness.trace import _open_at

    best = None
    for tid, ivs in work.items():
        inner = _open_at(ivs, t)
        if inner and (best is None or inner[-1][0] > best[1][0]):
            best = (tid, inner[-1])
    if best is None:
        return OUTSIDE
    tid, (_, _, name) = best
    if tid not in seen:
        return f"{name[len(PROGRAM):]} / unprofiled"
    thread_ops = [iv for iv in ops.get(tid, []) if iv[0] <= t < iv[1]]
    return f"{name[len(PROGRAM):]} / {thread_ops[0][2] if thread_ops else 'python'}"


def window_report(kind: str, spans: list, rows: int, e2e: dict) -> dict:
    """What the window's spans show, no profiler running (module docstring)."""
    seconds = lambda s: (s.end_ns - s.start_ns) * 1e-9
    by_span: dict = {}
    for s in spans:
        count, total = by_span.get(s.name, (0, 0.0))
        by_span[s.name] = [count + 1, total + seconds(s)]
    forward = by_span.get("engine.forward", (0, 0.0))[1]
    out = {"e2e": e2e, "spans": len(spans), "by_span": by_span,
           "host_enqueue_us": 1e6 * forward / rows if rows and forward else None}
    if kind == "online":
        waits = [seconds(s) for s in spans if s.name == "serve.queue"]
        batches = [s for s in spans if s.name == "serve.batch"]
        if waits and batches:
            q = statistics.quantiles(waits, n=20)
            out["queue_wait_ms"] = {"p50": 1e3 * statistics.median(waits), "p95": 1e3 * q[18],
                                    "max": 1e3 * max(waits)}
            first = min(s.start_ns for s in spans if s.name == "serve.queue")
            wall = (max(s.end_ns for s in batches) - first) * 1e-9
            out["batcher_busy"] = 100.0 * sum(seconds(s) for s in batches) / wall
    return out


def snapshot() -> dict:
    from renderih_tpu_torch.kernels import conv3x3, fused_attention
    from renderih_tpu_torch.utils import trace

    return dict(trace.counters(), b2=conv3x3.launches.value, b1=fused_attention.launches.value)


def delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()}


def fill(counts: dict):
    rows, pad = counts.get("engine.rows", 0), counts.get("engine.pad_rows", 0)
    return 100.0 * rows / (rows + pad) if rows + pad else None


def kernel_calls(events: list, pattern: str) -> dict:
    """{host call: kernels} of the device kernels matching `pattern`, by the
    host call that launched each ("none" where the trace shows none)."""
    rx = re.compile(pattern)
    calls = {(e.get("args") or {}).get("correlation"): e["name"] for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")}
    out: dict = {}
    for e in events:
        if e.get("cat") == "kernel" and rx.search(e.get("name", "")):
            name = calls.get((e.get("args") or {}).get("correlation"), "none")
            out[name] = out.get(name, 0) + 1
    return out


def slice_report(kind: str, kept: dict) -> dict:
    from cardbench.harness.readers import B1_KERNELS, B2_KERNELS

    res = kept["res"]
    s, records = res["slice"], kept["slice_spans"]
    program = summarize(kept["events"], records)
    forwards = len(s.forward_batches)
    in_slice = delta(kept["after_slice"], kept["at_slice"])
    per_image = lambda seconds: 1e6 * seconds / s.images if s.images else None
    by_span, by_range = program["by_span"], s.by_range
    twins = {
        "encoder_mid_us": [per_image(by_span.get("model.encoder", 0.0)
                                     + by_span.get("model.mid_model", 0.0)),
                           per_image(by_range.get("encoder", 0.0) + by_range.get("mid_model", 0.0))],
        "decoder_us": [per_image(by_span.get("model.decoder", 0.0)),
                       per_image(by_range.get("decoder", 0.0))],
    }
    if kind == "online":
        w = res["window"]
        twins["fill_window"] = [fill(delta(kept["at_slice"], kept["at_window"])),
                                100.0 * w["requests"] / sum(w["forward_batches"])]
        twins["fill_slice"] = [fill(in_slice), 100.0 * s.images / sum(s.forward_batches)]
    gaps = sorted(program["gaps"].items(), key=lambda kv: -kv[1])
    return {
        "spans": len(records), "clock_offset_us": program["clock_offset_us"],
        "wall_s": s.wall_s, "busy_s": s.busy_s,
        "idle_s": sum(program["gaps"].values()), "outside_share": program["outside_share"],
        "gaps": [[label, seconds] for label, seconds in gaps],
        "by_span": program["by_span"], "launches_by_span": program["launches_by_span"],
        "forwards": forwards,
        "launches_per_forward": (program["launches_by_span"].get("engine.forward", 0) / forwards
                                 if forwards else None),
        "kernel_launches_per_forward": ({k: in_slice[k] / forwards for k in ("b1", "b2")}
                                        if forwards else None),
        "counters_in_slice": in_slice, "twins": twins,
        "b1_b2_kernels_by_call": kernel_calls(kept["events"], B1_KERNELS + "|" + B2_KERNELS),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    from cardbench import run as runner

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(w for w in bench["workloads"] if w["name"] == args.workload)
    traffic = json.loads((ROOT / "cardbench" / "traffic" / f"{entry['traffic']}.json").read_text())
    # run.py's process settings, which it makes before torch loads: the
    # wrappers below load torch first
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    if traffic.get("cores"):
        runner.hold_to_cores(traffic["cores"])
    from cardbench.harness import trace as harness_trace
    from renderih_tpu_torch.utils import trace

    kind = importlib.import_module(f"cardbench.kinds.{traffic['kind']}")
    kept: dict = {}
    summarize_slice, profile_slice, run = harness_trace.summarize, kind.profile_slice, kind.run

    # the harness's kinds have no place for the program's tracer: these three
    # wrappers turn it on at the window's open, drain it before and after the
    # slice, and keep the slice's chrome trace
    def summarize_and_keep(events):
        kept["events"] = events
        return summarize_slice(events)

    def profile_and_drain(fn):
        kept["window_spans"] = trace.drain()
        kept["at_slice"] = snapshot()
        try:
            return profile_slice(fn)
        finally:
            kept["after_slice"] = snapshot()
            kept["slice_spans"] = trace.drain()
            trace.enable(False)

    def run_and_keep(cell, setup_done):
        def window_opens():
            kept["at_window"] = snapshot()
            trace.drain()
            trace.enable(True)
            return setup_done()
        try:
            kept["res"] = run(cell, window_opens)
        finally:
            trace.enable(False)
        return kept["res"]

    harness_trace.summarize = summarize_and_keep
    kind.profile_slice, kind.run = profile_and_drain, run_and_keep
    rc = runner.main(["--workload", args.workload, "--seed", str(args.seed),
                      "--seconds", str(args.seconds), "--trace", "1"])
    if rc != 0 or "events" not in kept:
        return rc or 1
    rows = delta(kept["at_slice"], kept["at_window"]).get("engine.rows", 0)
    out = {"window": window_report(traffic["kind"], kept["window_spans"], rows, kept["res"]["e2e"]),
           "slice": slice_report(traffic["kind"], kept)}
    line = json.dumps(out)
    print("program_trace: " + line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
