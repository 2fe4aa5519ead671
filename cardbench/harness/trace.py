"""A profiled slice of a run, reduced to a summary.

`profile_slice(fn)` runs `fn` under `torch.profiler` (CPU and CUDA
activities), inside a `cardbench.slice` range that ends after a device
synchronise, writes the profiler's chrome trace to a temporary file, reads it
back and deletes it. The summary keeps:
  * the slice's wall time (the `cardbench.slice` range) and the device's busy
    time: the union of the intervals of every device event (kernel, memcpy,
    memset) inside it;
  * device time by event name;
  * device time by host range: each device event is tied to the host call that
    launched it (the trace's correlation id) and counts for every
    `cardbench.*` range open on that thread at the launch;
  * the idle gaps of the device inside the slice, each labelled with what the
    host was doing when it began: the innermost `cardbench.*` range open then
    and the outermost operator running on that range's thread.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from dataclasses import dataclass, field

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "cardbench."


@dataclass
class SliceSummary:
    wall_s: float
    busy_s: float
    events: int
    by_name: dict = field(default_factory=dict)   # {name: [seconds, count]}
    by_range: dict = field(default_factory=dict)  # {range: device seconds}
    gaps: dict = field(default_factory=dict)      # {host label: idle seconds}
    forward_batches: list = field(default_factory=list)  # batch of each forward in the slice
    images: int = 0                               # real images served in the slice

    def seconds_matching(self, pattern: str) -> tuple:
        """(device seconds, launches) of the events whose name matches `pattern`."""
        rx = re.compile(pattern)
        hits = [v for name, v in self.by_name.items() if rx.search(name)]
        return sum(s for s, _ in hits), sum(n for _, n in hits)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[name[:160], s] for name, (s, _) in ops],
                "idle_gaps": [[label[:160], s] for label, s in gaps]}


def profile_slice(fn) -> SliceSummary:
    """Run `fn()` under the profiler and summarise the trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(PREFIX + "slice"):
            fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="cardbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return summarize(events)


def _intervals_by_tid(events, cat: str, prefix: str = "") -> dict:
    out: dict = {}
    for e in events:
        if e.get("cat") == cat and e.get("ph") == "X" and e.get("name", "").startswith(prefix):
            out.setdefault(e["tid"], []).append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                                                 e["name"]))
    for v in out.values():
        v.sort()
    return out


def _open_at(intervals: list, t: float) -> list:
    """The intervals of one thread open at time t, outermost first."""
    return [iv for iv in intervals if iv[0] <= t < iv[1]]


def summarize(events: list) -> SliceSummary:
    """The summary of a chrome trace's `traceEvents` (times in microseconds)."""
    ranges = _intervals_by_tid(events, "user_annotation", PREFIX)
    slices = [iv for ivs in ranges.values() for iv in ivs if iv[2] == PREFIX + "slice"]
    if not slices:
        raise RuntimeError("the trace holds no cardbench.slice range")
    t0, t1, _ = slices[0]
    launches = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None and e.get("cat") in ("cuda_runtime", "cuda_driver"):
            launches[corr] = (e["tid"], float(e["ts"]))
    ops = {tid: _outermost(ivs) for tid, ivs in _intervals_by_tid(events, "cpu_op").items()}
    device = [e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
    spans, by_name, by_range = [], {}, {}
    for e in device:
        start, dur = float(e["ts"]), float(e["dur"])
        s, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = [s + dur * 1e-6, n + 1]
        spans.append((max(start, t0), min(start + dur, t1)))
        launch = launches.get((e.get("args") or {}).get("correlation"))
        if launch is not None:
            for _, _, name in _open_at(ranges.get(launch[0], []), launch[1]):
                by_range[name[len(PREFIX):]] = by_range.get(name[len(PREFIX):], 0.0) + dur * 1e-6
    busy, gaps_at, last = 0.0, [], t0
    for start, end in sorted(s for s in spans if s[1] > s[0]):
        if start > last:
            gaps_at.append((last, start))
        if end > last:
            busy += end - max(start, last)
            last = end
    if last < t1:
        gaps_at.append((last, t1))
    gaps: dict = {}
    for start, end in gaps_at:
        label = _host_label(ranges, ops, start)
        gaps[label] = gaps.get(label, 0.0) + (end - start) * 1e-6
    return SliceSummary(wall_s=(t1 - t0) * 1e-6, busy_s=busy * 1e-6, events=len(device),
                        by_name=by_name, by_range=by_range, gaps=gaps)


def _outermost(intervals: list) -> list:
    """The intervals (sorted by start) that no other interval encloses."""
    out = []
    for iv in intervals:
        if not out or iv[0] >= out[-1][1]:
            out.append(iv)
    return out


def _host_label(ranges: dict, ops: dict, t: float) -> str:
    """What the host was doing at time t: the innermost cardbench range open on
    any thread, and the outermost operator running on that thread."""
    best = None
    for tid, ivs in ranges.items():
        inner = [iv for iv in _open_at(ivs, t) if iv[2] != PREFIX + "slice"]
        if inner and (best is None or inner[-1][0] > best[1][0]):
            best = (tid, inner[-1])
    if best is None:
        return "outside any range"
    tid, (_, _, name) = best
    thread_ops = ops.get(tid, [])
    i = bisect.bisect_right(thread_ops, (t, float("inf"), ""))
    op = thread_ops[i - 1][2] if i and thread_ops[i - 1][1] > t else "python"
    return f"{name[len(PREFIX):]} / {op}"
