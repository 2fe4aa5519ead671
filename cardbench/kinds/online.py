"""Online single-image serving: an open-loop generator submits one image at a
time to `BatchingServer` at seeded arrival times, at a fixed offered rate.

Traffic keys: `rate_per_s` (offered images a second), `max_wait_ms` (the
batcher's coalescing wait), `buckets` (the engine's), `pool_images` (request i
sends pool image i mod P), `warmup_requests` (sent through the server after
`InferenceEngine.warmup`, which runs every bucket), `check_requests` (requests
whose outputs are checked, drawn from the seed), `trace_seconds` (arrivals
profiled after the window in a `--trace 1` run), `drain_s` (how long past the
window's close a request may still complete).

Arrivals: exactly rate x seconds requests, their times sorted uniform draws
over the window (a Poisson process given its count), so every seed offers the
same work at other times. A request is due at its arrival time, and its
latency runs from then to the moment its outputs are numpy on the host (the
future resolves). The generator's lateness (submit time past due) is reported
on an earlier line.

End-to-end: `latency_p95_ms` over every request of the window, those that
complete after the close included. The window's decoder calls are sampled for
the decoder's check (`Cell.decoder_capture`), and each request's due time and
latency are kept (`timeline`).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from cardbench.harness import cell as cellmod
from cardbench.harness.hooks import ForwardCounter, ModuleRanges
from cardbench.harness.trace import profile_slice
from cardbench.kinds.offline import MODEL_PARTS


def offer(server, pool: np.ndarray, times: np.ndarray, first: int = 0) -> tuple:
    """Submit pool image (first + i) mod P at `times[i]` seconds from now;
    a semaphore released as each finishes. Returns (start, futures, done
    times, lateness, that semaphore)."""
    n = len(times)
    done = np.full(n, np.nan)
    futures, lateness = [], np.zeros(n)
    remaining = threading.Semaphore(0)

    def finished(i):
        def cb(_):
            done[i] = time.perf_counter()
            remaining.release()
        return cb

    start = time.perf_counter()
    for i, at in enumerate(times):
        due = start + at
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        lateness[i] = time.perf_counter() - due
        fut = server.submit(pool[(first + i) % len(pool)])
        fut.add_done_callback(finished(i))
        futures.append(fut)
    return start, futures, done, lateness, remaining


def drain(remaining: threading.Semaphore, n: int, deadline: float) -> int:
    """Wait until `n` requests finished or `deadline` passed; the number finished."""
    got = 0
    while got < n and remaining.acquire(timeout=max(0.0, deadline - time.perf_counter())):
        got += 1
    return got


def arrivals(rng: np.random.Generator, rate: float, seconds: float) -> np.ndarray:
    return np.sort(rng.uniform(0.0, seconds, int(round(rate * seconds))))


def run(cell: cellmod.Cell, setup_done) -> dict:
    from renderih_tpu_torch.serve import BatchingServer

    t = cell.traffic
    pool = cell.pool()
    engine = cell.engine()
    server = BatchingServer(engine, max_wait_ms=t["max_wait_ms"])
    try:
        engine.warmup()
        warm = offer(server, pool, np.zeros(t["warmup_requests"]))
        if drain(warm[4], t["warmup_requests"], time.perf_counter() + 60.0) < t["warmup_requests"]:
            raise RuntimeError("the warm-up requests did not complete")
        cell.sync()
        counter = ForwardCounter(engine.model)
        decoder = cell.decoder_capture(engine.model)
        times = arrivals(cell.rng(cellmod.TRAFFIC), t["rate_per_s"], cell.seconds)
        setup_s = setup_done()

        with cellmod.window_without_gc():
            start, futures, done, lateness, remaining = offer(server, pool, times)
            close = start + cell.seconds
            finished = drain(remaining, len(times), close + t["drain_s"])
        latency = done - (start + times)
        failed = sum(1 for f in futures if not f.done() or f.exception() is not None)
        in_window = int(np.sum(done <= close))
        window = {"seconds": cell.seconds, "images": in_window, "requests": len(times),
                  "forward_batches": counter.seen()}
        counter.remove()
        decoder.remove()

        slice_ = None
        if cell.trace:
            ranges = ModuleRanges(engine.model, MODEL_PARTS)
            counter = ForwardCounter(engine.model)
            more = arrivals(cell.rng(cellmod.TRAFFIC + 100), t["rate_per_s"], t["trace_seconds"])

            def traced():
                res = offer(server, pool, more, first=len(times))
                drain(res[4], len(more), time.perf_counter() + t["drain_s"])

            slice_ = profile_slice(traced)
            slice_.forward_batches, slice_.images = counter.seen(), len(more)
            ranges.remove()
            counter.remove()

        sample = np.sort(cell.rng(cellmod.SAMPLE).choice(len(times), t["check_requests"],
                                                         replace=False))
        got_ok = [i for i in sample if futures[i].done() and futures[i].exception() is None]
        outs = [futures[i].result() for i in got_ok]
    finally:
        server.close()
    peak = torch.cuda.max_memory_allocated(cell.device) if cell.device.type == "cuda" else 0
    del engine, server, futures
    if cell.device.type == "cuda":
        cellmod.free_device()
    finite = latency[np.isfinite(latency)]
    # a request that never completed counts past every limit
    tail = np.concatenate([finite, np.full(len(times) - len(finite), np.inf)])
    return {
        "e2e": {"latency_p95_ms": 1e3 * float(np.percentile(tail, 95)), "setup_s": setup_s},
        "attempted": len(times), "failed": failed,
        "window": window, "slice": slice_, "memory_peak_bytes": peak,
        "decoder_kept": decoder.kept, "timeline": (times, latency),
        "check_rows": np.asarray(got_ok) % len(pool),
        "check_outputs": {k: np.stack([o[k] for o in outs]) for k in outs[0]} if outs else {},
        "notes": {"offered": len(times), "finished": finished, "completed_in_window": in_window,
                  "offered_per_s": len(times) / cell.seconds,
                  "completed_per_s_in_window": in_window / cell.seconds,
                  "latency_p50_ms": 1e3 * float(np.median(tail)),
                  "lateness_p50_ms": 1e3 * float(np.median(lateness)),
                  "lateness_max_ms": 1e3 * float(lateness.max()),
                  "forwards": len(window["forward_batches"])},
    }
