"""Offline batch inference: one closed-loop client calls
`InferenceEngine.predict` with `batch` images at a time, each request due when
the previous one returned.

Traffic keys: `batch` (images a request), `buckets` (the engine's),
`pool_images` (distinct seeded images; request r sends the r-th block of
`batch` of them, cycling), `warmup_requests`, `check_requests` (requests whose
outputs are kept, drawn uniformly from all the window's requests by reservoir
sampling from the seed), `trace_requests` (requests profiled after the window
in a `--trace 1` run), and, read by `run.py` before any thread starts,
`cores` (the CPU cores the run's process is held to; any kind may give it).

End-to-end: `infer_images_per_s`, the images of the requests that returned
inside the window over the window's seconds; `latency_p95_ms`, the 95th
percentile of every request's time from due to outputs on the host. The
window's decoder calls are sampled for the decoder's check
(`Cell.decoder_capture`), and each request's return time and latency are kept
(`timeline`) for the run's line by quarter of the window.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from cardbench.harness import cell as cellmod
from cardbench.harness.hooks import ForwardCounter, ModuleRanges
from cardbench.harness.trace import profile_slice

MODEL_PARTS = ("encoder", "mid_model", "decoder")


def run(cell: cellmod.Cell, setup_done) -> dict:
    t = cell.traffic
    n, pool = t["batch"], cell.pool()
    blocks = len(pool) // n
    engine = cell.engine()
    request = lambda r: pool[(r % blocks) * n:(r % blocks + 1) * n]
    for r in range(t["warmup_requests"]):
        engine.predict(request(r))
    cell.sync()
    counter = ForwardCounter(engine.model)
    decoder = cell.decoder_capture(engine.model)
    setup_s = setup_done()

    rng, kept, k = cell.rng(cellmod.SAMPLE), [], t["check_requests"]
    latencies, returns, done_images, r = [], [], 0, 0
    with cellmod.window_without_gc():
        due = opened = time.perf_counter()
        close = due + cell.seconds
        while due < close:
            out = engine.predict(request(r))
            returned = time.perf_counter()
            latencies.append(returned - due)
            returns.append(returned - opened)
            if returned <= close:
                done_images += n
            # reservoir sampling: every request equally likely to be kept
            if len(kept) < k:
                kept.append((r, out))
            else:
                j = int(rng.integers(0, r + 1))
                if j < k:
                    kept[j] = (r, out)
            due, r = returned, r + 1
    window = {"seconds": cell.seconds, "images": done_images, "requests": r,
              "forward_batches": counter.seen()}
    counter.remove()
    decoder.remove()

    slice_ = None
    if cell.trace:
        ranges = ModuleRanges(engine.model, MODEL_PARTS)
        counter = ForwardCounter(engine.model)
        first = r
        slice_ = profile_slice(lambda: [engine.predict(request(first + i))
                                        for i in range(t["trace_requests"])])
        slice_.forward_batches, slice_.images = counter.seen(), n * t["trace_requests"]
        ranges.remove()
        counter.remove()

    peak = torch.cuda.max_memory_allocated(cell.device) if cell.device.type == "cuda" else 0
    del engine
    if cell.device.type == "cuda":
        cellmod.free_device()
    kept.sort(key=lambda e: e[0])
    rows = np.concatenate([np.arange((rq % blocks) * n, (rq % blocks + 1) * n) for rq, _ in kept])
    got = {k: np.concatenate([o[k] for _, o in kept]) for k in kept[0][1]}
    return {
        "e2e": {"infer_images_per_s": done_images / cell.seconds,
                "latency_p95_ms": 1e3 * float(np.percentile(latencies, 95)),
                "setup_s": setup_s},
        "attempted": r, "failed": 0, "window": window, "slice": slice_,
        "memory_peak_bytes": peak, "check_rows": rows, "check_outputs": got,
        "decoder_kept": decoder.kept, "timeline": (np.asarray(returns), np.asarray(latencies)),
        "notes": {"requests": r, "latency_p50_ms": 1e3 * float(np.median(latencies)),
                  "checked_requests": [rq for rq, _ in kept]},
    }
