"""The program's spans as `program_trace.py` reads them, on records and a
trace written by hand: the harness's own summary unchanged by the program's
`renderih.*` ranges, the idle gaps outside every `cardbench.*` range named
by the program's spans, and the window's figures from the records alone."""

from __future__ import annotations

import statistics

import pytest

from cardbench import program_trace
from cardbench.harness.trace import summarize
from renderih_tpu_torch.utils.trace import Span

OFFSET_US = 1000.0  # the records' clock runs this far behind the hand-written trace's
MAIN, BATCHER = 1, 99


def X(cat, name, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def record(name, start_us, end_us, tid=MAIN, rid=-1, id_=0):
    """A span record whose times, placed by OFFSET_US, read start_us..end_us on the trace."""
    to_ns = lambda us: int(round((us - OFFSET_US) * 1e3))
    return Span(name, tid, to_ns(start_us), to_ns(end_us), -1, rid, id_)


HARNESS = [  # the harness's ranges, host calls and device events (test_cardbench_trace.py's)
    X("user_annotation", "cardbench.slice", 0, 100),
    X("user_annotation", "cardbench.encoder", 5, 30),
    X("user_annotation", "cardbench.decoder", 40, 30),
    X("cpu_op", "aten::conv2d", 6, 4),
    X("cuda_runtime", "cudaLaunchKernel", 7, 1, correlation=1),
    X("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=2),
    X("cpu_op", "aten::linear", 41, 20),
    X("cuda_runtime", "cudaLaunchKernel", 42, 1, correlation=3),
    X("cuda_runtime", "cudaMemcpyAsync", 86, 1, correlation=4),
    X("cuda_runtime", "cudaStreamSynchronize", 87, 2),
    X("kernel", "void conv3x3_wgmma<64>(CUtensorMap)", 10, 20, tid=7, correlation=1),
    X("kernel", "cudnn_bn", 25, 10, tid=7, correlation=2),
    X("kernel", "void mha_mma_kernel<float, 64>(...)", 50, 5, tid=7, correlation=3),
    X("gpu_memcpy", "Memcpy DtoH", 90, 5, tid=8, correlation=4),
]
# the program's spans on the profiled thread, as ranges and as records
PROGRAM_RANGES = [("engine.predict", 0, 95), ("engine.forward", 4, 72), ("model.encoder", 5, 35),
                  ("model.decoder", 40, 70), ("engine.copy_back", 85, 95)]
PROGRAM = [X("user_annotation", "renderih." + n, a, b - a) for n, a, b in PROGRAM_RANGES] + [
    X("user_annotation", "renderih.serve.queue", 1, 0.5)]  # a wait's mark at its start
RECORDS = [record(n, a, b, id_=i) for i, (n, a, b) in enumerate(PROGRAM_RANGES)] + [
    record("serve.queue", 1, 60, rid=0, id_=10),            # a wait: no thread's work
    record("serve.batch", 94, 100, tid=BATCHER, id_=11)]    # a thread the profiler did not see


def test_program_ranges_leave_the_harness_summary_as_it_was():
    plain, both = summarize(HARNESS), summarize(HARNESS + PROGRAM)
    assert both.by_range == plain.by_range and both.by_name == plain.by_name
    assert (both.busy_s, both.wall_s, both.events) == (plain.busy_s, plain.wall_s, plain.events)
    assert both.gaps == plain.gaps and "outside any range" in plain.gaps


# the batcher's runtime call, under the thread id the trace gives a thread it did not record,
# and its kernel (inside a busy stretch, so the gaps stay as they are)
BATCHER_CALLS = [X("cuda_runtime", "cudaLaunchKernel", 95.5, 0.2, tid=555, correlation=5),
                 X("kernel", "void at::elementwise", 91, 3, tid=7, correlation=5)]


def test_outside_any_range_is_named_by_the_program_span():
    got = program_trace.summarize(HARNESS + PROGRAM + BATCHER_CALLS, RECORDS)
    assert got["clock_offset_us"] == pytest.approx(OFFSET_US)
    # outside any range at their start, cut where a span or a cardbench range begins: 0-10
    # into engine.predict 0-4, engine.forward 4-5 and the harness's encoder 5-10; 35-50 into
    # engine.forward 35-40 and decoder 40-50. 55-90 starts in decoder / aten::linear and is
    # labelled whole, as the harness labels it; 95-100 lies in the batcher's serve.batch,
    # whose thread the profiler did not record (records only).
    assert got["gaps"] == {"engine.predict / python": pytest.approx(4e-6),
                           "engine.forward / python": pytest.approx(6e-6),
                           "encoder / python": pytest.approx(5e-6),
                           "decoder / python": pytest.approx(10e-6),
                           "decoder / aten::linear": pytest.approx(35e-6),
                           "serve.batch / unprofiled": pytest.approx(5e-6)}
    assert got["outside_share"] == 0.0
    assert got["by_span"] == {"engine.predict": pytest.approx(40e-6),
                              "engine.forward": pytest.approx(35e-6),
                              "model.encoder": pytest.approx(30e-6),
                              "model.decoder": pytest.approx(5e-6),
                              "engine.copy_back": pytest.approx(5e-6),
                              "serve.batch": pytest.approx(3e-6)}
    # the synchronise is no launch; the wait's mark holds none
    assert got["launches_by_span"] == {"engine.predict": 4, "engine.forward": 3,
                                       "model.encoder": 2, "model.decoder": 1,
                                       "engine.copy_back": 1, "serve.batch": 1}


def test_without_program_spans_only_the_harness_ranges_name_gaps():
    got = program_trace.summarize(HARNESS, [])
    assert got["clock_offset_us"] is None and got["by_span"] == {}
    assert sum(got["gaps"].values()) == pytest.approx(sum(summarize(HARNESS).gaps.values()))
    assert got["gaps"] == {"outside any range": pytest.approx(15e-6),  # 0-5, 35-40, 95-100
                           "encoder / python": pytest.approx(5e-6),
                           "decoder / python": pytest.approx(10e-6),
                           "decoder / aten::linear": pytest.approx(35e-6)}
    assert got["outside_share"] == pytest.approx(15 / 65)


def _timed(name, seconds, tid=MAIN, rid=-1):
    """Records of `name`, the i-th starting at i s and lasting seconds[i]."""
    return [Span(name, tid, int(1e9 * i), int(1e9 * (i + s)), -1, rid, i)
            for i, s in enumerate(seconds)]


def test_window_report_offline_reads_forward_seconds_per_row():
    records = _timed("engine.forward", [0.01, 0.02]) + _timed("engine.upload", [1.0])
    got = program_trace.window_report("offline", records, 256, {"infer_images_per_s": 1.0})
    assert got["host_enqueue_us"] == pytest.approx(1e6 * 0.03 / 256)
    assert got["by_span"] == {"engine.forward": [2, pytest.approx(0.03)],
                              "engine.upload": [1, pytest.approx(1.0)]}
    assert got["e2e"] == {"infer_images_per_s": 1.0} and "queue_wait_ms" not in got
    assert program_trace.window_report("offline", [], 0, {})["host_enqueue_us"] is None


def test_window_report_online_reads_waits_and_the_batchers_busy_share():
    waits = [0.001 * k for k in range(1, 101)]
    # waits start at 0..99 s; two batches, the last ending at 101.5 s
    records = (_timed("serve.queue", waits, tid=MAIN, rid=0)
               + [Span("serve.batch", BATCHER, int(1e9 * a), int(1e9 * b), -1, -1, 0)
                  for a, b in ((10, 40), (100, 101.5))]
               + _timed("serve.idle", [5.0], tid=BATCHER))
    got = program_trace.window_report("online", records, 100, {"latency_p95_ms": 1.0})
    assert got["queue_wait_ms"] == {"p50": pytest.approx(50.5),
                                    "p95": pytest.approx(1e3 * statistics.quantiles(waits, n=20)[18]),
                                    "max": pytest.approx(100.0)}
    assert got["batcher_busy"] == pytest.approx(100.0 * 31.5 / 101.5)
    assert got["host_enqueue_us"] is None  # no engine.forward records
