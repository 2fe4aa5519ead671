"""The reduction of a profiler trace to the slice summary, on a trace written
by hand: busy time as the union of device intervals, device time tied to the
host range open at each launch, idle gaps labelled by what the host ran."""

from __future__ import annotations

import pytest

from cardbench.harness import readers
from cardbench.harness.trace import summarize


def X(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


EVENTS = [
    X("user_annotation", "cardbench.slice", 0, 100),
    X("user_annotation", "cardbench.encoder", 5, 30),
    X("user_annotation", "cardbench.decoder", 40, 30),
    X("cpu_op", "aten::conv2d", 6, 4),
    X("cuda_runtime", "cudaLaunchKernel", 7, 1, correlation=1),
    X("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=2),
    X("cpu_op", "aten::linear", 41, 20),
    X("cuda_runtime", "cudaLaunchKernel", 42, 1, correlation=3),
    X("kernel", "void conv3x3_wgmma<64>(CUtensorMap)", 10, 20, tid=7, correlation=1),
    X("kernel", "cudnn_bn", 25, 10, tid=7, correlation=2),  # overlaps the first: 10..35
    X("kernel", "void mha_mma_kernel<float, 64>(...)", 50, 5, tid=7, correlation=3),
    X("gpu_memcpy", "Memcpy DtoH", 90, 5, tid=8),
]


def test_summary():
    s = summarize(EVENTS)
    assert s.wall_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx((25 + 5 + 5) * 1e-6)  # 10-35, 50-55, 90-95
    assert s.by_range["encoder"] == pytest.approx(30e-6)
    assert s.by_range["decoder"] == pytest.approx(5e-6)
    assert s.seconds_matching(readers.B2_KERNELS) == (pytest.approx(20e-6), 1)
    assert s.seconds_matching(readers.B1_KERNELS) == (pytest.approx(5e-6), 1)
    # gaps: 0-10 (encoder, conv2d at 6..10 ran to 10: python at 0 -> outside any range),
    # 35-50 (outside a range until 40, so labelled at 35), 55-90 (decoder / aten::linear), 95-100
    assert sum(s.gaps.values()) == pytest.approx(65e-6)
    assert s.gaps["decoder / aten::linear"] == pytest.approx(35e-6)
    assert readers.idle({"slice": s}) == pytest.approx(65.0)
    top = s.breakdown()
    assert top["device_ops"][0][0].startswith("void conv3x3_wgmma")
    assert top["idle_gaps"][0] == ["decoder / aten::linear", pytest.approx(35e-6)]


def test_readers_stay_silent_without_a_slice():
    res = {"slice": None, "window": {"seconds": 1.0, "images": 0, "requests": 0,
                                      "forward_batches": []}}
    assert readers.idle(res) is None
    assert readers.range_us_per_image(res, ("decoder",)) is None
    assert readers.roofline(None, res, "b2", readers.B2_KERNELS) is None
    assert readers.step_mfu(None, res) is None
