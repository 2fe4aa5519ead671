"""What the per-layer metric readers (`cardbench/metrics/<name>.py`) share.

Each reader is `read(cell, res) -> float | None`: `cell` the run's
`harness.cell.Cell`, `res` what its kind returned (`window`: the measured
window's seconds, images, requests and forward batches; `slice`: the profiled
slice's `harness.trace.SliceSummary`, or None). A reader that finds nothing to
read returns None, and the metric is left out of the line.

Kernel names are the program's (`csrc/conv3x3.cu`, `csrc/fused_attention.cu`);
the work is the reference's (`harness/work.py`).
"""

from __future__ import annotations

from cardbench.harness import peaks
from cardbench.harness.work import forward_work

B2_KERNELS = r"\b(conv3x3_simt|conv3x3_wgmma|conv3x3_tf32x3|tf32_split_weights)\b"
B1_KERNELS = r"\bmha_mma_kernel\b"


def roofline(cell, res, site: str, pattern: str):
    """100 x (the least time of every `site` launch ("b2" or "b1") of the
    slice's forwards) / (the device time of the kernels matching `pattern`)."""
    s = res.get("slice")
    if s is None:
        return None
    seconds, _ = s.seconds_matching(pattern)
    if seconds <= 0:
        return None
    bound = sum(peaks.bound_s(l.n_bytes, l.flops, l.dtype, l.exps)
                for b in s.forward_batches for l in getattr(forward_work(cell.config, b), site))
    return 100.0 * bound / seconds


def idle(res):
    """100 x the share of the slice's wall time that no device event covers."""
    s = res.get("slice")
    if s is None or s.wall_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.wall_s)


def range_us_per_image(res, names: tuple):
    """Microseconds of device time launched inside the host ranges `names`, per
    real image of the slice."""
    s = res.get("slice")
    if s is None or not s.images:
        return None
    seconds = sum(s.by_range.get(n, 0.0) for n in names)
    return 1e6 * seconds / s.images if seconds > 0 else None


def step_mfu(cell, res):
    """100 x the least time of one image's forward (each op's FLOPs over the peak
    of its dtype) over the window's measured seconds per image."""
    w = res["window"]
    if not w["images"] or not w["forward_batches"]:
        return None
    batch = max(w["forward_batches"])
    work = forward_work(cell.config, batch)
    ideal = sum(peaks.ops_s(flops, dtype) for dtype, flops in work.flops.items()) / batch
    return 100.0 * ideal / (w["seconds"] / w["images"])
