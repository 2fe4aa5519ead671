"""B1's share of its roofline in the ViT trunk: the least time of every
bfloat16 B1 site with D = 64 of the profiled forwards (the trunk's blocks)
over the device time of B1's bfloat16 D = 64 instance there. The pooled
block's D = 128 launch and the decoder's float32 launches stay out of both
sides."""

from cardbench.harness import peaks
from cardbench.harness.work import forward_work

KERNEL = r"\bmha_mma_kernel<__nv_bfloat16, 64>"


def trunk_sites(work):
    return [l for l in work.b1 if l.dtype == "bfloat16" and l.shape[-1] == 64]


def read(cell, res):
    s = res.get("slice")
    if s is None:
        return None
    seconds, _ = s.seconds_matching(KERNEL)
    bound = sum(peaks.bound_s(l.n_bytes, l.flops, l.dtype, l.exps)
                for b in s.forward_batches for l in trunk_sites(forward_work(cell.config, b)))
    return 100.0 * bound / seconds if seconds > 0 and bound > 0 else None
