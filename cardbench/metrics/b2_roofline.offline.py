"""B2's share of its roofline in the offline cells: the least time of every B2
launch of the profiled forwards over the device time of B2's kernels there."""

from cardbench.harness.readers import B2_KERNELS, roofline


def read(cell, res):
    return roofline(cell, res, "b2", B2_KERNELS)
