"""B1's share of its roofline in the offline cells: the least time of every B1
launch of the profiled forwards (bytes, FLOPs at the TF32 peak for float32, or
exponentials at the MUFU rate) over the device time of B1's kernel there."""

from cardbench.harness.readers import B1_KERNELS, roofline


def read(cell, res):
    return roofline(cell, res, "b1", B1_KERNELS)
