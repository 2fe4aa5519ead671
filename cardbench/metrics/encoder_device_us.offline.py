"""Device microseconds per image of the work launched inside the encoder and
mid-model calls of the profiled slice."""

from cardbench.harness.readers import range_us_per_image


def read(cell, res):
    return range_us_per_image(res, ("encoder", "mid_model"))
