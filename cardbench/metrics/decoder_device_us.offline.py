"""Device microseconds per image of the work launched inside the decoder calls
of the profiled slice."""

from cardbench.harness.readers import range_us_per_image


def read(cell, res):
    return range_us_per_image(res, ("decoder",))
