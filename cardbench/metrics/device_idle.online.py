"""The share of the profiled slice's wall time in which no device event
(kernel, memcpy, memset) ran."""

from cardbench.harness.readers import idle


def read(cell, res):
    return idle(res)
