"""The whole forward's share of the card's peak in the offline cells: each op's
FLOPs over the peak of its dtype, summed, over the window's seconds per image."""

from cardbench.harness.readers import step_mfu


def read(cell, res):
    return step_mfu(cell, res)
