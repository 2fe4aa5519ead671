"""Real images per device forward over the bucket each forward ran at, over the
measured window: the requests served over the sum of the forwards' batches
(a forward pre-hook on the served model counts the batches)."""


def read(cell, res):
    w = res["window"]
    total = sum(w["forward_batches"])
    return 100.0 * w["requests"] / total if total else None
