"""The branches of the network's kinks, recorded in one run and taken in
another, so that two float32 runs of one step can be compared for their
rounding alone.

Two runs of a step (the card and the CPU, or one CPU thread and eight)
round differently. Where a ReLU input, or the runner-up of a max-pool
window, lies within rounding of its kink, the two runs take different
branches, and the gradients part by far more than rounding: up to ~0.1 of
a tensor's largest value at a random init, depending on the draw. The
first run records the side of every kink it took and the second takes the
same sides:

    with record_branches() as taken:
        step(...)                # e.g. on the card
    with take_branches(taken):
        step(...)                # the same step on the CPU

The second run then differentiates the same piece of the piecewise-smooth
function. Covered are `F.relu` and `F.max_pool2d`, through which every
`nn.ReLU`/`nn.MaxPool2d` also goes, and `F.hardswish` (kinks at ±3, in
the MANO-parameter head): the only kinks of `HandNet`'s forward. The
loss's smooth-L1 and the projection have no kink within rounding of their
inputs.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def _patched(relu, max_pool2d, hardswish):
    saved = F.relu, F.max_pool2d, F.hardswish
    F.relu, F.max_pool2d, F.hardswish = relu, max_pool2d, hardswish
    try:
        yield
    finally:
        F.relu, F.max_pool2d, F.hardswish = saved


def _hardswish_piece(x: torch.Tensor) -> torch.Tensor:
    """Which piece of hard-swish x is on: 0 (x <= -3: 0), 1 (x(x+3)/6), 2 (x >= 3: x)."""
    return (x > -3).to(torch.int8) + (x >= 3).to(torch.int8)


@contextlib.contextmanager
def record_branches():
    """Yields a list that fills, call by call, with each ReLU's mask
    (input > 0), each max-pool's indices and each hard-swish's pieces, on
    the device they ran on."""
    taken = []
    relu, max_pool2d, hardswish = F.relu, F.max_pool2d, F.hardswish

    def rec_relu(x, inplace=False):
        taken.append(("relu", x.detach() > 0))
        return relu(x, inplace=inplace)

    def rec_pool(x, kernel_size, stride=None, padding=0, dilation=1, ceil_mode=False,
                 return_indices=False):
        out, idx = max_pool2d(x, kernel_size, stride, padding, dilation, ceil_mode=ceil_mode,
                              return_indices=True)
        taken.append(("max_pool2d", idx))
        return (out, idx) if return_indices else out

    def rec_hardswish(x, inplace=False):
        taken.append(("hardswish", _hardswish_piece(x.detach())))
        return hardswish(x, inplace=inplace)

    with _patched(rec_relu, rec_pool, rec_hardswish):
        yield taken


@contextlib.contextmanager
def take_branches(taken: list):
    """Runs every ReLU, max-pool and hard-swish on the branches `taken`
    recorded, in the order recorded: a ReLU multiplies by its mask, a
    max-pool gathers at its indices, a hard-swish takes its recorded piece. Raises if the calls differ from the record's in kind,
    shape or number."""
    calls = iter(taken)

    def take(kind: str, shape) -> torch.Tensor:
        got_kind, branch = next(calls, (None, None))
        if got_kind != kind or tuple(branch.shape[:len(shape)]) != tuple(shape):
            raise RuntimeError(f"take_branches: a {kind} call of shape {tuple(shape)} where "
                               f"the record has {got_kind}"
                               + (f" of shape {tuple(branch.shape)}" if got_kind else ""))
        return branch

    def take_relu(x, inplace=False):
        mask = take("relu", x.shape).to(x.device)
        return x.mul_(mask) if inplace else x * mask

    def take_pool(x, kernel_size, stride=None, padding=0, dilation=1, ceil_mode=False,
                  return_indices=False):
        idx = take("max_pool2d", x.shape[:2]).to(x.device)
        out = x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
        return (out, idx) if return_indices else out

    def take_hardswish(x, inplace=False):
        piece = take("hardswish", x.shape).to(x.device)
        out = torch.where(piece == 2, x, x * (x + 3.0) / 6.0)
        out = torch.where(piece == 0, torch.zeros_like(x), out)
        return x.copy_(out) if inplace else out

    with _patched(take_relu, take_pool, take_hardswish):
        yield
    if next(calls, None) is not None:
        raise RuntimeError("take_branches: the run made fewer calls than the record")


def gradient_gaps(got: dict, want: dict) -> dict:
    """Each tensor's max|got − want| over its scale: the largest |want| of
    the tensor, and for a bias the larger of that and its weight's (some
    biases' gradients are rounding noise around 0: a key projection's, a
    constant on every logit; the stem BatchNorm's, a shift the next
    BatchNorms remove). A tensor that no loss term reaches must be 0 in
    both (inf otherwise)."""
    out = {}
    for k, g in want.items():
        w = k[:-len("bias")] + "weight"
        scale = float(g.abs().max())
        if k.endswith(".bias") and w in want:
            scale = max(scale, float(want[w].abs().max()))
        err = float((got[k].to(g.device) - g).abs().max())
        out[k] = err / scale if scale > 0 else (0.0 if err == 0 else float("inf"))
    return out
