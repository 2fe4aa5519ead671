"""Counters and host ranges that the benchmark attaches to the program from
its own files, around the calls into each layer.

  * `ForwardCounter`: a forward pre-hook on the served model that records the
    batch of every forward (the bucket it ran at);
  * `ModuleRanges`: forward pre- and post-hooks on named children of the model
    that open and close a `torch.profiler.record_function` range
    `cardbench.<child>` around each call, so that a profiled slice can tie the
    device's work to the encoder, the mid model or the decoder;
  * `DecoderCapture`: hooks on the decoder that keep a seeded sample of its
    calls' inputs and outputs, which the check holds against the reference's
    decoder at the configuration's precision.
"""

from __future__ import annotations

import threading

import torch


class ForwardCounter:
    def __init__(self, model: torch.nn.Module):
        self.batches: list = []
        self._lock = threading.Lock()
        self._handle = model.register_forward_pre_hook(self._hook)

    def _hook(self, module, args) -> None:
        with self._lock:
            self.batches.append(int(args[0].shape[0]))

    def seen(self) -> list:
        """The batch of every forward so far."""
        with self._lock:
            return list(self.batches)

    def remove(self) -> None:
        self._handle.remove()


class ModuleRanges:
    def __init__(self, model: torch.nn.Module, children: tuple):
        self._open = threading.local()
        self._handles = []
        for name in children:
            child = getattr(model, name)
            self._handles.append(child.register_forward_pre_hook(self._enter(name)))
            self._handles.append(child.register_forward_hook(self._exit))

    def _stack(self) -> list:
        if not hasattr(self._open, "stack"):
            self._open.stack = []
        return self._open.stack

    def _enter(self, name: str):
        def hook(module, args):
            rf = torch.profiler.record_function(f"cardbench.{name}")
            rf.__enter__()
            self._stack().append(rf)
        return hook

    def _exit(self, module, args, out):
        self._stack().pop().__exit__(None, None, None)

    def remove(self) -> None:
        for h in self._handles:
            h.remove()


class DecoderCapture:
    """Keeps what the model's decoder took and gave in `keep` of its calls,
    drawn uniformly over the calls by reservoir sampling from `rng`: from each
    kept call, `rows` rows of the batch at a seeded offset and stride, of its
    inputs (the global feature and the feature maps, as the decoder got them)
    and of its outputs (`OUTPUT_KEYS` of each hand). The rows are copied on the
    device by strided views, so a kept call costs a few copies and no host
    synchronisation. `kept` is a list of (call index, inputs, outputs)."""

    OUTPUT_KEYS = ("verts3d", "verts2d", "scale", "trans2d")

    def __init__(self, decoder: torch.nn.Module, rng, keep: int, rows: int):
        self.kept: list = []
        self._rng, self._keep, self._rows = rng, keep, rows
        self._calls, self._pending = 0, None
        self._handles = [decoder.register_forward_pre_hook(self._enter),
                         decoder.register_forward_hook(self._exit)]

    def _take(self, t: torch.Tensor, at: tuple) -> torch.Tensor:
        start, step = at
        return t[start::step][:self._rows].clone()

    def _enter(self, module, args) -> None:
        i, self._calls = self._calls, self._calls + 1
        if i < self._keep:
            slot = i
        else:
            slot = int(self._rng.integers(0, i + 1))
            if slot >= self._keep:
                self._pending = None
                return
        batch = int(args[0].shape[0])
        step = max(1, batch // self._rows)
        at = (int(self._rng.integers(0, step)), step)
        inputs = {"global": self._take(args[0], at), "fmaps": [self._take(f, at) for f in args[1]]}
        self._pending = (slot, i, at, inputs)

    def _exit(self, module, args, out) -> None:
        if self._pending is None:
            return
        slot, i, at, inputs = self._pending
        self._pending = None
        # the port's `DecoderOutput` (per-hand dicts) or the reference's flat dict
        pick = ((lambda key, hand: out[f"{key}_{hand}"]) if isinstance(out, dict)
                else (lambda key, hand: getattr(out, key)[hand]))
        outputs = {f"{key}_{hand}": self._take(pick(key, hand), at)
                   for key in self.OUTPUT_KEYS for hand in ("left", "right")}
        if slot < len(self.kept):
            self.kept[slot] = (i, inputs, outputs)
        else:
            self.kept.append((i, inputs, outputs))

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
