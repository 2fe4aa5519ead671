"""The data axis over torch devices (counterpart of
`renderih_tpu/parallel/mesh.py:make_mesh`, `batch_sharding`, `shard_batch`).

A `Mesh` is an ordered tuple of devices on one process: a data axis of
`len(devices)`. A batch laid on it is split into one contiguous slice per
device, in device order (JAX's `P("data")` on the leading axis), and the
per-device results are gathered back in that order. The evaluator and
the serving engine take one (`mesh=`): the model is replicated on every
device and each batch runs split over them. Training over several
processes goes through `parallel/dist.py` instead.

Tensor parallelism (`model > 1`, JAX's `param_sharding_rules`) is not
ported: ROADMAP.md lists it under "Do not port". ZeRO-1 (JAX's
`zero1_sharding`) is `train/state.py`'s optimizer over a process group.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Mesh:
    devices: tuple

    @property
    def n_data(self) -> int:
        return len(self.devices)


def make_mesh(data: int = -1, model: int = 1, devices=None) -> Mesh:
    """A `data` x 1 mesh over `devices` (default: every visible CUDA card;
    without one it raises unless devices are given). data = -1 means all
    of them; otherwise `data` must equal their number."""
    if model != 1:
        raise NotImplementedError(
            f"model={model}: tensor parallelism is not ported (ROADMAP.md, "
            "'Do not port': the rules of renderih_tpu/parallel/mesh.py:55-80)")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: make_mesh lays the data axis over the "
                               "cards; pass devices= to lay it elsewhere")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    if data == -1:
        data = len(devices)
    if data != len(devices) or data < 1:
        raise ValueError(f"mesh {data}x{model} != {len(devices)} devices")
    return Mesh(devices)


def split_batch(mesh: Mesh, x: torch.Tensor) -> list:
    """`x`'s leading axis in `mesh.n_data` contiguous slices, slice i on
    device i (copies are queued, not waited for; a slice already on its
    device is `x` itself or a view of it)."""
    n = x.shape[0]
    if n % mesh.n_data:
        raise ValueError(f"batch {n} not divisible by the data axis {mesh.n_data}")
    return [part.to(dev, non_blocking=True)
            for part, dev in zip(x.split(n // mesh.n_data), mesh.devices)]


def gather(parts: list, device: torch.device) -> torch.Tensor:
    """The per-device slices back in one tensor on `device`, in mesh order
    (a single slice as it is, moved to `device` if it lies elsewhere)."""
    if len(parts) == 1:
        return parts[0].to(device)
    return torch.cat([p.to(device) for p in parts])
