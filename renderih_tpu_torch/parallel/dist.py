"""Data-parallel training over a process group (counterpart of
`jax.distributed.initialize()`, `renderih_tpu/apps/train.py:136-143`, and
of the train step's in/out shardings, `renderih_tpu/train/trainer.py:256-276`).

One process a device. `init` joins the group from torchrun's environment
(`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`/`MASTER_PORT`): NCCL for
CUDA tensors, gloo for CPU ones; a caller may pass its own backend, rank,
world size and store (the tests use gloo and a `file://` store). Without a
group `rank()` is 0 and `world()` is 1.

What each rank computes is what JAX's `data = W` mesh computes:
  * the global batch of `batch_size × W` rows is drawn alike on every
    rank, and each keeps its rows (`rank_rows`). JAX's step splits the
    global batch into `accum` contiguous micro-batches and shards each on
    `data` (`renderih_tpu/train/trainer.py:175-196`), so at grad_accum = a
    rank r's micro-batch i is global rows [(i·W + r)·m, (i·W + r + 1)·m),
    m = G/(a·W); a rank does not hold one contiguous G/W block;
  * BatchNorm statistics are global over each micro-batch
    (`models/layers.py:BatchNorm2d`);
  * gradients are averaged over the ranks once a step
    (`average_gradients`), the loss terms too (`mean_over_ranks`), so every
    rank applies the same update and logs the global-mean terms.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

# bucket size of the gradient all-reduce, in elements (128 MB of float32)
_BUCKET = 1 << 25


def active() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world() -> int:
    return dist.get_world_size() if active() else 1


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def init(device: torch.device, backend: str | None = None, init_method: str = "env://",
         rank: int | None = None, world_size: int | None = None) -> torch.device:
    """Join the process group (once; a group already joined is kept) and
    return this rank's device: `cuda:LOCAL_RANK` for a card given without
    an index, else `device`. The backend defaults to NCCL on a card and
    gloo on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local_rank())
        torch.cuda.set_device(device)
    if not active():
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        kwargs = {} if rank is None else {"rank": rank, "world_size": world_size}
        if backend == "nccl":
            kwargs["device_id"] = device
        dist.init_process_group(backend, init_method=init_method, **kwargs)
    return device


def rank_rows(global_batch: int, world: int, rank: int, accum: int = 1) -> np.ndarray:
    """The global-batch rows rank `rank` of `world` holds, micro-batch by
    micro-batch: [(i·W + r)·m, (i·W + r + 1)·m) for i < accum, m =
    global_batch / (accum·W)."""
    if global_batch % (accum * world):
        raise ValueError(f"global batch {global_batch} not divisible by grad_accum "
                         f"{accum} x world {world}")
    m = global_batch // (accum * world)
    return np.concatenate([np.arange((i * world + rank) * m, (i * world + rank + 1) * m)
                           for i in range(accum)])


def mean_over_ranks(values: torch.Tensor) -> torch.Tensor:
    """`values` summed over the ranks and divided by the world size (in
    place; identity without a group)."""
    if active():
        dist.all_reduce(values)
        values.div_(world())
    return values


def average_gradients(params: list) -> None:
    """Every parameter's `.grad` replaced by its mean over the ranks: one
    all-reduce of the flattened gradients a bucket of up to `_BUCKET`
    elements (exact at world 1)."""
    if not active():
        return
    inv = 1.0 / world()
    bucket, size = [], 0
    for i, p in enumerate(params):
        bucket.append(p.grad)
        size += p.grad.numel()
        if size >= _BUCKET or i == len(params) - 1:
            flat = torch.cat([g.reshape(-1) for g in bucket])
            dist.all_reduce(flat)
            flat.mul_(inv)
            torch._foreach_copy_(bucket, [f.view_as(g) for f, g in
                                          zip(flat.split([g.numel() for g in bucket]), bucket)])
            bucket, size = [], 0


def any_rank(flag: bool, device: torch.device) -> bool:
    """Whether `flag` is set on any rank (a MAX all-reduce; the flag itself
    without a group)."""
    if not active():
        return flag
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def barrier() -> None:
    if active():
        dist.barrier()
