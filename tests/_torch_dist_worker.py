"""Ranks of the port's data-parallel tests (`tests/test_torch_parallel.py`).

A spawned process imports this module, not the test module, so that it
imports no JAX: the test starts W processes with `start_world`, each runs
one of the entry functions below on its rank of a gloo group joined
through a `file://` store in its work directory (or on no group), reads
the inputs the test wrote there once the test says they are ready and
writes what it computed beside them. Each process runs on one CPU thread.
"""

from __future__ import annotations

import hashlib
import traceback

import numpy as np
import torch

WORLD = 2
SPE = 10
READY_TIMEOUT = 300  # seconds a process waits for the test's inputs
BN_BUFFERS = (".running_mean", ".running_var")


def ready_event():
    """An event the test sets once the inputs are written (`start_world`)."""
    return torch.multiprocessing.get_context("spawn").Event()


def start_world(fn, workdir: str, world: int = WORLD, ready=None, group: bool = True) -> list:
    """`fn(rank, world, workdir)` in `world` new processes (spawned), each
    in the gloo group (without one if not `group`) and, given `ready`,
    called once it is set; returns them started. The processes import
    and join while the test prepares the inputs."""
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_run, args=(fn, r, world, workdir, ready, group), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def join_world(procs: list, timeout: float) -> list:
    """Wait for every process up to `timeout` seconds in all; kill the ones
    still running. Returns the exit codes (None for a killed process)."""
    import time

    end = time.monotonic() + timeout
    codes = []
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
        if p.is_alive():
            p.kill()
            p.join(10)
            codes.append(None)
        else:
            codes.append(p.exitcode)
    return codes


def _run(fn, rank: int, world: int, workdir: str, ready, group: bool) -> None:
    torch.set_num_threads(1)
    from renderih_tpu_torch.parallel import dist

    if group:
        dist.init("cpu", backend="gloo", init_method=f"file://{workdir}/store",
                  rank=rank, world_size=world)
    if ready is not None and not ready.wait(READY_TIMEOUT):
        raise TimeoutError(f"the inputs were not ready within {READY_TIMEOUT} s")
    fn(rank, world, workdir)


# ---------------------------------------------------------------------------
# the module world of tests/test_torch_parallel.py


def _state(sd: dict, overrides: dict):
    from renderih_tpu_torch.assets import make_synthetic_assets
    from renderih_tpu_torch.config import load_config
    from renderih_tpu_torch.models import build_model
    from renderih_tpu_torch.train.state import create_train_state

    cfg = load_config(overrides=overrides)
    assets = make_synthetic_assets(0)
    model = build_model(cfg, assets)
    model.load_state_dict(sd)
    return cfg, assets, create_train_state(cfg, model, SPE)


def _local(batch: dict, rows) -> dict:
    return {k: torch.as_tensor(v)[torch.as_tensor(rows)] for k, v in batch.items()}


def port_step(sd: dict, overrides: dict, batch: dict, rows=None, steps: int = 1):
    """`steps` steps of the port from `sd` on `batch` (global rows `rows`
    of it; all without a group); (state, [terms of each step])."""
    from renderih_tpu_torch.train.trainer import make_train_step

    cfg, assets, state = _state(sd, overrides)
    step = make_train_step(cfg, assets, SPE, "cpu")
    local = batch if rows is None else _local(batch, rows)
    terms = [{k: float(v) for k, v in step(state, dict(local)).items()} for _ in range(steps)]
    return state, terms


def digests(tensors: dict) -> dict:
    """name -> SHA-1 of the tensor's bytes: bit-for-bit comparisons without
    writing the tensors."""
    return {k: hashlib.sha1(v.detach().cpu().contiguous().numpy().tobytes()).hexdigest()
            for k, v in tensors.items()}


def snapshot(state, keep: tuple = ()) -> dict:
    """`state` on the CPU, by parameter name: the BatchNorm statistics,
    the step counters and SHA-1 digests of every model tensor and every
    optimizer state; the tensors of the parts in `keep` ("model",
    "grads", "moments") too."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    opt = state.optimizer
    inner = opt.optim if isinstance(opt, ZeroRedundancyOptimizer) else opt
    named = dict(state.model.named_parameters())
    model = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    moments = {name: {k: v.detach().clone() for k, v in inner.state[p].items()}
               for name, p in named.items() if p in inner.state}
    out = {"bn": {k: v for k, v in model.items() if k.endswith(BN_BUFFERS)},
           "digest": {"model": digests(model),
                      "moments": {n: digests(m) for n, m in moments.items()}},
           "step": state.step, "steps_taken": state.steps_taken}
    if "model" in keep:
        out["model"] = model
    if "grads" in keep:
        out["grads"] = {k: p.grad.detach().clone() for k, p in named.items()
                        if p.grad is not None}
    if "moments" in keep:
        out["moments"] = moments
    return out


def world1_refs(rank: int, world: int, workdir: str) -> None:
    """The port's world 1 (no group) at the global batch, one SGD step from
    the plain and from the shifted init at grad_accum 1 and 2, and the
    shifted accum-1 step again at four threads (the thread-count floor):
    their snapshots with gradients and their terms. Then (d)'s resume:
    the module world's sharded checkpoint after step 1 loaded into an
    unsharded AdamW (`loaded`) and step 2 from it (`resumed`, its terms
    `resumed_terms`). All to `refs.pt`."""
    import os
    import time

    from renderih_tpu_torch.train.state import restore_checkpoint
    from renderih_tpu_torch.train.trainer import make_train_step

    inp = torch.load(f"{workdir}/inputs.pt", weights_only=False)
    refs = {}
    for accum in (1, 2):
        for name, sd, b in (("plain", inp["plain"], inp["batch"]),
                            ("shifted", inp["shifted"], inp["grad_batch"][accum])):
            state, terms = port_step(sd, inp["sgd"][accum], b)
            refs[f"{name}_{accum}"] = dict(snapshot(state, ("grads",)), terms=terms[0])
    torch.set_num_threads(4)
    state, _ = port_step(inp["shifted"], inp["sgd"][1], inp["grad_batch"][1])
    refs["shifted_1_threads4"] = snapshot(state, ("grads",))
    torch.set_num_threads(1)
    end = time.monotonic() + READY_TIMEOUT
    # the checkpoint, or the module world's end without one
    while not any(os.path.exists(f"{workdir}/{f}") for f in ("ck_step1.done", "out_r0.pt")):
        if time.monotonic() > end:
            raise TimeoutError("the module world wrote no checkpoint")
        time.sleep(0.1)
    cfg, assets, state = _state(inp["shifted"], inp["adamw"][False])
    restore_checkpoint(f"{workdir}/ck_step1", state)
    refs["loaded"] = snapshot(state)
    terms = make_train_step(cfg, assets, SPE, "cpu")(state, dict(inp["grad_batch"][1]))
    refs["resumed_terms"] = {k: float(v) for k, v in terms.items()}
    refs["resumed"] = snapshot(state, ("model", "moments"))
    torch.save(refs, f"{workdir}/refs.pt")


def _gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    scale, err = float(ref.abs().max()), float((got - ref).abs().max())
    return err / scale if scale > 0 else (0.0 if err == 0 else float("inf"))


def _bn_alone(rank: int, world: int) -> dict:
    """(a): a batch constant per channel on each rank, 1 on rank 0 and 3 on
    rank 1, through the port's BatchNorm2d and the stock per-replica
    module; and a random batch forward and backward, for the test to hold
    against one device on the concatenated batch."""
    from renderih_tpu_torch.models.layers import BatchNorm2d

    c = 3
    x = torch.full((2, c, 4, 4), 1.0 + 2.0 * rank)
    out = {}
    for name, mod in (("global", BatchNorm2d(c)), ("stock", torch.nn.BatchNorm2d(c))):
        with torch.no_grad():
            mod.running_mean.fill_(0.5)
            mod.running_var.fill_(2.0)
        y = mod.train()(x)
        out[name] = dict(y=y.detach(), mean=mod.running_mean.clone(),
                         var=mod.running_var.clone())
    gen = torch.Generator().manual_seed(5)
    xr = torch.randn(world * 3, c, 5, 4, generator=gen) * 2.0 + 1.0
    w = torch.randn(world * 3, c, 5, 4, generator=gen)
    mod = BatchNorm2d(c)
    with torch.no_grad():
        mod.weight.copy_(torch.tensor([0.5, 1.5, -1.0]))
        mod.bias.copy_(torch.tensor([0.1, -0.2, 0.3]))
    xl = xr[rank * 3:(rank + 1) * 3].clone().requires_grad_(True)
    y = mod.train()(xl)
    (y * w[rank * 3:(rank + 1) * 3]).sum().backward()
    out["random"] = dict(y=y.detach(), dx=xl.grad, dweight=mod.weight.grad,
                         dbias=mod.bias.grad, mean=mod.running_mean.clone(),
                         var=mod.running_var.clone())
    return out


def module_world(rank: int, world: int, workdir: str) -> None:
    """Every scenario of tests/test_torch_parallel.py's module fixture, on
    this rank; the inputs from `inputs.pt`."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    from renderih_tpu_torch.models import layers
    from renderih_tpu_torch.parallel import dist
    from renderih_tpu_torch.train.state import restore_checkpoint, save_checkpoint
    from renderih_tpu_torch.train.trainer import make_train_step

    out = {}
    try:
        inp = torch.load(f"{workdir}/inputs.pt", weights_only=False)
        out["bn"] = _bn_alone(rank, world)
        grads = ("grads",) if rank == 0 else ()  # rank 1's are held equal by digest
        g = inp["global_batch"]
        for accum in (1, 2):
            over = inp["sgd"][accum]
            rows = dist.rank_rows(g, world, rank, accum)
            state, terms = port_step(inp["plain"], over, inp["batch"], rows)
            out[f"plain_{accum}"] = dict(snapshot(state), terms=terms[0])
            state, terms = port_step(inp["shifted"], over, inp["grad_batch"][accum], rows)
            out[f"shifted_{accum}"] = dict(snapshot(state, grads), terms=terms[0])
        # planted faults: per-replica statistics; contiguous slices under accum 2
        real = layers.dist
        layers.dist = type("NoGroup", (), {"is_available": staticmethod(lambda: True),
                                           "is_initialized": staticmethod(lambda: False)})
        try:
            state, _ = port_step(inp["plain"], inp["sgd"][1], inp["batch"],
                                 dist.rank_rows(g, world, rank, 1))
        finally:
            layers.dist = real
        out["fault_per_replica_bn"] = snapshot(state, grads)
        m = g // world
        state, _ = port_step(inp["plain"], inp["sgd"][2], inp["batch"],
                             np.arange(rank * m, (rank + 1) * m))
        out["fault_contiguous_rows"] = snapshot(state, grads)
        # ZeRO-1 on and off, AdamW, two steps; the sharded run's checkpoint
        # after step 1 (written by rank 0)
        rows = dist.rank_rows(g, world, rank, 1)
        local = _local(inp["grad_batch"][1], rows)
        runs = {}
        for zero1 in (True, False):
            cfg, assets, state = _state(inp["shifted"], inp["adamw"][zero1])
            assert isinstance(state.optimizer, ZeroRedundancyOptimizer) == zero1
            step = make_train_step(cfg, assets, SPE, "cpu")
            step(state, dict(local))
            if zero1:
                save_checkpoint(f"{workdir}/ck_step1", state)
                if rank == 0:  # written: world1_refs may resume from it
                    open(f"{workdir}/ck_step1.done", "w").close()
                out["adamw_step1"] = snapshot(state)
            terms = step(state, dict(local))
            runs[zero1] = dict(snapshot(state, ("model", "moments")),
                               terms={k: float(v) for k, v in terms.items()})
        on, off = runs[True], runs[False]
        out["zero1"] = dict(
            model_gap=max(_gap(v, off["model"][k]) for k, v in on["model"].items()),
            moments_gap=max(_gap(v, off["moments"][n][k]) for n, mo in on["moments"].items()
                            for k, v in mo.items()),
            shard=sorted(on["moments"]), unsharded=sorted(off["moments"]))
        if rank == 0:  # the uninterrupted world-2 run, for the resume at world 1
            out["adamw_unsharded"] = off
        # the NaN guard: a NaN image on rank 1 alone
        cfg, assets, state = _state(inp["shifted"], inp["adamw"][True])
        restore_checkpoint(f"{workdir}/ck_step1", state)
        before = snapshot(state)
        if rank == 1:
            local["img"] = torch.full_like(local["img"], float("nan"))
        terms = make_train_step(cfg, assets, SPE, "cpu")(state, local)
        after = snapshot(state)
        out["nan"] = dict(skipped=float(terms["skipped_nonfinite"]), before=before, after=after,
                          loaded_equal_step1=before["digest"] == out["adamw_step1"]["digest"])
    except BaseException:
        out["error"] = traceback.format_exc()
    torch.save(out, f"{workdir}/out_r{rank}.pt")


def app_world(rank: int, world: int, workdir: str) -> None:
    """`apps.train --multihost` on the CPU twice in one world. First
    `sigterm/app.yaml` for 4 steps, rank 1 alone sent SIGTERM in its third
    step: what the run returned on this rank, to `app_r{rank}.pt`. Then
    `failing/app.yaml`, the loss raising on rank 1 at its second step: the
    error that ends this rank, to `failing_r{rank}.txt`, raised again, so
    that every rank must end with a non-zero exit."""
    import os
    import signal

    from renderih_tpu_torch.apps import train as train_app
    from renderih_tpu_torch.train import trainer

    loss, calls = trainer.two_hand_graph_loss, []

    def sigterm_on_rank1(*args, **kwargs):
        calls.append(1)
        if rank == 1 and len(calls) == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return loss(*args, **kwargs)

    def failing_on_rank1(*args, **kwargs):
        calls.append(1)
        if rank == 1 and len(calls) == 2:
            raise RuntimeError("planted failure on rank 1")
        return loss(*args, **kwargs)

    args = ["--synthetic", "--synth_n", "4", "--steps", "4", "--device", "cpu", "--multihost"]
    trainer.two_hand_graph_loss = sigterm_on_rank1
    res = train_app.main(["--cfg", f"{workdir}/sigterm/app.yaml", *args])
    torch.save(dict(final_step=res["final_step"], steps_taken=res["steps_taken"],
                    checkpoint=res["checkpoint"], evals=len(res["evals"]),
                    logged=[step for step, _ in res["logged"]]), f"{workdir}/app_r{rank}.pt")
    calls.clear()
    trainer.two_hand_graph_loss = failing_on_rank1
    try:
        train_app.main(["--cfg", f"{workdir}/failing/app.yaml", *args])
    except BaseException:
        with open(f"{workdir}/failing_r{rank}.txt", "w") as f:
            f.write(traceback.format_exc())
        raise
