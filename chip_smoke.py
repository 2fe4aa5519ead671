#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`renderih_tpu_torch/`) on one NVIDIA H100.

    python3 chip_smoke.py [--json PATH] [--profile]

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit (`nvcc`). Phases; any failure exits non-zero and prints no result
line:

1. Build: compiles the port's CUDA kernels from `renderih_tpu_torch/csrc/`
   with nvcc for sm_90a (one nvcc per source, in parallel) and prints
   `-Xptxas -v` (registers, shared memory, spills); B2's `conv3x3_wgmma`,
   B1's `mha_mma_kernel` and B3's `sdf_kernel` must spill nothing; each
   B1 instance's registers and dynamic shared memory. Then the card's
   name and power limit.
2. Kernels against their plain versions on the card, at every shape the
   flagship path gives them at batch 256: B2 (3x3 conv) in bf16 and f32,
   B1 (fused attention) in f32 and bf16. B2 must take its `wgmma` route in
   bf16 and its `simt` route in f32. Each line has max|Δ| and its
   tolerance, the kernel's time (CUDA events after warm-up; for B1 and
   SDPA beside it the device time of 20 calls replayed from a CUDA graph,
   since B1's wrapper costs the host more than its kernel costs the card
   at the short shapes, and also B1's eager time, host included), the
   plain version's, one library call's (cuDNN `F.conv2d`,
   `F.scaled_dot_product_attention`; a yardstick the port never calls) and
   the bound: the largest of the bytes moved (inputs read once, output
   written once) over 3.35 TB/s, the FLOPs over the peak of the unit that
   does them (H100 SXM data sheet: 989 TFLOP/s bf16 and 495 TF32 on tensor
   cores, 67 f32 on CUDA cores; B1 runs on tensor cores, B2's f32 and B3
   on CUDA cores) and, for B1, the exponentials over the MUFU rate (16 a
   clock per SM at 1.98 GHz). B1's f32 lines also print the bound of PR
   1-3's yardstick, its FLOPs over the CUDA-core f32 peak.
3. The flagship path: `Config()` (ResNet-50, bf16 encoder, f32 decoder)
   on synthetic assets with seeded random weights, served through
   `InferenceEngine` + `BatchingServer` (64 single-image requests) and one
   `predict` of 256 images. The launch counters must rise by exactly 13
   (B2) and 24 (B1) per forward, and every B2 launch must take the
   `wgmma` route. Then, in f32 with TF32 off, the card's
   outputs are held against the same engine run on the CPU (the plain
   versions) on the same weights and images.
4. B3 (SDF voxeliser) against its plain version on the card, on the
   synthetic left hand posed at a seeded pose and on the unit cube, at
   G = 16, 24, 32: phi equal bit for bit (`torch.equal`; the kernel's
   lane reductions are exact), bbox and scale equal, kernel and plain
   times (the kernel's launch alone, and with the wrapper's torch bbox
   setup) and the bound (80 FLOP per (voxel, face) at 67 TFLOP/s, bytes
   4·(3G³ + 9F + G³) at 3.35 TB/s: the Pallas kernel's cost estimate). No
   single PyTorch call computes this field: library "none".
5. The synthetic-data path: `synth_gen.main` on the card, 32 samples in
   one batch of 32, each refined with 60 Adam iterations (4 attempts of
   15, SDF grid 16). B3 must launch exactly 128 times per refined sample;
   the dataset files must hold every label at its shape, finite; and the
   mean SDF penetration of the samples that started interpenetrating (the
   same seed generated without refinement) must fall. Prints refined
   samples/s and generated images/s.
6. Card against CPU on that path: one anchor-mode `optimize_two_hands`
   (4 attempts of 3 iterations, G=16, f32, TF32 off) from one numpy-made
   start on both: the objective and its gradient at the start tightly,
   the final parameters, objective and weighted terms loosely (the
   objective is piecewise smooth; `refine_parity_phase` states why).
7. B2's backward at every training shape (batch 64, bf16 and f32): dx
   through B2 (`wgmma` in bf16, `simt` in f32) against the plain autograd
   and against cuDNN's `conv2d_input` (the library yardstick) within
   `CONV_TOL`, dw (cuDNN `conv2d_weight`) against the plain one; the
   forward, dx (with its weight flip), plain, cuDNN and dw device times
   (CUDA-graph replay, as B1's: at batch 64 a B2 call costs the host about
   what its kernel costs the card), the eager times and the bound as in
   phase 2, and their sums over a training step (13 forward + 13 dx).
8. The training path: `apps.train.main` on the card, flagship `Config()`
   at batch 64, `--synthetic --synth_n 256 --steps 21` (4 steps an epoch,
   a checkpoint at epoch 5, step 20). Exactly 26 B2 launches a step, all
   on `wgmma`; no B1; every loss term finite at every step. Then that
   checkpoint alone in a new directory and `--resume auto` to step 21:
   its terms against the uninterrupted step 21 (the same state, batch and
   random draws) within 1e-4, and its final checkpoint against the
   uninterrupted one: the parameters within `RESUME_TOL` of the step's
   own largest move, the Adam moments and the BatchNorm statistics within
   `RESUME_TOL` of each tensor's largest value, the same step counters
   (one step from one state parts only by the order in which cuDNN's dw
   and the index backward add). A planted fault shows that the check can
   fail: from the same checkpoint with its optimizer state dropped, the
   parameters and the moments must land outside those limits. 10 AdamW steps on one fixed batch lower the
   loss. Prints training images/s (the median of steps 4-21; each step
   ends at the NaN guard's host sync) and ms a step; with `--profile`, one
   step's device time by kernel.
9. Card against CPU on that path: one SGD step of `Config()` in f32 (TF32
   off, dropout 0, batch 4) from one seeded init with the encoder's
   BatchNorm biases raised by 3 (no ReLU input after a BatchNorm within
   rounding of 0; tests/test_torch_train.py says why): the loss terms
   within 1e-4 relative, the BatchNorm statistics within 1e-5, every
   parameter's gradient within 2e-2 of its tensor's largest and 95% of
   the tensors within 3e-3 (`GRAD_TOL`). At this width some ReLU input
   lies within rounding of its kink for any batch, and a branch taken one
   way on the card and the other on the CPU moves many tensors by up to
   ~1e-2: the CPU alone, at one thread against eight, parts by 8.5e-3 at
   worst with 99.2% of the tensors within 3e-3. A planted fault, the 2-D
   term's weight 10% off, moves the worst tensor by 0.10 and leaves 3.3%
   of the tensors within 3e-3. The measured distribution is printed.
10. The result: a `{"kernels": [...]}` line (B1/B2 per flagship forward at
   batch 256 in the flagship's dtypes, B2 per training step at batch 64,
   B3 per refined sample), and as the last line
   `{"ok": true, "device": {...}}`.

All f32 comparisons run with TF32 off in cuDNN and cuBLAS
(`torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32
= False`).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "tfloat32": 495e12, "float32": 67e12}
MUFU_EXP_PER_S = 132 * 16 * 1.98e9  # ex2: 16 a clock on each of 132 SMs at 1.98 GHz
BATCH = 256
N_REQUESTS = 64
CONV_TOL = {"bfloat16": (1e-2, 1.6e-2), "float32": (1e-4, 1e-4)}  # atol, rtol
MHA_TOL = (1e-4, 1e-4)
PATH_RTOL = 1e-4  # card vs CPU, relative to each output's max |value|
SDF_GRIDS = (16, 24, 32)
SDF_FLOP_PER_PAIR = 80  # the Pallas kernel's cost estimate (sdf_pallas.py:164)
SYNTH_N, SYNTH_ITERS, SYNTH_GRID = 32, 60, 16
REFINE_SCHEDULE = ((1.0, 1.0, 3), (0.1, 15.0, 3), (30.0, 0.1, 3), (1.0, 5.0, 3))
REFINE_LR = 1e-2
DEVICE = "cuda"  # the card; a CPU rehearsal of phases 4-6 and 8-9 may set "cpu"
TRAIN_BATCH = 64  # the flagship's batch a card
TRAIN_SYNTH_N = 256
TRAIN_STEPS = 21
RESUME_TOL = 1e-3  # resumed vs uninterrupted step (phase 8)
GRAD_TOL = (2e-2, 3e-3, 0.95)  # card vs CPU: every tensor, the tier, its share (phase 9)
FIXED_BATCH_STEPS = 10
PARITY_BATCH = 4
BN_BIAS_SHIFT = 3.0  # card-vs-CPU gradients: keeps ReLU inputs after BatchNorm off 0


def _gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, iters: int = 20) -> float:
    """Device time of one call of `fn`: `iters` calls captured in one CUDA
    graph and replayed, so that the host's cost of a call (Python, ctypes,
    allocation), which exceeds a short kernel's time, is left out."""
    import torch

    side = torch.cuda.Stream()  # warm-up off the capturing stream, as capture asks
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    ms = _time_ms(graph.replay, iters=5, warmup=1) / iters
    del graph
    return ms


def _bound(n_bytes: int, flops: int, dtype_name: str, exps: int = 0) -> dict:
    """The least time for this work: bytes over the HBM rate, FLOPs over
    the peak for the type (`PEAK_FLOPS`) or exponentials over the MUFU
    rate, whichever is largest."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_exps = exps / MUFU_EXP_PER_S * 1e3
    bound = max(t_bytes, t_ops, t_exps)
    return dict(bytes_ms=t_bytes, ops_ms=t_ops, exps_ms=t_exps, bound_ms=bound,
                bound_by="bytes" if t_bytes >= bound else "operations")


def _check(name: str, got, want, atol: float, rtol: float) -> float:
    import torch

    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    max_err = float(err.max())
    if bool(bad.any()):
        raise AssertionError(f"{name}: max|Δ| {max_err:.3e} outside atol "
                             f"{atol:g} + rtol {rtol:g}·|ref| "
                             f"({int(bad.sum())} elements)")
    return max_err


NO_SPILLS = {"conv3x3": "conv3x3_wgmma", "fused_attention": "mha_mma_kernel",
             "sdf": "sdf_kernel"}  # source: kernel


def check_spills(logs: dict) -> None:
    """Fail if ptxas reports spills in a kernel of NO_SPILLS, or no report
    for one whose source was built."""
    spills, seen, fn = [], set(), ""
    for name, log in logs.items():
        for line in log.splitlines():
            if "Function properties for" in line:
                fn = line.rsplit(" ", 1)[-1]
            elif "spill stores" in line and NO_SPILLS.get(name, "?") in fn:
                seen.add(name)
                # "N bytes stack frame, N bytes spill stores, N bytes spill loads"
                if any(int(tok) for tok in line.replace(",", " ").split()[3:]
                       if tok.isdigit()):
                    spills.append(f"{name}: {fn}: {line.strip()}")
    if spills:
        raise AssertionError("ptxas spills:\n" + "\n".join(spills))
    missing = [NO_SPILLS[n] for n in NO_SPILLS if n in logs and n not in seen]
    if missing:
        raise AssertionError(f"no ptxas report for {missing}")
    print(f"[build] no spills in {[NO_SPILLS[n] for n in sorted(seen)]}", flush=True)


def print_mha_resources(log: str) -> None:
    """B1's registers (ptxas) and dynamic shared memory (the library's own
    `fused_mha_smem_bytes`) for each (dtype, D) instance."""
    import ctypes
    import re

    from renderih_tpu_torch.kernels import _build

    lib = ctypes.CDLL(str(_build.library_path("fused_attention")))
    lib.fused_mha_smem_bytes.argtypes = (ctypes.c_int, ctypes.c_int)
    lib.fused_mha_smem_bytes.restype = ctypes.c_int
    inst = None
    for line in log.splitlines():
        m = re.search(r"mha_mma_kernelI(f|13__nv_bfloat16)Li(\d+)E", line)
        if "Function properties for" in line and m:
            inst = ("bfloat16" if m.group(1) != "f" else "float32", int(m.group(2)))
        elif inst and "registers" in line:
            dtype, d = inst
            smem = lib.fused_mha_smem_bytes(int(dtype == "bfloat16"), d)
            print(f"[build] mha_mma_kernel<{dtype}, D={d}>: "
                  f"{line.split(':', 1)[1].strip()}; {smem} B dynamic shared memory", flush=True)
            inst = None


def _routes() -> dict:
    from renderih_tpu_torch.kernels import conv3x3

    return {name: c.value for name, c in conv3x3.routes.items()}


def conv_shapes(cfg) -> list:
    """(H=W, C, launches per forward) of every stride-1 3x3 conv class of
    the ResNet trunk at this config's image size."""
    from renderih_tpu_torch.models.resnet import _STAGES

    kind, counts = _STAGES[cfg.model.encoder]
    per_block = 1 if kind == "bottleneck" else 2
    out = []
    for stage, n_blocks in enumerate(counts):
        side = cfg.model.img_size // 4 // 2**stage
        n = n_blocks * per_block - (1 if stage > 0 else 0)
        out.append((side, 64 * 2**stage, n))
    return out


def mha_shapes(cfg, verts_nums) -> list:
    """(N = M, D, launches per forward) of every attention core of the
    decoder: per stage, 2 hands x (grid SelfAttn + concat SelfAttn) and
    InterAttn's 2 self + 2 cross."""
    m = cfg.model
    heads, grid = m.num_attn_heads, m.grid_size ** 2
    out = []
    for v, d_verts, d_grid in zip(verts_nums, m.gcn_out_dims, m.img_dims):
        out += [(grid, d_grid // heads, 2), (v + grid, d_verts // heads, 2),
                (v, d_verts // heads, 4)]
    return out


def kernel_phase(cfg, verts_nums) -> dict:
    import torch
    import torch.nn.functional as F

    from renderih_tpu_torch.kernels import conv3x3, fused_attention

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = {"conv3x3": [], "fused_mha": []}

    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        atol, rtol = CONV_TOL[dname]
        for side, c, per_fwd in conv_shapes(cfg):
            x = torch.randn(BATCH, side, side, c, device=dev, generator=g).to(dtype)
            w = (torch.randn(3, 3, c, c, device=dev, generator=g)
                 / (9 * c) ** 0.5).to(dtype)
            before = _routes()
            y = conv3x3.conv3x3_same(x, w)
            torch.cuda.synchronize()
            route = "wgmma" if dtype == torch.bfloat16 else "simt"
            want_routes = dict(before, **{route: before[route] + 1})
            if _routes() != want_routes:
                raise AssertionError(f"conv3x3 {dname} {side}²x{c}: routes {_routes()}, "
                                     f"expected {want_routes}")
            err = _check(f"conv3x3 {dname} {side}²x{c}", y,
                         conv3x3.conv3x3_reference(x, w), atol, rtol)
            x_lib = x.permute(0, 3, 1, 2)  # NCHW view, channels_last
            w_lib = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            n_bytes = (x.numel() + w.numel() + y.numel()) * x.element_size()
            flops = 2 * BATCH * side * side * c * c * 9
            row = dict(
                dtype=dname, shape=[BATCH, side, side, c, c], launches_per_forward=per_fwd,
                route=route,
                max_abs_err=err, atol=atol, rtol=rtol,
                ms=_time_ms(lambda: conv3x3.conv3x3_same(x, w)),
                plain_ms=_time_ms(lambda: conv3x3.conv3x3_reference(x, w)),
                library_ms=_time_ms(lambda: F.conv2d(x_lib, w_lib, padding=1)),
                **_bound(n_bytes, flops, dname))
            rows["conv3x3"].append(row)
            print(f"[B2] conv3x3 {dname} x({BATCH},{side},{side},{c}) w(3,3,{c},{c}): "
                  f"max|Δ|={err:.3e} (atol {atol:g}, rtol {rtol:g})  "
                  f"kernel_ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                  f"library_ms={row['library_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
                  f"({row['bound_by']})  launches/forward={per_fwd} route={route}", flush=True)
            del x, w, y, x_lib, w_lib

    heads = cfg.model.num_attn_heads
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        f32 = dtype == torch.float32
        atol, rtol = MHA_TOL if f32 else CONV_TOL[dname]
        for n, d, per_fwd in mha_shapes(cfg, verts_nums):
            q, k, v = (torch.randn(BATCH, n, heads, d, device=dev, generator=g).to(dtype)
                       for _ in range(3))
            out = fused_attention.fused_mha(q, k, v)
            torch.cuda.synchronize()
            # against the float32 plain version on the same (rounded) inputs
            err = _check(f"fused_mha {dname} N={n} D={d}", out,
                         fused_attention.mha_reference(q.float(), k.float(), v.float()),
                         atol, rtol)
            ql, kl, vl = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            n_bytes = (q.numel() + k.numel() + v.numel() + out.numel()) * q.element_size()
            flops = 4 * BATCH * heads * n * n * d
            # tensor cores: TF32 (3xTF32 runs three passes of it) or bf16
            bound = _bound(n_bytes, flops, "tfloat32" if f32 else dname,
                           exps=BATCH * heads * n * n)
            row = dict(
                dtype=dname, shape=[BATCH, n, heads, d],
                launches_per_forward=per_fwd, max_abs_err=err, atol=atol, rtol=rtol,
                ms=_graph_ms(lambda: fused_attention.fused_mha(q, k, v)),
                eager_ms=_time_ms(lambda: fused_attention.fused_mha(q, k, v)),
                plain_ms=_time_ms(lambda: fused_attention.mha_reference(q, k, v)),
                library_ms=_graph_ms(lambda: F.scaled_dot_product_attention(ql, kl, vl)),
                **bound)
            old = ""
            if f32:  # PR 1-3's yardstick: FLOPs over the CUDA-core f32 peak
                row["cuda_core_bound_ms"] = _bound(n_bytes, flops, "float32")["bound_ms"]
                old = f" cuda_core_bound_ms={row['cuda_core_bound_ms']:.4f}"
            rows["fused_mha"].append(row)
            print(f"[B1] fused_mha {dname} q,k,v({BATCH},{n},{heads},{d}): "
                  f"max|Δ|={err:.3e} (atol {atol:g}, rtol {rtol:g})  "
                  f"kernel_ms={row['ms']:.4f} (eager {row['eager_ms']:.4f}) "
                  f"plain_ms={row['plain_ms']:.4f} "
                  f"library_ms={row['library_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
                  f"({row['bound_by']}: bytes {row['bytes_ms']:.4f}, ops "
                  f"{row['ops_ms']:.4f}, exps {row['exps_ms']:.4f}){old}  "
                  f"launches/forward={per_fwd}", flush=True)
            del q, k, v, out, ql, kl, vl
        fwd = [r for r in rows["fused_mha"] if r["dtype"] == dname]
        total = {key: sum(r[key] * r["launches_per_forward"] for r in fwd)
                 for key in ("ms", "eager_ms", "plain_ms", "library_ms", "bound_ms",
                             "cuda_core_bound_ms") if key in fwd[0]}
        print(f"[B1] fused_mha {dname} per flagship forward ({sum(r['launches_per_forward'] for r in fwd)} "
              f"launches): " + ", ".join(f"{key} {val:.4f}" for key, val in total.items()),
              flush=True)
    return rows


def main_path_phase(cfg, assets, gpu_line: str, profile: bool = False) -> dict:
    import numpy as np
    import torch

    from renderih_tpu_torch.kernels import conv3x3, fused_attention, sdf
    from renderih_tpu_torch.serve import BatchingServer, InferenceEngine

    size = cfg.model.img_size
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (BATCH, size, size, 3), dtype=np.uint8)

    engine = InferenceEngine(cfg, assets=assets, device="cuda", seed=0)
    engine.warmup()
    forwards = [0]
    hook = engine.model.register_forward_pre_hook(
        lambda mod, args: forwards.__setitem__(0, forwards[0] + 1))

    for counter in (conv3x3.launches, fused_attention.launches, sdf.launches,
                    *conv3x3.routes.values()):
        counter.reset()
    server = BatchingServer(engine)
    try:
        futs = [server.submit(images[i]) for i in range(N_REQUESTS)]
        served = [f.result(timeout=600) for f in futs]
    finally:
        server.close()
    n_served_batches = forwards[0]
    rates = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = engine.predict(images)
        rates.append(BATCH / (time.perf_counter() - t0))
    launches = {"conv3x3": conv3x3.launches.value,
                "fused_mha": fused_attention.launches.value,
                "sdf_grid": sdf.launches.value}
    routes = _routes()
    hook.remove()

    n_fwd = forwards[0]
    per_fwd = {"conv3x3": sum(n for _, _, n in conv_shapes(cfg)),  # 13
               "fused_mha": sum(n for _, _, n in mha_shapes(  # 24
                   cfg, assets.left.verts_nums)),
               "sdf_grid": 0}
    want = {k: n * n_fwd for k, n in per_fwd.items()}
    want_routes = {"simt": 0, "wgmma": want["conv3x3"]}
    print(f"[path] {N_REQUESTS} requests in {n_served_batches} served batches + "
          f"predict({BATCH}): {n_fwd} forwards, launches {launches} "
          f"(expected {want}), B2 routes {routes} (expected {want_routes})", flush=True)
    if n_fwd == 0 or launches != want:
        raise AssertionError(f"kernel launches {launches} != {want}")
    if routes != want_routes:
        raise AssertionError(f"B2 routes {routes} != {want_routes}")
    for i, res in enumerate(served):
        if res["verts3d_left"].shape != (778, 3):
            raise AssertionError(f"request {i}: shape {res['verts3d_left'].shape}")
    for key, val in out.items():
        exp = {"verts3d": (BATCH, 778, 3), "verts2d": (BATCH, 778, 2),
               "scale": (BATCH,), "trans2d": (BATCH, 2)}[key.rsplit("_", 1)[0]]
        if val.shape != exp or not np.isfinite(val).all():
            raise AssertionError(f"{key}: shape {val.shape} (want {exp}) or non-finite")
    # a served request against the same image in the big batch: reported,
    # not asserted (cuDNN may pick other algorithms at other batch sizes)
    ref = out["verts3d_left"][0]
    d = np.abs(served[0]["verts3d_left"] - ref).max() / max(np.abs(ref).max(), 1e-6)
    rate = sorted(rates)[1]
    print(f"[path] flagship bf16: {rate:.1f} images/s (median of 3 predicts of "
          f"{BATCH}: {', '.join(f'{r:.1f}' for r in rates)}; host upload and copy "
          f"back included) on {gpu_line}; served-vs-batched rel max|Δ| {d:.2e}",
          flush=True)
    result = {"launches": launches, "conv3x3_routes": routes, "forwards": n_fwd,
              "images_per_s": rate,
              "images_per_s_runs": rates}
    if profile:
        batch = images[:engine.buckets[-1]]
        result["profile"] = profile_phase(f"predict({len(batch)})",
                                          lambda: engine.predict(batch))
    del engine
    torch.cuda.empty_cache()
    return result


def profile_phase(label: str, fn) -> dict:
    """Device time by kernel over one call of `fn` (torch.profiler): only
    device-side events count (kernels, memcpy, memset), and the busy time
    is the union of their intervals."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        spans.append((ev.time_range.start, ev.time_range.end))
        ms, count = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (ms + (ev.time_range.end - ev.time_range.start) / 1e3,
                            count + 1)
    busy_us, last_end = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > last_end:
            busy_us += end - max(start, last_end)
            last_end = end
    rows = sorted(((ms, c, n) for n, (ms, c) in by_name.items()), reverse=True)
    busy_ms = busy_us / 1e3
    print(f"[profile] {label} under the profiler: wall {wall_ms:.2f} ms, "
          f"device busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), "
          f"{len(spans)} device events; by kernel:", flush=True)
    for ms, count, name in rows[:30]:
        print(f"[profile] {ms:9.3f} ms {count:5d}x  {name[:110]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "device_events": len(spans),
            "kernels": [dict(ms=ms, count=c, name=n) for ms, c, n in rows]}


def parity_phase(cfg, assets) -> dict:
    import copy

    import numpy as np

    from renderih_tpu_torch.serve import InferenceEngine

    cfg32 = copy.deepcopy(cfg)
    cfg32.train.precision = "f32"
    n = 4
    rng = np.random.default_rng(1)
    size = cfg.model.img_size
    images = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    gpu = InferenceEngine(cfg32, assets=assets, device="cuda", buckets=(n,), seed=0)
    out_gpu = gpu.predict(images)
    cpu = InferenceEngine(cfg32, assets=assets, device="cpu", buckets=(n,), seed=0)
    out_cpu = cpu.predict(images)
    errs = {}
    for key, ref in out_cpu.items():
        scale = max(float(np.abs(ref).max()), 1e-6)
        rel = float(np.abs(out_gpu[key] - ref).max()) / scale
        errs[key] = rel
        if not rel <= PATH_RTOL:
            raise AssertionError(f"{key}: card vs CPU rel max|Δ| {rel:.3e} > {PATH_RTOL:g}")
    print(f"[parity] f32, TF32 off, {n} images: card (kernels) vs CPU (plain), "
          f"max|Δ| / max|ref| per output: "
          + ", ".join(f"{k}={v:.2e}" for k, v in errs.items())
          + f" (limit {PATH_RTOL:g})", flush=True)
    return errs


def _posed_hand(assets, device):
    """The synthetic left hand posed by `mano_forward` at a seeded pose."""
    import numpy as np
    import torch

    from renderih_tpu_torch.mano.layer import mano_forward
    from renderih_tpu_torch.ops.rotation import rodrigues

    rng = np.random.default_rng(0)
    pose = torch.from_numpy(rng.normal(0, 0.4, (1, 45)).astype(np.float32))
    root = torch.from_numpy(rng.normal(0, 0.8, (1, 3)).astype(np.float32))
    v, _ = mano_forward(assets.left.mano, rodrigues(root), pose, torch.zeros(1, 10),
                        center_idx=None, use_pca=False)
    return v[0].to(device), assets.left.mano.faces.to(device)


def _cube(device):
    import torch

    v = torch.tensor([[x, y, z] for z in (-.5, .5) for y in (-.5, .5) for x in (-.5, .5)])
    f = torch.tensor([[0, 3, 1], [0, 2, 3], [4, 5, 7], [4, 7, 6], [0, 1, 5], [0, 5, 4],
                      [3, 2, 6], [3, 6, 7], [1, 3, 7], [1, 7, 5], [0, 4, 6], [0, 6, 2]])
    return v.to(device), f.to(device)


def sdf_kernel_phase(assets) -> list:
    """B3 against its plain version on the card (see the module docstring)."""
    import torch

    from renderih_tpu_torch.kernels import sdf

    dev = torch.device(DEVICE)
    rows = []
    for mesh, (verts, faces) in (("hand", _posed_hand(assets, dev)), ("cube", _cube(dev))):
        n_faces = faces.shape[0]
        for g in SDF_GRIDS:
            phi, bmin, scale = sdf.sdf_grid(verts, faces, g)
            torch.cuda.synchronize()
            ref, ref_bmin, ref_scale = sdf.sdf_grid_reference(verts, faces, g)
            name = f"sdf_grid {mesh} G={g}"
            err = float((phi - ref).abs().max())
            flips = int(((phi > 0) != (ref > 0)).sum())
            if not torch.equal(phi, ref) or not torch.equal(bmin, ref_bmin) \
                    or not torch.equal(scale, ref_scale):
                raise AssertionError(f"{name}: phi not bit-equal (max|Δ| {err:.3e}, {flips} "
                                     f"inside flags differ), or bbox/scale differ "
                                     f"({bmin.tolist()} {float(scale)} vs "
                                     f"{ref_bmin.tolist()} {float(ref_scale)})")
            n_vox = g ** 3
            row = dict(mesh=mesh, grid=g, faces=n_faces, max_abs_err=err,
                       inside=int((ref > 0).sum()), inside_flips=flips,
                       ms=_time_ms(lambda: sdf.launch_sdf(verts, faces, bmin, scale, g)),
                       wrapper_ms=_time_ms(lambda: sdf.sdf_grid(verts, faces, g)),
                       plain_ms=_time_ms(lambda: sdf.sdf_grid_reference(verts, faces, g),
                                         iters=5, warmup=1),
                       library_ms=None,
                       **_bound(4 * (3 * n_vox + 9 * n_faces + n_vox),
                                SDF_FLOP_PER_PAIR * n_vox * n_faces, "float32"))
            rows.append(row)
            print(f"[B3] {name} F={n_faces}: phi bit-equal to the plain version, "
                  f"inside {row['inside']}/{n_vox}, bbox and scale equal  "
                  f"kernel_ms={row['ms']:.4f} (with the torch "
                  f"bbox setup: {row['wrapper_ms']:.4f}) "
                  f"plain_ms={row['plain_ms']:.4f} library_ms=none "
                  f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']})", flush=True)
    return rows


def _penetration(labels: dict, assets, grid: int):
    """Per sample, the SDF penetration of each hand into the other in the
    label frame (both hands shifted alike by the refinement's frame map)."""
    import torch

    from renderih_tpu_torch.ops.sdf import sdf_penetration_loss

    dev = torch.device(DEVICE)
    v_l = torch.from_numpy(labels["v3d_left"]).to(dev)
    v_r = torch.from_numpy(labels["v3d_right"]).to(dev)
    f_l, f_r = assets.left.mano.faces.to(dev), assets.right.mano.faces.to(dev)
    return [float(sdf_penetration_loss(v_l[i:i + 1], v_r[i:i + 1], f_l, grid)
                  + sdf_penetration_loss(v_r[i:i + 1], v_l[i:i + 1], f_r, grid))
            for i in range(v_l.shape[0])]


def synth_phase(assets, gpu_line: str, profile: bool = False) -> dict:
    """The synthetic-data path on the card (see the module docstring)."""
    import os
    import tempfile

    import numpy as np
    import torch

    from renderih_tpu_torch.assets import manos_to
    from renderih_tpu_torch.data.interhand import LABEL_KEYS, _label_shape
    from renderih_tpu_torch.kernels import _build, conv3x3, fused_attention, sdf
    from renderih_tpu_torch.tools import synth_gen

    per_attempt = SYNTH_ITERS // 4
    per_sample = 4 * (2 * per_attempt + 2)  # 2 fields per loss evaluation: 128
    common = ["--n", str(SYNTH_N), "--batch", str(SYNTH_N), "--seed", "0", "--device", DEVICE]
    os.makedirs(_build.BUILD_DIR.parent, exist_ok=True)  # build/, git-ignored
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp:
        refined_dir, start_dir = os.path.join(tmp, "refined"), os.path.join(tmp, "start")
        for counter in (conv3x3.launches, fused_attention.launches, sdf.launches,
                        *conv3x3.routes.values()):
            counter.reset()
        stats = synth_gen.main(["--out", refined_dir, *common, "--optimize",
                                "--opt_iters", str(SYNTH_ITERS)])
        launches = {"conv3x3": conv3x3.launches.value,
                    "fused_mha": fused_attention.launches.value,
                    "sdf_grid": sdf.launches.value}
        want = {"conv3x3": 0, "fused_mha": 0, "sdf_grid": SYNTH_N * per_sample}
        print(f"[synth] synth_gen --n {SYNTH_N} --batch {SYNTH_N} --optimize --opt_iters "
              f"{SYNTH_ITERS}: launches {launches} (expected {want})", flush=True)
        if launches != want:
            raise AssertionError(f"kernel launches {launches} != {want}")

        labels = dict(np.load(os.path.join(refined_dir, "train_labels.npz")))
        images = np.memmap(os.path.join(refined_dir, "train_images.u8"), dtype=np.uint8,
                           mode="r")
        if images.size != SYNTH_N * 256 * 256 * 3 or images.std() < 1:
            raise AssertionError(f"images: {images.size} bytes, std {images.std():.2f}")
        for key in LABEL_KEYS:
            if labels[key].shape != (SYNTH_N,) + _label_shape(key) \
                    or not np.isfinite(labels[key]).all():
                raise AssertionError(f"{key}: shape {labels[key].shape} or non-finite")
        # the same seed without refinement: the samples as they started
        synth_gen.main(["--out", start_dir, *common])
        start = dict(np.load(os.path.join(start_dir, "train_labels.npz")))
    pen0 = np.asarray(_penetration(start, assets, SYNTH_GRID))
    pen1 = np.asarray(_penetration(labels, assets, SYNTH_GRID))
    hit = pen0 > 0
    if not hit.any() or not pen1[hit].mean() < pen0[hit].mean():
        raise AssertionError(f"penetration did not fall: {pen0[hit].mean() if hit.any() else 0:.4e}"
                             f" -> {pen1[hit].mean() if hit.any() else 0:.4e} over "
                             f"{int(hit.sum())} interpenetrating samples")
    print(f"[synth] {int(hit.sum())}/{SYNTH_N} samples started interpenetrating: mean SDF "
          f"penetration (G={SYNTH_GRID}) {pen0[hit].mean():.4e} -> {pen1[hit].mean():.4e}; "
          f"{int((pen1[hit] > 0).sum())} of them still interpenetrate", flush=True)
    print(f"[synth] {stats['refined_samples_per_s']:.3f} refined samples/s "
          f"({stats['refine_seconds']:.2f} s refining {SYNTH_N}), "
          f"{stats['images_per_s']:.3f} generated images/s end to end "
          f"({stats['seconds']:.2f} s) on {gpu_line}", flush=True)
    result = dict(launches=launches, per_sample=per_sample,
                  refine_seconds=stats["refine_seconds"], seconds=stats["seconds"],
                  refined_samples_per_s=stats["refined_samples_per_s"],
                  images_per_s=stats["images_per_s"], pen_start=pen0.tolist(),
                  pen_refined=pen1.tolist())
    if profile:
        device = torch.device(DEVICE)
        refine = synth_gen._make_refine(manos_to(assets, device), SYNTH_ITERS, device)
        with torch.no_grad():
            raw = synth_gen._sample_raw(torch.Generator(device=device).manual_seed(1), 1)
        result["profile"] = profile_phase(
            f"one refined sample ({SYNTH_ITERS} iterations)",
            lambda: refine({k: v.clone() for k, v in raw.items()}, 0))
    return result


def refine_parity_phase(assets) -> dict:
    """Card against CPU: one anchor-mode refinement from one numpy start.

    Gradients tightly, the trajectory loosely. At the start the objective
    agrees within 1e-4 relative and its gradient within 1e-4 relative plus
    1e-5 of its largest component (float32 sums in another order). The
    objective is piecewise smooth: the SDF gradient jumps when a vertex
    crosses a cell of the other hand's grid, the repulsion at its clamp and
    the nearest neighbours when they switch, so differences of 1e-7 grow
    along the run. After 4 attempts of 3 Adam steps the parameters must lie
    within 2·lr·steps of each other (Adam moves a component by at most ~lr
    a step), each weighted term within 5% of the final objective, and the
    objectives within 5% of each other."""
    import numpy as np
    import torch

    from renderih_tpu_torch.optimize.anchors import make_synthetic_anchors
    from renderih_tpu_torch.optimize.geo import (
        GeoWeights,
        HandVars,
        hand_forward,
        make_gaussian_pose_prior,
        make_refine_loss,
        optimize_two_hands,
    )

    rng = np.random.default_rng(5)
    draw = {k: rng.normal(0, s, n).astype(np.float32) for k, s, n in (
        ("root_l", 0.8, 3), ("pose_l", 0.4, 45), ("shape_l", 0.6, 10),
        ("root_r", 0.8, 3), ("pose_r", 0.4, 45), ("shape_r", 0.6, 10), ("offset", 0.02, 3))}
    prior_poses = (rng.normal(size=(256, 45)) * 0.4).astype(np.float32)
    specs = tuple(make_synthetic_anchors(m.faces.numpy(), m.v_template.numpy())
                  for m in (assets.left.mano, assets.right.mano))
    rep_mult, con_mult, _ = REFINE_SCHEDULE[-1]
    w = GeoWeights()
    weight = dict(contact=w.contact * con_mult, repulsion=w.repulsion * rep_mult, sdf=w.sdf,
                  edge=w.edge, pose_reg=w.pose_reg, shape_reg=w.shape_reg,
                  angle=w.angle_limit, prior=w.prior)

    def start(device):
        hands = []
        for side, mano in (("l", assets.left.mano), ("r", assets.right.mano)):
            t = {k: torch.from_numpy(draw[f"{k}_{side}"]) for k in ("pose", "shape", "root")}
            hv = HandVars(t["pose"], t["shape"], torch.zeros(3), t["root"])
            with torch.no_grad():
                j9 = hand_forward(mano, hv)[1][9]
            trans = -j9 + (torch.from_numpy(draw["offset"]) if side == "r" else 0.0)
            hands.append(HandVars(*(x.to(device) for x in hv._replace(trans=trans))))
        return hands

    res = {}
    for device in (DEVICE, "cpu"):
        left, right = start(device)
        prior = make_gaussian_pose_prior(torch.from_numpy(prior_poses).to(device))
        loss_fn, match_fn = make_refine_loss(assets, left, right, sdf_grid_size=SYNTH_GRID,
                                             pose_prior_fn=prior, anchors=specs)
        leaves = [t.clone().requires_grad_() for hv in (left, right) for t in hv]
        params = (HandVars(*leaves[:4]), HandVars(*leaves[4:]))
        total0, _ = loss_fn(params, match_fn(params), con_mult, rep_mult)
        total0.backward()
        l2, r2, terms = optimize_two_hands(
            assets, left, right, lr=REFINE_LR, sdf_grid_size=SYNTH_GRID, pose_prior_fn=prior,
            anchors=specs, schedule=REFINE_SCHEDULE)
        terms = {k: float(v) * weight[k] for k, v in terms.items()}
        res[device] = dict(
            total0=total0.item(), total=sum(terms.values()), terms=terms,
            grad=np.concatenate([t.grad.cpu().numpy().ravel() for t in leaves]),
            params=np.concatenate([t.cpu().numpy().ravel() for hv in (l2, r2) for t in hv]))
    card, cpu = res[DEVICE], res["cpu"]
    steps = sum(n for _, _, n in REFINE_SCHEDULE)
    grad_err = np.abs(card["grad"] - cpu["grad"])
    grad_tol = 1e-4 * np.abs(cpu["grad"]) + 1e-5 * np.abs(cpu["grad"]).max()
    start_rel = abs(card["total0"] - cpu["total0"]) / abs(cpu["total0"])
    param_err = float(np.abs(card["params"] - cpu["params"]).max())
    term_err = max(abs(card["terms"][k] - v) for k, v in cpu["terms"].items()) / cpu["total"]
    total_rel = abs(card["total"] - cpu["total"]) / cpu["total"]
    print(f"[refine-parity] anchor mode, G={SYNTH_GRID}, f32, TF32 off, card vs CPU: at the "
          f"start objective {card['total0']:.6g}/{cpu['total0']:.6g} (rel {start_rel:.2e}, "
          f"limit 1e-4), gradient max|Δ| {grad_err.max():.3e} (max|g| "
          f"{np.abs(cpu['grad']).max():.4g}; {int((grad_err > grad_tol).sum())} components "
          f"outside 1e-4·|g| + 1e-5·max|g|); after {len(REFINE_SCHEDULE)}x3 steps params "
          f"max|Δ| {param_err:.3e} (limit {2 * REFINE_LR * steps:g}), objective "
          f"{card['total']:.6g}/{cpu['total']:.6g} (rel {total_rel:.2e}, limit 0.05), weighted "
          f"terms max|Δ| {term_err:.2e} of the objective (limit 0.05): "
          + ", ".join(f"{k}={card['terms'][k]:.5g}/{cpu['terms'][k]:.5g}"
                      for k in sorted(cpu["terms"])), flush=True)
    if not (start_rel <= 1e-4 and (grad_err <= grad_tol).all()
            and param_err <= 2 * REFINE_LR * steps and total_rel <= 0.05 and term_err <= 0.05):
        raise AssertionError("card and CPU refinements disagree")
    return dict(start_rel=start_rel, grad_max_abs_err=float(grad_err.max()),
                params_max_abs_err=param_err, total_rel=total_rel, term_err=term_err)


def conv_backward_phase(cfg) -> list:
    """B2's backward at every training shape, batch TRAIN_BATCH, bf16 and
    f32 (see the module docstring, phase 7)."""
    import torch
    import torch.nn.functional as F

    from renderih_tpu_torch.kernels import conv3x3

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        atol, rtol = CONV_TOL[dname]
        route = "wgmma" if dtype == torch.bfloat16 else "simt"
        for side, c, per_fwd in conv_shapes(cfg):
            shape = (TRAIN_BATCH, side, side, c)
            x = torch.randn(*shape, device=dev, generator=g).to(dtype)
            w = (torch.randn(3, 3, c, c, device=dev, generator=g) / (9 * c) ** 0.5).to(dtype)
            gy = torch.randn(*shape, device=dev, generator=g).to(dtype)
            xk, wk = x.clone().requires_grad_(), w.clone().requires_grad_()
            before = _routes()
            conv3x3.conv3x3_same(xk, wk).backward(gy)
            torch.cuda.synchronize()
            want_routes = dict(before, **{route: before[route] + 2})  # forward, dx
            if _routes() != want_routes:
                raise AssertionError(f"conv3x3 backward {dname} {side}²x{c}: routes "
                                     f"{_routes()}, expected {want_routes}")
            xp, wp = x.clone().requires_grad_(), w.clone().requires_grad_()
            conv3x3.conv3x3_reference(xp, wp).backward(gy)
            name = f"conv3x3 backward {dname} {side}²x{c}"
            w_t = w.flip(0, 1).transpose(2, 3).contiguous()
            nchw = lambda t: t.permute(0, 3, 1, 2)
            w_oihw = w.permute(3, 2, 0, 1).contiguous()
            dx_lib = F.grad.conv2d_input(nchw(x).shape, w_oihw, nchw(gy), padding=1)
            err_dx = _check(f"{name} dx vs plain", xk.grad, xp.grad, atol, rtol)
            err_lib = _check(f"{name} dx vs cuDNN", xk.grad, dx_lib.permute(0, 2, 3, 1), atol,
                             rtol)
            # dw sums B·H·W products: relative to its largest element
            ref = wp.grad.float()
            err_dw = float((wk.grad.float() - ref).abs().max() / ref.abs().max())
            if not err_dw <= (1e-5 if dtype == torch.float32 else 1e-2):
                raise AssertionError(f"{name} dw: max|Δ|/max|ref| {err_dw:.3e}")
            n_bytes = (x.numel() + w.numel() + x.numel()) * x.element_size()
            flops = 2 * TRAIN_BATCH * side * side * c * c * 9
            dx = lambda: conv3x3.conv3x3_same(gy, w.flip(0, 1).transpose(2, 3).contiguous())
            row = dict(
                dtype=dname, shape=[TRAIN_BATCH, side, side, c, c],
                launches_per_step=2 * per_fwd, route=route,
                max_abs_err=max(err_dx, err_lib), dw_rel_err=err_dw, atol=atol, rtol=rtol,
                fwd_ms=_graph_ms(lambda: conv3x3.conv3x3_same(x, w)),
                dx_ms=_graph_ms(dx),
                eager_fwd_ms=_time_ms(lambda: conv3x3.conv3x3_same(x, w)),
                eager_dx_ms=_time_ms(dx),
                plain_fwd_ms=_graph_ms(lambda: conv3x3.conv3x3_reference(x, w)),
                plain_dx_ms=_graph_ms(lambda: conv3x3.conv3x3_reference(gy, w_t)),
                library_fwd_ms=_graph_ms(lambda: F.conv2d(nchw(x), w_oihw, padding=1)),
                library_dx_ms=_graph_ms(lambda: F.grad.conv2d_input(
                    nchw(x).shape, w_oihw, nchw(gy), padding=1)),
                dw_ms=_graph_ms(lambda: F.grad.conv2d_weight(
                    nchw(x), w_oihw.shape, nchw(gy), padding=1)),
                **_bound(n_bytes, flops, dname))
            rows.append(row)
            print(f"[B2-bwd] {name} x({TRAIN_BATCH},{side},{side},{c}): dx max|Δ| "
                  f"{err_dx:.3e} vs plain, {err_lib:.3e} vs cuDNN conv2d_input (atol {atol:g}, "
                  f"rtol {rtol:g}); dw (cuDNN) rel {err_dw:.2e}  device ms (CUDA graph): "
                  f"fwd {row['fwd_ms']:.4f}, dx {row['dx_ms']:.4f} (with the weight flip), "
                  f"plain fwd/dx {row['plain_fwd_ms']:.4f}/{row['plain_dx_ms']:.4f}, cuDNN "
                  f"fwd/dx {row['library_fwd_ms']:.4f}/{row['library_dx_ms']:.4f}, dw "
                  f"{row['dw_ms']:.4f}; eager fwd/dx {row['eager_fwd_ms']:.4f}/"
                  f"{row['eager_dx_ms']:.4f}; bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
                  f"each; launches/step={2 * per_fwd} route={route}", flush=True)
            del x, w, gy, xk, wk, xp, wp, dx_lib
        per_step = [r for r in rows if r["dtype"] == dname]
        tot = lambda key: sum(r[key] * r["launches_per_step"] / 2 for r in per_step)
        print(f"[B2-bwd] {dname} per training step (13 forward + 13 dx launches), device ms: "
              f"B2 {tot('fwd_ms') + tot('dx_ms'):.3f} (fwd {tot('fwd_ms'):.3f}, dx "
              f"{tot('dx_ms'):.3f}), plain {tot('plain_fwd_ms') + tot('plain_dx_ms'):.3f}, "
              f"cuDNN {tot('library_fwd_ms') + tot('library_dx_ms'):.3f}, bound "
              f"{2 * tot('bound_ms'):.3f}; dw by cuDNN {tot('dw_ms'):.3f}; eager (host "
              f"included) B2 {tot('eager_fwd_ms') + tot('eager_dx_ms'):.3f}", flush=True)
    torch.cuda.empty_cache()
    return rows


def _train_yaml(cfg, root: str, name: str, **train) -> str:
    """A config file for one `apps.train` run: `cfg` with its own
    checkpoint directory and these train settings."""
    import copy
    import os

    from renderih_tpu_torch.config import dump_config

    cfg = copy.deepcopy(cfg)
    cfg.train.checkpoint_dir = os.path.join(root, name)
    for key, val in train.items():
        setattr(cfg.train, key, val)
    path = os.path.join(root, f"{name}.yaml")
    dump_config(cfg, path)
    return path


def _state_gap(path_a: str, path_b: str, path_before: str) -> dict:
    """How far checkpoint b is from checkpoint a, the same step of two
    runs that left `path_before`: the largest parameter difference over
    the step's own largest move (max|a − before|), the Adam moments' and
    the BatchNorm statistics' largest difference relative to each
    tensor's largest value, and whether the step counters agree."""
    import torch

    load = lambda p: torch.load(f"{p}/state.pt", weights_only=True, map_location="cpu")
    a, b, before = load(path_a), load(path_b), load(path_before)

    def rel(x, y):  # y the reference
        err, scale = float((x - y).abs().max()), float(y.abs().max())
        return err / scale if scale > 0 else (0.0 if err == 0 else float("inf"))

    is_bn = lambda k: k.endswith(("running_mean", "running_var"))
    params = [k for k, v in a["model"].items() if v.is_floating_point() and not is_bn(k)]
    move = max(float((a["model"][k] - before["model"][k]).abs().max()) for k in params)
    p_gap = max(float((b["model"][k] - a["model"][k]).abs().max()) for k in params) / move
    bn_gap = max(rel(b["model"][k], a["model"][k]) for k in a["model"] if is_bn(k))
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    m_gap = float("inf") if sa.keys() != sb.keys() else max(
        rel(sb[i][key], sa[i][key]) for i in sa for key in ("exp_avg", "exp_avg_sq"))
    steps_equal = (a["step"] == b["step"] and sa.keys() == sb.keys()
                   and all(float(sa[i]["step"]) == float(sb[i]["step"]) for i in sa))
    return dict(params=p_gap, moments=m_gap, bn=bn_gap, steps_equal=steps_equal)


def train_phase(cfg, assets, gpu_line: str, profile: bool = False) -> dict:
    """The training path on the card (see the module docstring, phase 8)."""
    import copy
    import shutil
    import tempfile

    import numpy as np
    import torch

    from renderih_tpu_torch.apps import train as train_app
    from renderih_tpu_torch.data.interhand import PackedInterHand
    from renderih_tpu_torch.data.pipeline import device_augment
    from renderih_tpu_torch.kernels import _build, conv3x3, fused_attention, sdf
    from renderih_tpu_torch.models import init_model
    from renderih_tpu_torch.train.state import create_train_state
    from renderih_tpu_torch.train.trainer import make_train_step

    per_step = 2 * sum(n for _, _, n in conv_shapes(cfg))  # 13 forward + 13 dx
    common = ["--synthetic", "--synth_n", str(TRAIN_SYNTH_N), "--device", DEVICE,
              "--steps", str(TRAIN_STEPS)]
    spe = TRAIN_SYNTH_N // cfg.train.batch_size
    cut_epoch = (TRAIN_STEPS - 1) // spe  # the last whole epoch before the end
    yaml = lambda root, name: _train_yaml(cfg, root, name, log_every=1, save_gap=cut_epoch,
                                          seed=0)
    _build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)  # build/, git-ignored
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as root:
        counters = (conv3x3.launches, fused_attention.launches, sdf.launches,
                    *conv3x3.routes.values())
        for counter in counters:
            counter.reset()
        a = train_app.main(["--cfg", yaml(root, "straight"), *common])
        launches = {"conv3x3": conv3x3.launches.value,
                    "fused_mha": fused_attention.launches.value, "sdf_grid": sdf.launches.value}
        routes = _routes()
        n_steps = a["final_step"]
        want = {"conv3x3": per_step * n_steps, "fused_mha": 0, "sdf_grid": 0}
        print(f"[train] apps.train --synthetic --synth_n {TRAIN_SYNTH_N} --steps {TRAIN_STEPS}, "
              f"Config() at batch {cfg.train.batch_size}: {n_steps} steps, launches "
              f"{launches} (expected {want}), B2 routes {routes}", flush=True)
        if launches != want:
            raise AssertionError(f"kernel launches {launches} != {want}")
        if routes != {"simt": 0, "wgmma": want["conv3x3"]}:
            raise AssertionError(f"B2 routes {routes}: every launch must be wgmma")
        for step, terms in a["logged"]:
            if not all(np.isfinite(v) for v in terms.values()) or terms["skipped_nonfinite"]:
                raise AssertionError(f"step {step}: terms {terms}")
        first, last = a["logged"][0][1], a["logged"][-1][1]
        print(f"[train] loss {first['total']:.4f} -> {last['total']:.4f} over {n_steps} steps "
              f"(warmup lr), every term finite, none skipped", flush=True)

        # The run's epoch_<cut> checkpoint in a directory of its own, then
        # --resume auto there to the last step: its terms and final state
        # against the uninterrupted run's; then the same with the
        # checkpoint's optimizer state dropped, which the check must see.
        cut, step0 = f"epoch_{cut_epoch}", cut_epoch * spe

        def resume(name: str, drop_moments: bool = False) -> tuple:
            shutil.copytree(f"{root}/straight/_synth_data", f"{root}/{name}/_synth_data")
            shutil.copytree(f"{root}/straight/{cut}", f"{root}/{name}/{cut}")
            if drop_moments:
                blob = torch.load(f"{root}/{name}/{cut}/state.pt", weights_only=True)
                blob["optimizer"]["state"] = {}
                torch.save(blob, f"{root}/{name}/{cut}/state.pt")
            out = train_app.main(["--cfg", yaml(root, name), *common, "--resume", "auto"])
            if out["logged"][0][0] != step0 + 1 or out["final_step"] != n_steps:
                raise AssertionError(f"the resumed run did not continue at step {step0 + 1}")
            ref = dict(a["logged"])[step0 + 1]
            terms = max(abs(out["logged"][0][1][k] - v) / max(abs(v), 1e-12)
                        for k, v in ref.items())
            return terms, _state_gap(a["checkpoint"], out["checkpoint"], f"{root}/straight/{cut}")

        diff, gap = resume("resumed")
        _, fault = resume("dropped_moments", drop_moments=True)
        within = lambda g: (g["steps_equal"] and g["params"] <= RESUME_TOL
                            and g["moments"] <= RESUME_TOL and g["bn"] <= RESUME_TOL)
        show = lambda g: (f"parameters {g['params']:.3e} of the step's largest move, moments "
                          f"{g['moments']:.3e}, BatchNorm statistics {g['bn']:.3e}, steps "
                          f"{'equal' if g['steps_equal'] else 'differ'}")
        print(f"[train] --resume auto from {cut} (step {step0}) to step {n_steps}: terms vs the "
              f"uninterrupted run rel max|Δ| {diff:.3e} (limit 1e-4); final state: {show(gap)} "
              f"(limit {RESUME_TOL:g}); planted fault, the checkpoint's optimizer state "
              f"dropped: {show(fault)}", flush=True)
        if not (diff <= 1e-4 and within(gap)):
            raise AssertionError("the resumed run left the uninterrupted one")
        if fault["params"] <= RESUME_TOL or fault["moments"] <= RESUME_TOL:
            raise AssertionError("the resume check did not see a checkpoint without its moments")

        ips = a["images_per_s"]
        steady = a["step_seconds"][train_app.WARMUP_STEPS:]
        print(f"[train] flagship training bf16 encoder + f32 decoder, batch "
              f"{cfg.train.batch_size}: {ips:.1f} images/s, {1e3 * np.median(steady):.1f} ms a step "
              f"(median of steps {train_app.WARMUP_STEPS + 1}-{n_steps}; each step ends at its "
              f"NaN-guard sync) on {gpu_line}", flush=True)

        # 10 steps on one fixed batch lower the loss
        fcfg = copy.deepcopy(cfg)
        fcfg.train.warmup_epochs, fcfg.train.lr = 0, 1e-3
        data = PackedInterHand.load(f"{root}/straight/_synth_data", "train")
        raw = {k: torch.from_numpy(v).to(DEVICE)
               for k, v in data.batch(np.arange(cfg.train.batch_size)).items()}
        batch = device_augment(raw, torch.Generator(device=DEVICE).manual_seed(0),
                               img_size=cfg.model.img_size)
        model = init_model(fcfg, assets, torch.Generator().manual_seed(0))
        state = create_train_state(fcfg, model.to(DEVICE, memory_format=torch.channels_last),
                                   steps_per_epoch=1000)
        step = make_train_step(fcfg, assets, 1000, DEVICE)
        losses = [float(step(state, batch, torch.Generator(device=DEVICE).manual_seed(1))["total"])
                  for _ in range(FIXED_BATCH_STEPS)]
        print(f"[train] {FIXED_BATCH_STEPS} AdamW steps (lr 1e-3, no warmup) on one fixed batch: "
              f"loss {' '.join(f'{v:.2f}' for v in losses)}", flush=True)
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"loss did not fall on a fixed batch: {losses}")
        result = dict(steps=n_steps, launches=launches, launches_per_step=per_step,
                      routes=routes, images_per_s=ips,
                      step_ms=1e3 * float(np.median(steady)), step_seconds=a["step_seconds"],
                      loss_first=first["total"], loss_last=last["total"],
                      resume_terms_rel=diff, resume_state=gap, resume_fault=fault,
                      fixed_batch_losses=losses)
        if profile:
            result["profile"] = profile_phase(
                f"one training step at batch {cfg.train.batch_size}",
                lambda: float(step(state, batch)["total"]))
    del state, model, batch, raw
    torch.cuda.empty_cache()
    return result


def train_parity_phase(cfg, assets) -> dict:
    """Card against CPU: one SGD step of the flagship in f32 (see the
    module docstring, phase 9)."""
    import copy

    import torch

    from renderih_tpu_torch.data.synthetic import synthetic_batch
    from renderih_tpu_torch.models import init_model
    from renderih_tpu_torch.models.layers import BatchNorm2d
    from renderih_tpu_torch.train.state import create_train_state
    from renderih_tpu_torch.train.trainer import make_train_step

    pcfg = copy.deepcopy(cfg)
    pcfg.train.optimizer, pcfg.train.precision, pcfg.train.lr = "sgd", "f32", 1.0
    pcfg.train.warmup_epochs, pcfg.model.dropout = 0, 0.0
    size = cfg.model.img_size
    with torch.no_grad():
        batch = synthetic_batch(assets, torch.Generator().manual_seed(2), PARITY_BATCH, size)
    res = {}
    for dev in (DEVICE, "cpu"):
        model = init_model(pcfg, assets, torch.Generator().manual_seed(0))
        with torch.no_grad():
            for mod in model.encoder.modules():
                if isinstance(mod, BatchNorm2d):
                    mod.bias += BN_BIAS_SHIFT
        model = model.to(dev, memory_format=torch.channels_last)
        state = create_train_state(pcfg, model, 10)
        terms = make_train_step(pcfg, assets, 10, dev)(
            state, {k: v.to(dev) for k, v in batch.items()})
        res[dev] = dict(terms={k: float(v) for k, v in terms.items()},
                        grads={k: p.grad.cpu() for k, p in model.named_parameters()
                               if p.grad is not None},
                        bn={k: v.cpu() for k, v in model.state_dict().items()
                            if k.endswith(("running_mean", "running_var"))})
        del state, model
    card, cpu = res[DEVICE], res["cpu"]
    term_err = max(abs(card["terms"][k] - v) / max(abs(v), 1e-12) for k, v in cpu["terms"].items())
    grad_err = {}
    for k, g in cpu["grads"].items():
        # Some biases have gradient 0 but for rounding: a key projection's
        # (a per-query constant on every logit), the stem BatchNorm's (a
        # constant shift the next BatchNorms remove, once no ReLU clips):
        # a bias is held against its layer's scale, the larger of its own
        # gradient and its weight's. A tensor no loss term reaches (the
        # unread mid level) must be 0 on both.
        w = k[:-len("bias")] + "weight"
        scale = float(g.abs().max())
        if k.endswith(".bias") and w in cpu["grads"]:
            scale = max(scale, float(cpu["grads"][w].abs().max()))
        err = float((card["grads"][k] - g).abs().max())
        grad_err[k] = err / scale if scale > 0 else (0.0 if err == 0 else float("inf"))
    bn_err = max(float((card["bn"][k] - v).abs().max() / v.abs().max()) for k, v in cpu["bn"].items())
    worst = sorted(grad_err, key=grad_err.get, reverse=True)[:3]
    share = {t: sum(e <= t for e in grad_err.values()) / len(grad_err)
             for t in (1e-4, 1e-3, 3e-3, 1e-2)}
    print(f"[train-parity] one SGD step, Config() in f32, TF32 off, dropout 0, batch "
          f"{PARITY_BATCH}, encoder BatchNorm biases +{BN_BIAS_SHIFT:g}, card vs CPU: loss terms "
          f"rel max|Δ| {term_err:.2e} (limit 1e-4); gradients, max|Δ|/max|g| per tensor: "
          f"worst {', '.join(f'{grad_err[k]:.2e} ({k})' for k in worst)}; of {len(grad_err)} "
          f"tensors {100 * share[1e-4]:.1f}% within 1e-4, {100 * share[1e-3]:.1f}% within 1e-3, "
          f"{100 * share[3e-3]:.1f}% within 3e-3, {100 * share[1e-2]:.1f}% within 1e-2 (limits: "
          f"every tensor {GRAD_TOL[0]:g}, {100 * GRAD_TOL[2]:g}% within {GRAD_TOL[1]:g}); "
          f"BatchNorm statistics {bn_err:.2e} (limit 1e-5)", flush=True)
    if card["grads"].keys() != cpu["grads"].keys():
        raise AssertionError("card and CPU trained different parameters")
    if not (term_err <= 1e-4 and grad_err[worst[0]] <= GRAD_TOL[0]
            and share[GRAD_TOL[1]] >= GRAD_TOL[2]
            and bn_err <= 1e-5):
        raise AssertionError("card and CPU training steps disagree")
    return dict(terms_rel=term_err, grad_rel=grad_err, grad_share=share, bn_rel=bn_err)


def _summary(rows: list, launches: int) -> dict:
    """One kernel's totals over the launches of one unit of its path (a
    flagship forward at batch 256; a refined sample)."""
    def total(key):
        return sum(r[key] * r["launches_per_forward"] for r in rows)

    t_bytes, t_ops, t_exps = total("bytes_ms"), total("ops_ms"), total("exps_ms")
    bound = max(t_bytes, t_ops, t_exps)
    return dict(launches=launches, max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=total("ms"), plain_ms=total("plain_ms"),
                bound_ms=bound,
                bound_by="bytes" if t_bytes >= bound else "operations",
                library_ms=None if any(r["library_ms"] is None for r in rows)
                else total("library_ms"))


def _train_summary(rows: list, launches: int) -> dict:
    """B2 over one training step: each shape's forward and dx (a launch
    each) times its launches a forward."""
    def total(key):
        return sum(r[key] * r["launches_per_step"] / 2 for r in rows)

    t_bytes, t_ops = 2 * total("bytes_ms"), 2 * total("ops_ms")
    bound = max(t_bytes, t_ops)
    return dict(launches=launches, max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=total("fwd_ms") + total("dx_ms"),
                plain_ms=total("plain_fwd_ms") + total("plain_dx_ms"), bound_ms=bound,
                bound_by="bytes" if t_bytes >= bound else "operations",
                library_ms=total("library_fwd_ms") + total("library_dx_ms"))


def run(json_path: str | None, profile: bool) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "measures the port on the card only", file=sys.stderr)
        return 2
    try:
        from renderih_tpu_torch.assets import make_synthetic_assets
        from renderih_tpu_torch.config import Config
        from renderih_tpu_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the renderih_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    logs = _build.build(["conv3x3", "fused_attention", "sdf"], verbose=True)
    for name, log in logs.items():
        print(f"[build] nvcc {' '.join(_build.nvcc_flags(name))} {name}.cu:\n{log.strip()}")
    print(f"[build] {sorted(logs)} built in {time.perf_counter() - t0:.1f} s into "
          f"{_build.BUILD_DIR}", flush=True)
    check_spills(logs)
    if "fused_attention" in logs:  # built in this run
        print_mha_resources(logs["fused_attention"])
    gpu_line = _gpu_line()
    print(f"[card] {gpu_line}", flush=True)

    cfg = Config()
    assets = make_synthetic_assets(0)
    verts_nums = assets.left.verts_nums
    rows = kernel_phase(cfg, verts_nums)
    path = main_path_phase(cfg, assets, gpu_line, profile)
    errs = parity_phase(cfg, assets)
    rows["sdf_grid"] = sdf_kernel_phase(assets)
    synth = synth_phase(assets, gpu_line, profile)
    refine = refine_parity_phase(assets)
    on_path = [r for r in rows["sdf_grid"] if r["mesh"] == "hand" and r["grid"] == SYNTH_GRID]
    for r in on_path:
        r["launches_per_forward"] = synth["per_sample"]
    bwd_rows = conv_backward_phase(cfg)
    train = train_phase(cfg, assets, gpu_line, profile)
    train_parity = train_parity_phase(cfg, assets)
    per_sample_ms = 1e3 * synth["refine_seconds"] / SYNTH_N
    b3_ms = synth["per_sample"] * on_path[0]["ms"]
    print(f"[synth] B3 in a refined sample: {synth['per_sample']} launches x "
          f"{on_path[0]['ms']:.4f} ms = {b3_ms:.2f} ms of {per_sample_ms:.2f} ms "
          f"({100 * b3_ms / per_sample_ms:.1f}%)", flush=True)

    src = "renderih_tpu_torch"
    kernels = [
        dict(name="conv3x3_same", path="serve", route="cuda", source=f"{src}/csrc/conv3x3.cu",
             replaces="renderih_tpu/kernels/conv_pallas.py:160",
             **_summary([r for r in rows["conv3x3"] if r["dtype"] == "bfloat16"],
                        path["launches"]["conv3x3"])),
        dict(name="conv3x3_same", path="train", route="cuda", source=f"{src}/csrc/conv3x3.cu",
             replaces="renderih_tpu/kernels/conv_pallas.py:160",
             **_train_summary([r for r in bwd_rows if r["dtype"] == "bfloat16"],
                              train["launches"]["conv3x3"])),
        dict(name="fused_mha", path="serve", route="cuda", source=f"{src}/csrc/fused_attention.cu",
             replaces="renderih_tpu/kernels/fused_attention.py:43",
             **_summary([r for r in rows["fused_mha"] if r["dtype"] == "float32"],
                        path["launches"]["fused_mha"])),
        dict(name="sdf_grid", path="synth", route="cuda", source=f"{src}/csrc/sdf.cu",
             replaces="renderih_tpu/kernels/sdf_pallas.py:124",
             **dict(_summary(on_path, synth["launches"]["sdf_grid"]),
                    max_abs_err=max(r["max_abs_err"] for r in rows["sdf_grid"]))),
    ]
    if json_path:
        with open(json_path, "w") as f:
            json.dump({"card": gpu_line, "torch": torch.__version__, "rows": rows,
                       "main_path": path, "parity": errs, "synth_path": synth,
                       "refine_parity": refine, "conv_backward": bwd_rows,
                       "train_path": train, "train_parity": train_parity,
                       "kernels": kernels}, f, indent=1)
    print(gpu_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--json", help="also write every measurement to this file")
    parser.add_argument("--profile", action="store_true",
                        help="also print device time by kernel over one flagship "
                             "predict at the largest bucket, one refined sample and "
                             "one training step (torch.profiler)")
    args = parser.parse_args()
    try:
        return run(args.json, args.profile)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
