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
   a checkpoint at epoch 5, step 20, then the in-training eval of the
   64-sample held-out split, EMA off, with its overlays). Exactly 26 B2
   launches a training step, all on `wgmma`; no B1 in training; the eval's
   forwards (one a batch of the held-out split, one for the overlays) add
   13 B2 and 24 B1 each. Every loss term finite at every step; the eval
   summary finite; the checkpoint holds the steps taken (20). Then that
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
   off, dropout 0, batch 4) from `init_model`'s weights with the
   encoder's BatchNorm biases raised by 3, at two (init, batch) seed pairs
   (`TRAIN_PARITY_SEEDS`), the CPU taking the card's branch at every ReLU
   and max-pool (`utils/branches.py`). The raised biases let nearly every
   ReLU after a BatchNorm pass, so that no channel of a batch-4 BatchNorm
   is nearly dead and amplifies rounding: from `init_model`'s own biases the
   loss terms part by up to 3.3e-4 on shared branches. Held: the loss terms
   within 1e-4 relative, the BatchNorm statistics within 1e-5, every
   parameter's gradient within 2e-2 of its tensor's scale and 95% of the
   tensors within 3e-3 (`GRAD_TOL`). Without shared branches a ReLU input
   or max-pool runner-up within rounding of its kink goes one way on the
   card and the other on the CPU at most draws, and the gradients can part
   by more than a planted fault does (printed, not held: the CPU's step on
   its own branches); with them only rounding is left, and the limits hold
   at every draw tried (tests/test_torch_branches.py,
   tests/test_torch_cuda.py). A planted fault, the 2-D term's weight 10%
   off on the same branches, must land outside them (it moves the worst
   tensor by ~0.10).
10. The eval path. First its kernels at the batches it runs them at, 512
   and the CLI's 64: B2 in bf16 (on `wgmma`) and B1 in f32, the flagship's
   dtypes, at every shape of a forward against their plain versions on
   random inputs, at phase 2's tolerances. Then `evaluate_packed` on the
   card, flagship `Config()` with seed-0 weights, on a synthetic split of
   `EVAL_N` (1024) images at batch `EVAL_BATCH` (512, the JAX CLI's
   `--bs`), the split cached on the device. Exactly 13 B2 (all `wgmma`) and 24 B1 launches a forward, two
   forwards. Prints images/s (the second batch: the first is untimed),
   the cache upload, and the metrics' share of a batch (forward and
   metrics timed apart with CUDA events). The metrics must be equal bit
   for bit with TF32 allowed in cuBLAS (they use no matmul: ground-truth
   vertices in the camera frame put TF32's rounding of −2ab above the
   3 mm contact threshold). Then, in f32 with TF32 off, card against CPU
   on 10 images at batch 4 (samples 0-4 with the right hand moved onto the
   left, so CDev has contact): every per-sample metric within
   1e-4·max|verts3d| (the CPU tests' bar against JAX) with the same NaN
   pattern. Then `apps.eval_interhand.main(["--synthetic", "--bs", "64",
   "--json"])` once (256 images, 4 forwards, their launches counted).
11. From-scratch recipe training: `apps.train --cfg configs/convergence_r5d.yaml
   --synthetic --synth_render --synth_n 256 --steps 20` on the card
   (`Config()`'s ResNet-50, bf16 encoder, f32 decoder, with the recipe's
   aux heads, zero-init heads, normal from epoch 16, camera 10, theta
   ±30, batch 128; 2 steps an epoch, so its in-training eval runs at steps
   8 and 16; checkpoints under build/). First B2 forward and dx in bf16
   at every shape of batch 128 as phase 7, and B2 and B1 as phase 10 at
   that batch. Held: exactly phase 8's 26 B2 launches a step, all on
   `wgmma` (the heads' convolutions are stock ones), plus 13 B2 and 24 B1
   for each eval forward; every loss term finite at every step, `aux_hms`
   > 0; the eval summaries finite; 10 AdamW steps on one fixed batch of
   128 lower the loss. Prints images/s, ms a step, and the aux heads'
   share of a step's device time: one profiled step on the fixed batch
   with the heads and one without (the same model and state, its heads
   not run), busy time under torch.profiler.
12. The `decoder="mano"` variant: `apps.train` on `Config()` with
   `decoder: mano` at batch 64, `--synthetic --steps 6` (the split carries
   MANO pose and shape labels). Held: 26 B2 launches a step, all on
   `wgmma`; `mano_pose` finite and > 0 and every term finite at every step.
13. Card against CPU on one f32 step of `Config()` with the aux heads and
   the MANO decoder, as phase 9 (one seed pair, batch 4, stored aux
   targets and MANO labels, the CPU on the card's ReLU, max-pool and
   hard-swish branches), with phase 9's limits over every parameter, the
   heads' included; a planted fault, the heatmap term's weight 10% off,
   must land outside them; the CPU on its own branches is printed.
14. The engine's buckets (1, 8, 32, 128), which phases 14 and 15 serve
   at. First B2 in bf16 (on `wgmma`) and B1 in f32 at every shape of a
   forward at each bucket against their plain versions on random inputs,
   at phase 2's tolerances (below 4 images an 8² map fills part of B2's
   4-image tile). Then every B2 and B1 call of one `Config()` forward
   (seed-0 weights) at batch 128, on its own activations: against its
   plain version at those tolerances, and on its first 1, 8 and 32
   images equal bit for bit to the whole batch's result (each kernel's
   result for an image does not depend on the batch). Then image 0
   served at bucket 1 and at 128 with a hook on every trunk module: the
   first module whose output parts must not be a B2 call (printed: which
   one, and the gap at each stage and output); with every stock
   convolution run one image at a time, every trunk module's output
   must be equal bit for bit at both buckets. Printed, not held: the
   kernels' forward against the plain B2 and B1's at each bucket, and the
   f32 engine across buckets. Then serving a model trained with the aux
   heads: `InferenceEngine` on the recipe config with phase 11's final
   weights, one bucket of 32 images.
   Held: 13 B2 and 24 B1 launches a forward and no forward of either aux
   head (the serve forward never asks for them); the outputs equal, within
   1e-6 of each output's largest value, those of an engine built without
   the heads on the same trunk and decoder weights.
15. HTTP: `serve_http.HandPoseHTTPServer` on 127.0.0.1 at an ephemeral
   port over the flagship engine (seed-0 weights): `/healthz`; three
   waves of 64 concurrent single-image npy requests (through the batcher),
   one npy batch of 32 (straight to `predict`) and one JSON request. Held:
   13 B2 and 24 B1 launches a forward, every B2 on `wgmma`; each response
   equal, within phase 3's 1e-4 of each output's largest value, to
   `engine.predict` of the same images batched as the server batched them
   (the batcher's calls are recorded; printed beside it, unheld, each
   single response against one predict of all 64, which runs another
   bucket: phase 14 traces that gap to cuDNN). Prints requests/s and p50/p99 latency of the last wave, with
   the card's name and power limit.
16. The result: a `{"kernels": [...]}` line (B1/B2 per flagship forward at
   batch 256 in the flagship's dtypes, B2 per training step at batch 64
   and per recipe training step at batch 128, B3 per refined sample), and
   as the last line `{"ok": true, "device": {...}}`.

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
DEVICE = "cuda"  # the card; a CPU rehearsal of phases 4-6 and 8-10 may set "cpu"
TRAIN_BATCH = 64  # the flagship's batch a card
TRAIN_SYNTH_N = 256
TRAIN_STEPS = 21
RESUME_TOL = 1e-3  # resumed vs uninterrupted step (phase 8)
GRAD_TOL = (2e-2, 3e-3, 0.95)  # card vs CPU: every tensor, the tier, its share (phase 9)
FIXED_BATCH_STEPS = 10
PARITY_BATCH = 4
TRAIN_PARITY_SEEDS = ((0, 2), (7, 1))  # (init, batch) seeds of phase 9
BN_BIAS_SHIFT = 3.0  # phase 9: the encoder's BatchNorm biases, raised
EVAL_N, EVAL_BATCH = 1024, 512
EVAL_CLI_BATCH = 64  # phase 10's run of apps.eval_interhand
EVAL_PARITY_N, EVAL_PARITY_BATCH = 10, 4
EVAL_RTOL = 1e-4  # card vs CPU per-sample metrics, relative to max|verts3d|
RECIPE_YAML = "configs/convergence_r5d.yaml"  # phase 11's recipe (batch 128)
RECIPE_SYNTH_N, RECIPE_STEPS = 256, 20  # 2 steps an epoch: evals at steps 8 and 16
MANO_STEPS = 6
RECIPE_PARITY_SEEDS = ((0, 2),)  # (init, batch) seeds of phase 13
AUX_SERVE_N = 32  # one bucket
AUX_SERVE_RTOL = 1e-6  # engines with and without the aux heads: the same computation
HTTP_REQUESTS, HTTP_BATCH, HTTP_WAVES = 64, 32, 3


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


def hold_conv(x, w, label: str):
    """B2 on (x, w) against its plain version at `CONV_TOL`, on the route
    its dtype takes (`wgmma` in bf16, `simt` in f32): (y, max|Δ|, route)."""
    import torch

    from renderih_tpu_torch.kernels import conv3x3

    dname = str(x.dtype).split(".")[1]
    route = "wgmma" if x.dtype == torch.bfloat16 else "simt"
    before = _routes()
    y = conv3x3.conv3x3_same(x, w)
    torch.cuda.synchronize()
    want_routes = dict(before, **{route: before[route] + 1})
    if _routes() != want_routes:
        raise AssertionError(f"{label}: routes {_routes()}, expected {want_routes}")
    return y, _check(label, y, conv3x3.conv3x3_reference(x, w), *CONV_TOL[dname]), route


def hold_mha(q, k, v, label: str):
    """B1 on (q, k, v) against the float32 plain version on the same
    (rounded) inputs, at `MHA_TOL` in f32 and `CONV_TOL` in bf16:
    (out, max|Δ|)."""
    import torch

    from renderih_tpu_torch.kernels import fused_attention

    tol = MHA_TOL if q.dtype == torch.float32 else CONV_TOL[str(q.dtype).split(".")[1]]
    out = fused_attention.fused_mha(q, k, v)
    torch.cuda.synchronize()
    ref = fused_attention.mha_reference(q.float(), k.float(), v.float())
    return out, _check(label, out, ref, *tol)


def hold_path_kernels(cfg, verts_nums, batch: int, seed: int) -> dict:
    """B2 in bf16 and B1 in f32, the flagship's dtypes, at every shape
    of a forward at `batch`, against their plain versions on random
    inputs: the largest max|Δ| of each."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    worst = {"conv3x3": 0.0, "fused_mha": 0.0}
    for side, c, _ in conv_shapes(cfg):
        x = torch.randn(batch, side, side, c, device=dev, generator=g).to(torch.bfloat16)
        w = (torch.randn(3, 3, c, c, device=dev, generator=g) / (9 * c) ** 0.5).to(torch.bfloat16)
        err = hold_conv(x, w, f"conv3x3 bfloat16 batch {batch} {side}²x{c}")[1]
        worst["conv3x3"] = max(worst["conv3x3"], err)
        del x, w
    heads = cfg.model.num_attn_heads
    for n, d, _ in mha_shapes(cfg, verts_nums):
        q, k, v = (torch.randn(batch, n, heads, d, device=dev, generator=g) for _ in range(3))
        err = hold_mha(q, k, v, f"fused_mha float32 batch {batch} N={n} D={d}")[1]
        worst["fused_mha"] = max(worst["fused_mha"], err)
        del q, k, v
    torch.cuda.empty_cache()
    return worst


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
            y, err, route = hold_conv(x, w, f"conv3x3 {dname} {side}²x{c}")
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
            out, err = hold_mha(q, k, v, f"fused_mha {dname} N={n} D={d}")
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


def profile_phase(label: str, fn, top: int = 30) -> dict:
    """Device time by kernel over one call of `fn` (torch.profiler): only
    device-side events count (kernels, memcpy, memset), and the busy time
    is the union of their intervals. Prints the `top` kernels by time."""
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
          f"{len(spans)} device events" + ("; by kernel:" if top else ""), flush=True)
    for ms, count, name in rows[:top]:
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


def conv_backward_phase(cfg, batch: int = TRAIN_BATCH, dtypes: tuple = ("bfloat16", "float32"),
                        seed: int = 1) -> list:
    """B2's backward at every training shape of `batch`, in `dtypes` (see
    the module docstring, phase 7; phase 11 at the recipe's batch)."""
    import torch
    import torch.nn.functional as F

    from renderih_tpu_torch.kernels import conv3x3

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = []
    for dtype in (getattr(torch, d) for d in dtypes):
        dname = str(dtype).split(".")[1]
        atol, rtol = CONV_TOL[dname]
        route = "wgmma" if dtype == torch.bfloat16 else "simt"
        for side, c, per_fwd in conv_shapes(cfg):
            shape = (batch, side, side, c)
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
            flops = 2 * batch * side * side * c * c * 9
            dx = lambda: conv3x3.conv3x3_same(gy, w.flip(0, 1).transpose(2, 3).contiguous())
            row = dict(
                dtype=dname, shape=[batch, side, side, c, c],
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
            print(f"[B2-bwd] {name} x({batch},{side},{side},{c}): dx max|Δ| "
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

    per_fwd_b2 = sum(n for _, _, n in conv_shapes(cfg))  # 13
    per_fwd_b1 = sum(n for _, _, n in mha_shapes(cfg, assets.left.verts_nums))  # 24
    per_step = 2 * per_fwd_b2  # 13 forward + 13 dx
    common = ["--synthetic", "--synth_n", str(TRAIN_SYNTH_N), "--device", DEVICE,
              "--steps", str(TRAIN_STEPS)]
    spe = TRAIN_SYNTH_N // cfg.train.batch_size
    cut_epoch = (TRAIN_STEPS - 1) // spe  # the last whole epoch before the end
    yaml = lambda root, name: _train_yaml(cfg, root, name, log_every=1, save_gap=cut_epoch,
                                          eval_every=cut_epoch, seed=0)
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
        if [e["step"] for e in a["evals"]] != [cut_epoch * spe]:
            raise AssertionError(f"evals at steps {[e['step'] for e in a['evals']]}, expected "
                                 f"one (EMA off) at step {cut_epoch * spe}")
        (ev,) = a["evals"]
        # the eval's forwards: one a batch of the held-out split, one for the overlays
        n_eval_fwd = -(-ev["summary"]["num_samples"] // cfg.train.batch_size) + 1
        want = {"conv3x3": per_step * n_steps + per_fwd_b2 * n_eval_fwd,
                "fused_mha": per_fwd_b1 * n_eval_fwd, "sdf_grid": 0}
        print(f"[train] apps.train --synthetic --synth_n {TRAIN_SYNTH_N} --steps {TRAIN_STEPS}, "
              f"Config() at batch {cfg.train.batch_size}: {n_steps} steps and {n_eval_fwd} eval "
              f"forwards, launches {launches} (expected {want}), B2 routes {routes}", flush=True)
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
        metrics = {k: v for k, v in ev["summary"].items() if k.endswith("_mm")}
        if not all(np.isfinite(v) for k, v in metrics.items() if not k.startswith("cdev")):
            raise AssertionError(f"eval summary not finite: {metrics}")
        print(f"[train] eval at epoch {cut_epoch} (step {ev['step']}) of the "
              f"{ev['summary']['num_samples']}-sample held-out split at batch "
              f"{cfg.train.batch_size}: {ev['seconds']:.2f} s (the overlays not included); "
              + ", ".join(f"{k} {v:.2f}" for k, v in metrics.items()), flush=True)
        taken = torch.load(f"{root}/straight/epoch_{cut_epoch}/state.pt", weights_only=True,
                           map_location="cpu").get("steps_taken")
        if taken != cut_epoch * spe:
            raise AssertionError(f"epoch_{cut_epoch} holds steps_taken {taken}, "
                                 f"expected {cut_epoch * spe}")

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
                      routes=routes, images_per_s=ips, eval_summary=ev["summary"],
                      eval_seconds=ev["seconds"],
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


def _two_d_weight_off(cfg) -> str:
    cfg.loss.label_2d *= 1.1
    return "the 2-D term's weight 10% off"


def train_parity_phase(cfg, assets, seeds=TRAIN_PARITY_SEEDS, tag="train-parity",
                       plant=_two_d_weight_off, make_batch=None) -> list:
    """Card against CPU: one SGD step of `cfg` in f32, the CPU on the
    card's branches (see the module docstring, phases 9 and 13), at each
    (init, batch) seed pair; `plant` puts a fault into a copy of the
    config, which must land outside the limits at the first pair;
    `make_batch(seed)` makes a batch (default: `synthetic_batch`)."""
    import contextlib
    import copy

    import torch

    from renderih_tpu_torch.data.synthetic import synthetic_batch
    from renderih_tpu_torch.models import init_model
    from renderih_tpu_torch.models.layers import BatchNorm2d
    from renderih_tpu_torch.train.state import create_train_state
    from renderih_tpu_torch.train.trainer import make_train_step
    from renderih_tpu_torch.utils.branches import gradient_gaps, record_branches, take_branches

    pcfg = copy.deepcopy(cfg)
    pcfg.train.optimizer, pcfg.train.precision, pcfg.train.lr = "sgd", "f32", 1.0
    pcfg.train.warmup_epochs, pcfg.model.dropout = 0, 0.0
    fault = copy.deepcopy(pcfg)
    fault_name = plant(fault)
    if make_batch is None:
        make_batch = lambda seed: synthetic_batch(
            assets, torch.Generator().manual_seed(seed), PARITY_BATCH, cfg.model.img_size)

    def step(run_cfg, dev, init_seed, batch, branches):
        model = init_model(run_cfg, assets, torch.Generator().manual_seed(init_seed))
        with torch.no_grad():
            for mod in model.encoder.modules():
                if isinstance(mod, BatchNorm2d):
                    mod.bias += BN_BIAS_SHIFT
        model = model.to(dev, memory_format=torch.channels_last)
        state = create_train_state(run_cfg, model, 10)
        with branches as taken:
            terms = make_train_step(run_cfg, assets, 10, dev)(
                state, {k: v.to(dev) for k, v in batch.items()})
        return dict(terms={k: float(v) for k, v in terms.items()},
                    grads={k: p.grad.cpu() for k, p in model.named_parameters()
                           if p.grad is not None},
                    bn={k: v.cpu() for k, v in model.state_dict().items()
                        if k.endswith(("running_mean", "running_var"))}), taken

    def share(gaps):
        return {t: sum(e <= t for e in gaps.values()) / len(gaps)
                for t in (1e-4, 1e-3, 3e-3, 1e-2)}

    def line(gaps):
        worst = sorted(gaps, key=gaps.get, reverse=True)[:3]
        sh = share(gaps)
        return (f"worst {', '.join(f'{gaps[k]:.2e} ({k})' for k in worst)}; of {len(gaps)} "
                f"tensors {100 * sh[1e-4]:.1f}% within 1e-4, {100 * sh[1e-3]:.1f}% within "
                f"1e-3, {100 * sh[3e-3]:.1f}% within 3e-3, {100 * sh[1e-2]:.1f}% within 1e-2")

    def within(gaps):
        return max(gaps.values()) <= GRAD_TOL[0] and share(gaps)[GRAD_TOL[1]] >= GRAD_TOL[2]

    rows, ok = [], True
    for init_seed, batch_seed in seeds:
        with torch.no_grad():
            batch = make_batch(batch_seed)
        card, taken = step(pcfg, DEVICE, init_seed, batch, record_branches())
        cpu, _ = step(pcfg, "cpu", init_seed, batch, take_branches(taken))
        if card["grads"].keys() != cpu["grads"].keys():
            raise AssertionError("card and CPU trained different parameters")
        term_err = max(abs(card["terms"][k] - v) / max(abs(v), 1e-12)
                       for k, v in cpu["terms"].items())
        gaps = gradient_gaps(card["grads"], cpu["grads"])
        bn_err = max(float((card["bn"][k] - v).abs().max() / v.abs().max())
                     for k, v in cpu["bn"].items())
        row = dict(init_seed=init_seed, batch_seed=batch_seed, branches=len(taken),
                   terms_rel=term_err, grad_rel=gaps, grad_share=share(gaps), bn_rel=bn_err)
        print(f"[{tag}] one SGD step, {cfg.model.encoder} at {cfg.model.img_size}² (aux heads "
              f"{'on' if cfg.model.with_aux_heads else 'off'}, decoder {cfg.model.decoder}) in "
              f"f32, TF32 off, dropout 0, batch "
              f"{PARITY_BATCH}, init_model seed {init_seed} with the encoder's BatchNorm biases "
              f"+{BN_BIAS_SHIFT:g}, batch seed {batch_seed}, the CPU "
              f"on the card's branches ({len(taken)} ReLU, max-pool and hard-swish calls): loss terms rel "
              f"max|Δ| {term_err:.2e} (limit 1e-4); gradients, max|Δ| over each tensor's "
              f"scale: {line(gaps)} (limits: every tensor {GRAD_TOL[0]:g}, "
              f"{100 * GRAD_TOL[2]:g}% within {GRAD_TOL[1]:g}); BatchNorm statistics "
              f"{bn_err:.2e} (limit 1e-5)", flush=True)
        ok &= term_err <= 1e-4 and within(gaps) and bn_err <= 1e-5
        free, _ = step(pcfg, "cpu", init_seed, batch, contextlib.nullcontext())
        free_gaps = gradient_gaps(card["grads"], free["grads"])
        print(f"[{tag}] the same, the CPU on its own branches (not held): "
              f"{line(free_gaps)}", flush=True)
        row.update(free_grad_rel=max(free_gaps.values()), free_share=share(free_gaps))
        del free
        if not rows:  # a planted fault on the same branches must land outside
            wrong, _ = step(fault, "cpu", init_seed, batch, take_branches(taken))
            fault_gaps = gradient_gaps(wrong["grads"], cpu["grads"])
            print(f"[{tag}] planted fault, {fault_name}, on the CPU: "
                  f"{line(fault_gaps)}", flush=True)
            row.update(fault_grad_rel=max(fault_gaps.values()), fault_share=share(fault_gaps))
            if within(fault_gaps):
                raise AssertionError("the gradient limits do not see a planted fault")
        rows.append(row)
        del card, cpu, taken
        torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("card and CPU training steps disagree")
    return rows


def _contact_split(root: str, assets, n: int, seed: int):
    """A synthetic packed split whose samples 0-4 have the right hand moved
    onto the left (ground-truth contact, so CDev is a number there)."""
    import numpy as np

    from renderih_tpu_torch.data.interhand import PackedInterHand, make_synthetic_packed

    make_synthetic_packed(root, "test", assets, n=n, seed=seed)
    labels = dict(np.load(f"{root}/test_labels.npz"))
    rng = np.random.default_rng(seed)
    labels["v3d_right"][:5] = (labels["v3d_left"][:5] + [0.002, 0.0, 0.0]
                               + rng.normal(0, 0.001, (5, 778, 3))).astype(np.float32)
    np.savez(f"{root}/test_labels.npz", **labels)
    return PackedInterHand.load(root, "test")


def eval_phase(cfg, assets, gpu_line: str, profile: bool = False) -> dict:
    """The eval path on the card (see the module docstring, phase 10)."""
    import copy
    import tempfile

    import numpy as np
    import torch

    from renderih_tpu_torch.apps import eval_interhand
    from renderih_tpu_torch.data.interhand import make_synthetic_packed
    from renderih_tpu_torch.eval.evaluator import (
        eval_mode,
        evaluate_packed,
        evaluate_vectors,
        make_eval_fn,
    )
    from renderih_tpu_torch.eval.metrics import two_hand_metrics
    from renderih_tpu_torch.kernels import _build, conv3x3, fused_attention, sdf
    from renderih_tpu_torch.models import HandNet, init_model, model_call_kwargs
    from renderih_tpu_torch.ops.image import normalize_imagenet

    dev = torch.device(DEVICE)
    counters = (conv3x3.launches, fused_attention.launches, sdf.launches,
                *conv3x3.routes.values())
    per_fwd = {"conv3x3": sum(n for _, _, n in conv_shapes(cfg)),  # 13
               "fused_mha": sum(n for _, _, n in mha_shapes(cfg, assets.left.verts_nums)),
               "sdf_grid": 0}

    def counted(fn):
        """fn()'s result, the forwards of a `HandNet` it ran and its kernel
        launches, which must be per_fwd a forward with every B2 on wgmma."""
        forwards = [0]
        hook = torch.nn.modules.module.register_module_forward_pre_hook(
            lambda mod, args: forwards.__setitem__(0, forwards[0] + isinstance(mod, HandNet)))
        for counter in counters:
            counter.reset()
        try:
            out = fn()
        finally:
            hook.remove()
        launches = {"conv3x3": conv3x3.launches.value,
                    "fused_mha": fused_attention.launches.value, "sdf_grid": sdf.launches.value}
        want = {k: n * forwards[0] for k, n in per_fwd.items()}
        if forwards[0] == 0 or launches != want or _routes() != {"simt": 0,
                                                                 "wgmma": want["conv3x3"]}:
            raise AssertionError(f"{forwards[0]} forwards: launches {launches}, B2 routes "
                                 f"{_routes()}; expected {want}, all B2 on wgmma")
        return out, forwards[0], launches

    held = {}
    for seed, batch in enumerate((EVAL_BATCH, EVAL_CLI_BATCH)):
        held[batch] = hold_path_kernels(cfg, assets.left.verts_nums, batch, seed=10 + seed)
        print(f"[eval] the path's kernels at batch {batch} against their plain versions, "
              f"every shape of a forward: B2 bfloat16 (wgmma) max|Δ| "
              f"{held[batch]['conv3x3']:.3e} (atol/rtol {CONV_TOL['bfloat16']}), B1 float32 "
              f"max|Δ| {held[batch]['fused_mha']:.3e} (atol/rtol {MHA_TOL})", flush=True)

    _build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)  # build/, git-ignored
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as root:
        t0 = time.perf_counter()
        data = make_synthetic_packed(f"{root}/split", "test", assets, n=EVAL_N, seed=0)
        make_s = time.perf_counter() - t0
        model = init_model(cfg, assets, torch.Generator().manual_seed(0))
        model = model.to(dev, memory_format=torch.channels_last)
        summary, n_fwd, launches = counted(lambda: evaluate_packed(
            cfg, model, assets, data, batch_size=EVAL_BATCH, device=dev))
        if not summary["device_cache"] or n_fwd != -(-EVAL_N // EVAL_BATCH):
            raise AssertionError(f"device cache {summary['device_cache']}, {n_fwd} forwards")
        metrics = {k: v for k, v in summary.items() if k.endswith("_mm")}
        if not all(np.isfinite(v) for k, v in metrics.items() if not k.startswith("cdev")):
            raise AssertionError(f"eval summary not finite: {metrics}")
        print(f"[eval] evaluate_packed, Config() seed-0 weights, {EVAL_N} synthetic images "
              f"(written in {make_s:.1f} s) at batch {EVAL_BATCH}: {n_fwd} forwards, launches "
              f"{launches}, B2 all wgmma; {summary['images_per_sec']:.1f} images/s (batches "
              f"after the first), device cache upload {summary['cache_upload_s']:.3f} s; "
              + ", ".join(f"{k} {v:.2f}" for k, v in metrics.items())
              + f" on {gpu_line}", flush=True)

        # one batch: forward and metrics timed apart; the metrics with TF32
        # allowed must be bit-equal (no matmul in them)
        img_u8, v3l, v3r = (torch.from_numpy(data.batch(np.arange(EVAL_BATCH))[k]).to(dev)
                            for k in ("img_u8", "v3d_left", "v3d_right"))
        kw = model_call_kwargs(assets, dev)
        j_reg = {h: getattr(assets, h).j_reg_21.to(dev) for h in ("left", "right")}
        with eval_mode(model):
            img = normalize_imagenet(img_u8.float() / 255.0)
            verts = model(img, **kw).verts3d
            metric = lambda: two_hand_metrics(verts, {"left": v3l, "right": v3r}, j_reg)
            fwd_ms = _time_ms(lambda: model(img, **kw), iters=5, warmup=1)
            met_ms = _time_ms(metric, iters=5, warmup=1)
            strict = metric()
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                loose = metric()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
        same = lambda a, b: bool(((a == b) | (a.isnan() & b.isnan())).all())
        if not all(same(strict[k], loose[k]) for k in strict):
            raise AssertionError("the eval metrics move with TF32: a matmul is in them")
        print(f"[eval] one batch of {EVAL_BATCH}: forward {fwd_ms:.2f} ms, metrics "
              f"{met_ms:.2f} ms ({100 * met_ms / (fwd_ms + met_ms):.1f}% of the batch; CUDA "
              f"events, 5 calls); metrics bit-equal with TF32 allowed", flush=True)
        result = dict(held=held, summary=summary, forwards=n_fwd, launches=launches,
                      make_s=make_s,
                      forward_ms=fwd_ms, metrics_ms=met_ms,
                      metrics_share=met_ms / (fwd_ms + met_ms))
        if profile:
            fn = make_eval_fn(model, assets, dev)
            with eval_mode(model):
                result["profile"] = profile_phase(
                    f"one eval batch of {EVAL_BATCH} (forward and metrics)",
                    lambda: float(fn(img_u8, v3l, v3r)["mpjpe_left"].sum()))
        del model, img_u8, v3l, v3r, img, verts, strict, loose
        torch.cuda.empty_cache()

        # card against CPU, f32, TF32 off
        cfg32 = copy.deepcopy(cfg)
        cfg32.train.precision = "f32"
        small = _contact_split(f"{root}/parity", assets, EVAL_PARITY_N, seed=3)
        vec = {}
        for d in (DEVICE, "cpu"):
            m = init_model(cfg32, assets, torch.Generator().manual_seed(0))
            m = m.to(d, memory_format=torch.channels_last)
            vec[d], _ = evaluate_vectors(cfg32, m, assets, small, batch_size=EVAL_PARITY_BATCH,
                                         device=d)
            if d == DEVICE:
                with eval_mode(m):
                    out = m(normalize_imagenet(torch.from_numpy(np.array(small.images)).to(d)
                                               .float() / 255.0), **model_call_kwargs(assets, d))
                scale = max(float(v.abs().max()) for v in out.verts3d.values())
            del m
        errs = {}
        for k, ref in vec["cpu"].items():
            got = vec[DEVICE][k]
            if not np.array_equal(np.isnan(got), np.isnan(ref)):
                raise AssertionError(f"{k}: NaN pattern card {np.isnan(got)} vs CPU {np.isnan(ref)}")
            ok = ~np.isnan(ref)
            errs[k] = float(np.abs(got[ok] - ref[ok]).max(initial=0.0))
        worst = max(errs, key=errs.get)
        n_contact = int(np.isfinite(vec["cpu"]["cdev"]).sum())
        print(f"[eval-parity] f32, TF32 off, {EVAL_PARITY_N} images at batch "
              f"{EVAL_PARITY_BATCH}: card vs CPU per-sample metrics, worst {worst} "
              f"{errs[worst]:.3e} m (limit {EVAL_RTOL:g}·max|verts3d| = "
              f"{EVAL_RTOL * scale:.3e}); cdev NaN pattern equal ({n_contact} samples in "
              f"contact)", flush=True)
        if errs[worst] > EVAL_RTOL * scale or n_contact < 5:
            raise AssertionError("card and CPU eval metrics disagree")
        result.update(parity_errs=errs, parity_limit=EVAL_RTOL * scale)

        # the CLI once
        t0 = time.perf_counter()
        cli, cli_fwd, cli_launches = counted(lambda: eval_interhand.main(
            ["--synthetic", "--bs", str(EVAL_CLI_BATCH), "--json"]))
        if cli_fwd != 256 // EVAL_CLI_BATCH or not np.isfinite(cli["mpjpe_mm"]):
            raise AssertionError(f"eval_interhand: {cli_fwd} forwards, mpjpe {cli['mpjpe_mm']}")
        print(f"[eval] apps.eval_interhand --synthetic --bs {EVAL_CLI_BATCH} --json: {cli_fwd} "
              f"forwards, "
              f"launches {cli_launches}, B2 all wgmma, mpjpe {cli['mpjpe_mm']:.2f} mm, "
              f"{cli['images_per_sec']:.1f} images/s, {time.perf_counter() - t0:.1f} s in all",
              flush=True)
        result.update(cli=cli, cli_launches=cli_launches)
    torch.cuda.empty_cache()
    return result


def _counters():
    from renderih_tpu_torch.kernels import conv3x3, fused_attention, sdf

    return (conv3x3.launches, fused_attention.launches, sdf.launches,
            *conv3x3.routes.values())


def _launches() -> dict:
    from renderih_tpu_torch.kernels import conv3x3, fused_attention, sdf

    return {"conv3x3": conv3x3.launches.value, "fused_mha": fused_attention.launches.value,
            "sdf_grid": sdf.launches.value}


def _check_run_launches(label: str, launches: dict, want: dict) -> None:
    """The path's launches, reset to 0 before it ran, against `want`, every
    B2 on `wgmma`; a kernel the path runs must have launched."""
    if launches != want or _routes() != {"simt": 0, "wgmma": want["conv3x3"]}:
        raise AssertionError(f"{label}: launches {launches}, B2 routes {_routes()}; expected "
                             f"{want}, every B2 on wgmma")
    if not launches["conv3x3"]:
        raise AssertionError(f"{label}: B2 never launched")


def recipe_config(cfg):
    """`configs/convergence_r5d.yaml` (the newest from-scratch recipe: aux
    heads, zero-init heads, normal from epoch 16, camera 10, theta ±30,
    batch 128) on `cfg`'s assets; its checkpoint directory is replaced by
    the caller."""
    import os

    from renderih_tpu_torch.config import load_config

    rc = load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)), RECIPE_YAML))
    rc.assets = cfg.assets
    return rc


def recipe_train_phase(cfg, assets, gpu_line: str, profile: bool = False) -> tuple:
    """From-scratch recipe training on the card (see the module docstring,
    phase 11). Returns (result, the final checkpoint's model state_dict)."""
    import copy
    import tempfile

    import numpy as np
    import torch

    from renderih_tpu_torch.apps import train as train_app
    from renderih_tpu_torch.data.interhand import PackedInterHand
    from renderih_tpu_torch.data.pipeline import device_augment
    from renderih_tpu_torch.kernels import _build
    from renderih_tpu_torch.models import init_model
    from renderih_tpu_torch.train.state import checkpoint_state_dict, create_train_state
    from renderih_tpu_torch.train.trainer import make_train_step

    rcfg = recipe_config(cfg)
    batch = rcfg.train.batch_size
    per_fwd_b2 = sum(n for _, _, n in conv_shapes(rcfg))  # 13
    per_fwd_b1 = sum(n for _, _, n in mha_shapes(rcfg, assets.left.verts_nums))  # 24
    spe = RECIPE_SYNTH_N // batch
    _build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)  # build/, git-ignored
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as root:
        yaml = _train_yaml(rcfg, root, "recipe", log_every=1)
        for counter in _counters():
            counter.reset()
        t0 = time.perf_counter()
        run = train_app.main(["--cfg", yaml, "--synthetic", "--synth_render", "--synth_n",
                              str(RECIPE_SYNTH_N), "--steps", str(RECIPE_STEPS),
                              "--device", DEVICE])
        seconds = time.perf_counter() - t0
        launches = _launches()
        n_steps = run["final_step"]
        eval_steps = [e["step"] for e in run["evals"]]
        want_evals = [s for s in range(1, RECIPE_STEPS + 1)
                      if s % spe == 0 and (s // spe) % rcfg.train.eval_every == 0]
        if n_steps != RECIPE_STEPS or eval_steps != want_evals:
            raise AssertionError(f"{n_steps} steps, evals at {eval_steps} (expected "
                                 f"{RECIPE_STEPS}, {want_evals})")
        # each eval: one forward a batch of the held-out split, one for the overlays
        n_eval_fwd = sum(-(-e["summary"]["num_samples"] // batch) + 1 for e in run["evals"])
        want = {"conv3x3": 2 * per_fwd_b2 * n_steps + per_fwd_b2 * n_eval_fwd,
                "fused_mha": per_fwd_b1 * n_eval_fwd, "sdf_grid": 0}
        print(f"[recipe] apps.train --cfg {RECIPE_YAML} --synthetic --synth_render --synth_n "
              f"{RECIPE_SYNTH_N} --steps {RECIPE_STEPS} ({rcfg.model.encoder}, "
              f"{rcfg.train.precision} encoder, aux heads, batch {batch}): {n_steps} steps and {n_eval_fwd} eval forwards in "
              f"{seconds:.1f} s, launches {launches} (expected {want}; the aux heads' convs are "
              f"stock), B2 routes {_routes()}", flush=True)
        _check_run_launches("recipe training", launches, want)
        for step, terms in run["logged"]:
            if (not all(np.isfinite(v) for v in terms.values()) or terms["skipped_nonfinite"]
                    or not terms["aux_hms"] > 0):
                raise AssertionError(f"step {step}: terms {terms}")
        aux_hms = [t["aux_hms"] for _, t in run["logged"]]
        first, last = run["logged"][0][1], run["logged"][-1][1]
        for ev in run["evals"]:
            metrics = {k: v for k, v in ev["summary"].items() if k.endswith("_mm")}
            if not all(np.isfinite(v) for k, v in metrics.items() if not k.startswith("cdev")):
                raise AssertionError(f"eval at step {ev['step']}: not finite: {metrics}")
        steady = run["step_seconds"][train_app.WARMUP_STEPS:]
        print(f"[recipe] loss {first['total']:.4f} -> {last['total']:.4f}, aux_hms "
              f"{aux_hms[0]:.5f} -> {aux_hms[-1]:.5f} (every term finite at every step, aux_hms "
              f"> 0, none skipped); evals at steps {eval_steps}: "
              + "; ".join(f"mpjpe {e['summary']['mpjpe_mm']:.2f} mm" for e in run["evals"])
              + f"; {run['images_per_s']:.1f} images/s, {1e3 * np.median(steady):.1f} ms a step "
              f"(median of steps {train_app.WARMUP_STEPS + 1}-{n_steps}) on {gpu_line}",
              flush=True)
        state_dict = checkpoint_state_dict(run["checkpoint"])

        # 10 AdamW steps on one fixed batch lower the loss (as phase 8);
        # then one step with and one without the aux heads, profiled
        fcfg = copy.deepcopy(rcfg)
        fcfg.train.warmup_epochs, fcfg.train.lr = 0, 1e-3
        data = PackedInterHand.load(f"{root}/recipe/_synth_data", "train")
        raw = {k: torch.from_numpy(v).to(DEVICE) for k, v in data.batch(np.arange(batch)).items()}
        fixed = device_augment(raw, torch.Generator(device=DEVICE).manual_seed(0),
                               img_size=rcfg.model.img_size)
        model = init_model(fcfg, assets, torch.Generator().manual_seed(0))
        state = create_train_state(fcfg, model.to(DEVICE, memory_format=torch.channels_last),
                                   steps_per_epoch=1000)
        step = make_train_step(fcfg, assets, 1000, DEVICE)
        losses = [float(step(state, fixed, torch.Generator(device=DEVICE).manual_seed(1))["total"])
                  for _ in range(FIXED_BATCH_STEPS)]
        print(f"[recipe] {FIXED_BATCH_STEPS} AdamW steps (lr 1e-3, no warmup) on one fixed batch "
              f"of {batch}: loss {' '.join(f'{v:.2f}' for v in losses)}", flush=True)
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"loss did not fall on a fixed batch: {losses}")
        off = copy.deepcopy(fcfg)
        off.model.with_aux_heads = False  # the same model, its heads not run
        step_off = make_train_step(off, assets, 1000, DEVICE)
        prof = {name: profile_phase(f"one recipe step at batch {batch}, aux heads {name}",
                                    lambda fn=fn: float(fn(state, fixed)["total"]),
                                    top=30 if profile else 0)
                for name, fn in (("on", step), ("off", step_off))}
        share = 1.0 - prof["off"]["busy_ms"] / prof["on"]["busy_ms"]
        print(f"[recipe] the aux heads' share of a step's device time: {100 * share:.1f}% "
              f"(busy {prof['on']['busy_ms']:.2f} ms with them, {prof['off']['busy_ms']:.2f} "
              f"ms without, under the profiler) on {gpu_line}", flush=True)
        result = dict(steps=n_steps, launches=launches, routes=_routes(),
                      eval_forwards=n_eval_fwd, seconds=seconds,
                      images_per_s=run["images_per_s"], step_ms=1e3 * float(np.median(steady)),
                      step_seconds=run["step_seconds"], loss_first=first["total"],
                      loss_last=last["total"], aux_hms=aux_hms,
                      evals=[dict(step=e["step"], summary=e["summary"]) for e in run["evals"]],
                      fixed_batch_losses=losses, aux_share=share, profile=prof)
    del state, model, fixed, raw
    torch.cuda.empty_cache()
    return result, state_dict


def mano_train_phase(cfg, assets, gpu_line: str) -> dict:
    """`decoder="mano"` training on the card (see the module docstring,
    phase 12)."""
    import copy
    import tempfile

    import numpy as np
    import torch

    from renderih_tpu_torch.apps import train as train_app
    from renderih_tpu_torch.kernels import _build

    mcfg = copy.deepcopy(cfg)
    mcfg.model.decoder = "mano"
    per_step = 2 * sum(n for _, _, n in conv_shapes(mcfg))  # 26
    _build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as root:
        yaml = _train_yaml(mcfg, root, "mano", log_every=1, eval_every=1000, save_gap=1000)
        for counter in _counters():
            counter.reset()
        run = train_app.main(["--cfg", yaml, "--synthetic", "--synth_n", str(TRAIN_SYNTH_N),
                              "--steps", str(MANO_STEPS), "--device", DEVICE])
        launches = _launches()
    n_steps = run["final_step"]
    want = {"conv3x3": per_step * n_steps, "fused_mha": 0, "sdf_grid": 0}
    _check_run_launches("mano training", launches, want)
    for step, terms in run["logged"]:
        if not (all(np.isfinite(v) for v in terms.values()) and terms["mano_pose"] > 0
                and not terms["skipped_nonfinite"]):
            raise AssertionError(f"step {step}: terms {terms}")
    mano = {k: [t[k] for _, t in run["logged"]] for k in ("mano_pose", "mano_shape", "total")}
    print(f"[mano] apps.train, Config() with decoder mano, batch {mcfg.train.batch_size}, "
          f"--synthetic --steps {MANO_STEPS}: {n_steps} steps, launches {launches} (expected "
          f"{want}), every B2 on wgmma; mano_pose "
          f"{' '.join(f'{v:.4f}' for v in mano['mano_pose'])}, total "
          f"{mano['total'][0]:.4f} -> {mano['total'][-1]:.4f}, every term finite; "
          f"{run['images_per_s']:.1f} images/s on {gpu_line}", flush=True)
    torch.cuda.empty_cache()
    return dict(steps=n_steps, launches=launches, terms=mano, images_per_s=run["images_per_s"])


def recipe_parity_phase(cfg, assets) -> list:
    """Card against CPU on one f32 step with the aux heads and the MANO
    decoder (see the module docstring, phase 13)."""
    import copy

    import numpy as np
    import torch

    from renderih_tpu_torch.data.synthetic import synthetic_batch

    pcfg = copy.deepcopy(cfg)
    pcfg.model.with_aux_heads, pcfg.model.decoder = True, "mano"

    def make_batch(seed):
        batch = synthetic_batch(assets, torch.Generator().manual_seed(seed), PARITY_BATCH,
                                cfg.model.img_size, with_aux=True)
        rng = np.random.default_rng(seed)
        for h in ("left", "right"):
            batch[f"pose_{h}"] = torch.from_numpy(
                (rng.normal(size=(PARITY_BATCH, 48)) * 0.3).astype(np.float32))
            batch[f"shape_{h}"] = torch.from_numpy(
                rng.normal(size=(PARITY_BATCH, 10)).astype(np.float32))
        return batch

    def plant(c):
        c.loss.hms *= 1.1
        return "the heatmap term's weight 10% off"

    return train_parity_phase(pcfg, assets, seeds=RECIPE_PARITY_SEEDS, tag="recipe-parity",
                              plant=plant, make_batch=make_batch)


def _trunk_trace(engine, images) -> tuple:
    """One `engine.predict(images)` with a hook on every module of the
    trunk: ([(module name, its output for image 0)] in the order the
    modules finished, the outputs for image 0)."""
    trace, handles = [], []
    for name, mod in engine.model.encoder.resnet.named_modules():
        if name:
            handles.append(mod.register_forward_hook(
                lambda m, a, out, name=name: trace.append((name, out[0].clone()))))
    try:
        out = engine.predict(images)
    finally:
        for h in handles:
            h.remove()
    return trace, {k: v[0] for k, v in out.items()}


def _rel_gaps(got: dict, ref: dict) -> dict:
    """max|Δ| / max|ref| of each output."""
    import numpy as np

    return {k: float(np.abs(got[k] - r).max() / max(np.abs(r).max(), 1e-30))
            for k, r in ref.items()}


def bucket_phase(cfg, assets) -> dict:
    """The serving engine's buckets (see the module docstring, phase 14)."""
    import copy

    import numpy as np
    import torch

    from renderih_tpu_torch.kernels import conv3x3, fused_attention
    from renderih_tpu_torch.models import attention, layers, resnet
    from renderih_tpu_torch.serve import InferenceEngine

    engine = InferenceEngine(cfg, assets=assets, device=DEVICE, seed=0)
    buckets = engine.buckets
    size = cfg.model.img_size
    images = np.random.default_rng(6).integers(0, 256, (buckets[-1], size, size, 3), np.uint8)
    held = {b: hold_path_kernels(cfg, assets.left.verts_nums, b, seed=20 + i)
            for i, b in enumerate(buckets)}
    print("[buckets] the path's kernels at each bucket against their plain versions on random "
          "inputs, max|Δ| B2 bfloat16 (wgmma) / B1 float32: "
          + ", ".join(f"batch {b} {h['conv3x3']:.3e} / {h['fused_mha']:.3e}"
                      for b, h in held.items()), flush=True)

    # every B2 and B1 call of one forward at the largest bucket, on its own
    # activations: against the plain version, and on its first b images
    # against itself
    calls = []

    def recorded(fn, kind):
        def call(*args):
            out = fn(*args)
            calls.append((kind, args, out))
            return out
        return call

    resnet.conv3x3_same = recorded(conv3x3.conv3x3_same, "conv3x3")
    attention.fused_mha = recorded(fused_attention.fused_mha, "fused_mha")
    try:
        engine.predict(images)
    finally:
        resnet.conv3x3_same, attention.fused_mha = conv3x3.conv3x3_same, fused_attention.fused_mha
    worst = {"conv3x3": 0.0, "fused_mha": 0.0}
    variant = []
    with torch.inference_mode():
        for i, (kind, args, out) in enumerate(calls):
            label = f"{kind} call {i} of a forward at batch {buckets[-1]} {tuple(out.shape)}"
            if kind == "conv3x3":
                ref = conv3x3.conv3x3_reference(*args)
                err = _check(label, out, ref, *CONV_TOL[str(out.dtype).split(".")[1]])
                part = lambda b: conv3x3.conv3x3_same(args[0][:b], args[1])
            else:
                ref = fused_attention.mha_reference(*(a.float() for a in args))
                err = _check(label, out, ref, *MHA_TOL)
                part = lambda b: fused_attention.fused_mha(*(a[:b] for a in args))
            worst[kind] = max(worst[kind], err)
            for b in buckets[:-1]:
                if not torch.equal(part(b), out[:b]):
                    variant.append(f"{label} on its first {b} images")
            del ref
    n_calls = {k: sum(c[0] == k for c in calls) for k in worst}
    del calls
    if variant:
        raise AssertionError("a kernel's result for an image depends on the batch: "
                             + "; ".join(variant))

    # image 0 served at bucket 1 and at the largest: where the two part
    served = {b: _trunk_trace(engine, images[:b]) for b in (buckets[0], buckets[-1])}
    (trace_a, out_a), (trace_b, out_b) = served.values()
    first = next(((name, float((a.float() - b.float()).abs().max()
                               / b.float().abs().max().clamp_min(1e-30)))
                  for (name, a), (_, b) in zip(trace_a, trace_b) if not torch.equal(a, b)),
                 None)
    stages = {name: float((a.float() - b.float()).abs().max()
                          / b.float().abs().max().clamp_min(1e-30))
              for (name, a), (_, b) in zip(trace_a, trace_b) if name.count(".") == 0}
    served_gap = _rel_gaps(out_a, out_b)
    first_kind = None
    if first is not None:
        mod = engine.model.encoder.resnet.get_submodule(first[0])
        if isinstance(mod, resnet.Conv3x3) and mod.stride == (1, 1):
            raise AssertionError(f"image 0 parts between buckets first at B2 ({first[0]})")
        first_kind = (f"a stock {mod.kernel_size[0]}x{mod.kernel_size[1]} convolution, "
                      f"stride {mod.stride[0]}" if isinstance(mod, layers.Conv2d)
                      else type(mod).__name__)

    # the same with every stock convolution run one image at a time: the
    # trunk is then the same computation at both buckets, bit for bit
    stock = layers.Conv2d.forward

    def per_image(self, x):
        return torch.cat([stock(self, x[i:i + 1]) for i in range(len(x))])

    layers.Conv2d.forward = per_image
    try:
        alone = {b: _trunk_trace(engine, images[:b]) for b in (buckets[0], buckets[-1])}
    finally:
        layers.Conv2d.forward = stock
    (trace_a, out_a), (trace_b, out_b) = alone.values()
    trunk_equal = all(torch.equal(a, b) for (_, a), (_, b) in zip(trace_a, trace_b))
    alone_gap = _rel_gaps(out_a, out_b)
    del served, alone, trace_a, trace_b
    if not trunk_equal:
        raise AssertionError("with its stock convolutions one image at a time the trunk "
                             "still parts between buckets")

    # unheld: the same images through the plain B2 and B1 at each bucket,
    # and the f32 engine across buckets
    plain_gap = {}
    for b in buckets:
        got = engine.predict(images[:b])
        resnet.conv3x3_same = conv3x3.conv3x3_reference
        attention.fused_mha = fused_attention.mha_reference
        try:
            want = engine.predict(images[:b])
        finally:
            resnet.conv3x3_same = conv3x3.conv3x3_same
            attention.fused_mha = fused_attention.fused_mha
        plain_gap[b] = max(_rel_gaps(got, want).values())
    f32 = copy.deepcopy(cfg)
    f32.train.precision = "f32"
    del engine
    engine = InferenceEngine(f32, assets=assets, device=DEVICE, seed=0)
    f32_gap = _rel_gaps({k: v[0] for k, v in engine.predict(images[:1]).items()},
                        {k: v[0] for k, v in engine.predict(images).items()})
    del engine
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    fmt = lambda d: ", ".join(f"{k} {v:.2e}" for k, v in d.items())
    print(f"[buckets] Config() seed-0 engine, buckets {list(buckets)}: every B2 (bfloat16, "
          f"wgmma) and B1 (float32) call of a forward at batch {buckets[-1]} "
          f"({n_calls}) against its plain version on its own activations, max|Δ| "
          f"{worst['conv3x3']:.3e} / {worst['fused_mha']:.3e} (limits as phase 2), and on "
          f"its first {list(buckets[:-1])} images equal bit for bit to the whole batch's", flush=True)
    print(f"[buckets] image 0 served at bucket {buckets[0]} and at {buckets[-1]}, max|Δ| / "
          f"max|ref|: the trunk first parts at "
          + (f"{first[0]} ({first_kind}, {first[1]:.2e})" if first else "no module")
          + f"; the stages {fmt(stages)}; the outputs {fmt(served_gap)}", flush=True)
    print(f"[buckets] with the stock convolutions one image at a time: the trunk's every "
          f"module equal bit for bit at both buckets, the outputs (the f32 decoder's "
          f"cuBLAS left to part) {fmt(alone_gap)}", flush=True)
    print(f"[buckets] not held: at each bucket the kernels' forward against the plain B2 and "
          f"B1's on the same weights and images, the largest max|Δ| / max|ref| of an output "
          f"{fmt(plain_gap)}; the f32 engine (TF32 off), image 0 at bucket {buckets[0]} and "
          f"{buckets[-1]}: {fmt(f32_gap)}", flush=True)
    return dict(random_inputs=held, conv3x3=worst["conv3x3"], fused_mha=worst["fused_mha"],
                n_calls=n_calls, first_part=first,
                stages=stages, served=served_gap, stock_per_image=alone_gap,
                plain_vs_kernel=plain_gap, f32=f32_gap)


def aux_serve_phase(cfg, assets, state_dict: dict) -> dict:
    """Serving a model trained with the aux heads (see the module
    docstring, phase 14)."""
    import copy

    import numpy as np
    import torch

    from renderih_tpu_torch.serve import InferenceEngine

    rcfg = recipe_config(cfg)
    per_fwd = {"conv3x3": sum(n for _, _, n in conv_shapes(rcfg)),  # 13
               "fused_mha": sum(n for _, _, n in mha_shapes(rcfg, assets.left.verts_nums)),
               "sdf_grid": 0}
    images = np.random.default_rng(4).integers(0, 256, (AUX_SERVE_N, rcfg.model.img_size,
                                                        rcfg.model.img_size, 3), np.uint8)
    engine = InferenceEngine(rcfg, assets=assets, state_dict=state_dict, device=DEVICE)
    head_calls = []
    for name in ("hms_head", "dp_head"):
        getattr(engine.model, name).register_forward_hook(
            lambda *a, name=name: head_calls.append(name))
    forwards = [0]
    engine.model.register_forward_pre_hook(
        lambda *a: forwards.__setitem__(0, forwards[0] + 1))
    for counter in _counters():
        counter.reset()
    got = engine.predict(images)
    launches = _launches()
    want = {k: n * forwards[0] for k, n in per_fwd.items()}
    _check_run_launches("aux-on serving", launches, want)
    if head_calls:
        raise AssertionError(f"the serving forward ran the aux heads: {head_calls}")
    off = copy.deepcopy(rcfg)
    off.model.with_aux_heads = False
    plain = InferenceEngine(off, assets=assets, device=DEVICE, state_dict={
        k: v for k, v in state_dict.items() if not k.startswith(("hms_head.", "dp_head."))})
    want_out = plain.predict(images)
    errs = {k: float(np.abs(got[k] - ref).max() / max(np.abs(ref).max(), 1e-6))
            for k, ref in want_out.items()}
    print(f"[aux-serve] InferenceEngine on {RECIPE_YAML} with phase 11's trained weights, "
          f"{AUX_SERVE_N} images: {forwards[0]} forwards, launches {launches} (expected {want}), "
          f"no aux-head forward; against an engine without the heads on the same trunk and "
          f"decoder weights, max|Δ| / max|ref| per output: "
          + ", ".join(f"{k}={v:.2e}" for k, v in errs.items())
          + f" (limit {AUX_SERVE_RTOL:g})", flush=True)
    if max(errs.values()) > AUX_SERVE_RTOL:
        raise AssertionError("the aux-head engine's outputs differ from the engine without heads")
    del engine, plain
    torch.cuda.empty_cache()
    return dict(launches=launches, forwards=forwards[0], rel_err=errs)


def _http_post(url: str, body: bytes, ctype: str) -> tuple:
    """POST `body` to `url`: (response body, its content type, seconds)."""
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST", headers={"Content-Type": ctype})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        data, got_type = r.read(), r.headers.get("Content-Type")
    return data, got_type, time.perf_counter() - t0


def _http_wave(url: str, bodies: list, ctype: str) -> tuple:
    """All `bodies` POSTed at once, a thread each: (wall seconds, [(body,
    content type, seconds)] in order). Runs in a client process of its own,
    so that the load does not share the server's interpreter lock."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(bodies)) as pool:
        t0 = time.perf_counter()
        res = list(pool.map(lambda b: _http_post(url, b, ctype), bodies))
    return time.perf_counter() - t0, res


def http_phase(cfg, assets, gpu_line: str) -> dict:
    """The HTTP front end on the card (see the module docstring, phase 15)."""
    import io
    import json as json_mod
    import multiprocessing
    import threading
    import urllib.request
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    import torch

    from renderih_tpu_torch.serve import InferenceEngine
    from renderih_tpu_torch.serve_http import HandPoseHTTPServer

    size = cfg.model.img_size
    per_fwd = {"conv3x3": sum(n for _, _, n in conv_shapes(cfg)),
               "fused_mha": sum(n for _, _, n in mha_shapes(cfg, assets.left.verts_nums)),
               "sdf_grid": 0}
    engine = InferenceEngine(cfg, assets=assets, device=DEVICE, seed=0)
    engine.warmup()
    groups, lock = [], threading.Lock()  # the batches the engine ran, and their outputs
    predict = engine.predict

    def logged_predict(images):
        out = predict(images)
        with lock:
            groups.append((np.array(images), out))
        return out

    engine.predict = logged_predict
    forwards = [0]
    engine.model.register_forward_pre_hook(lambda *a: forwards.__setitem__(0, forwards[0] + 1))
    server = HandPoseHTTPServer(engine, host="127.0.0.1", port=0)
    server.start()
    url = f"http://127.0.0.1:{server.port}"
    rng = np.random.default_rng(5)
    singles = rng.integers(0, 256, (HTTP_REQUESTS, size, size, 3), np.uint8)
    batch = rng.integers(0, 256, (HTTP_BATCH, size, size, 3), np.uint8)

    def npy(a):
        buf = io.BytesIO()
        np.save(buf, a)
        return buf.getvalue()

    try:
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            health = json_mod.loads(r.read())
        if health != {"status": "ok", "buckets": list(engine.buckets),
                      "encoder": cfg.model.encoder}:
            raise AssertionError(f"/healthz: {health}")
        for counter in _counters():
            counter.reset()
        forwards[0] = 0
        waves = []
        bodies = [npy(img) for img in singles]
        with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as client:
            for _ in range(HTTP_WAVES):
                groups.clear()
                wall, res = client.submit(_http_wave, f"{url}/predict", bodies,
                                          "application/x-npy").result(timeout=900)
                waves.append((wall, res, list(groups)))
        served_groups = waves[-1][2]
        body, btype, batch_s = _http_post(f"{url}/predict", npy(batch), "application/x-npy")
        jbody, jtype, json_s = _http_post(
            f"{url}/predict", json_mod.dumps({"image": singles[0].tolist()}).encode(),
            "application/json")
        launches, n_fwd = _launches(), forwards[0]
    finally:
        server.close()
    engine.predict = predict
    want = {k: n * n_fwd for k, n in per_fwd.items()}
    _check_run_launches("HTTP serving", launches, want)
    if btype != "application/x-npz" or jtype != "application/json":
        raise AssertionError(f"content types {btype}, {jtype}")

    def gap(got: dict, ref: dict) -> float:
        worst = 0.0
        for k, want_v in ref.items():
            g = np.asarray(got[k], np.float32)
            if g.shape != want_v.shape:
                raise AssertionError(f"{k}: shape {g.shape}, expected {want_v.shape}")
            worst = max(worst, float(np.abs(g - want_v).max()
                                     / max(np.abs(want_v).max(), 1e-6)))
        return worst

    # each response against engine.predict of the same images, batched as
    # the server batched them (the images a batcher call coalesced, the
    # explicit batch, the JSON image alone)
    errs = {}
    index = {singles[i].tobytes(): i for i in range(HTTP_REQUESTS)}
    replies = {i: dict(np.load(io.BytesIO(data))) for i, (data, _, _) in enumerate(waves[-1][1])}
    worst_single, rows = 0.0, 0
    for images, _ in served_groups:
        ref = engine.predict(images)
        for j, img in enumerate(images):
            worst_single = max(worst_single, gap(replies[index[img.tobytes()]],
                                                 {k: v[j] for k, v in ref.items()}))
            rows += 1
    if rows != HTTP_REQUESTS:
        raise AssertionError(f"the batcher's calls hold {rows} images, not {HTTP_REQUESTS}")
    errs["single"] = worst_single
    errs["batch"] = gap(dict(np.load(io.BytesIO(body))), engine.predict(batch))
    errs["json"] = gap({k: np.asarray(v) for k, v in json_mod.loads(jbody).items()},
                       {k: v[0] for k, v in engine.predict(singles[:1]).items()})
    # unheld: each single response against one predict of all of them (another bucket)
    whole = engine.predict(singles)
    across = max(gap(replies[i], {k: v[i] for k, v in whole.items()})
                 for i in range(HTTP_REQUESTS))
    wall, res, _ = waves[-1]
    lat = np.array([r[2] for r in res]) * 1e3
    rps = HTTP_REQUESTS / wall
    sizes = sorted(len(images) for images, _ in served_groups)
    print(f"[http] serve_http on 127.0.0.1:{server.port}, Config() seed-0 weights: /healthz "
          f"{health}; {HTTP_WAVES} waves of {HTTP_REQUESTS} concurrent single-image npy "
          f"requests from a client process (the last: {rps:.1f} requests/s, latency p50 "
          f"{np.percentile(lat, 50):.1f} ms, p99 {np.percentile(lat, 99):.1f} ms, batcher "
          f"calls of {sizes} images; earlier waves "
          + ", ".join(f"{HTTP_REQUESTS / w[0]:.1f}" for w in waves[:-1])
          + f" requests/s), one npy batch of {HTTP_BATCH} ({1e3 * batch_s:.1f} ms), one JSON "
          f"request ({1e3 * json_s:.1f} ms); launches {launches} (expected {want}), every B2 "
          f"on wgmma; responses vs engine.predict of the same images as batched, max|Δ| / "
          f"max|ref|: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" (limit {PATH_RTOL:g}); singles vs one predict of all {HTTP_REQUESTS} (not "
          f"held: another bucket, another cuDNN plan for the stock convolutions, phase 14) "
          f"{across:.2e}; on "
          f"{gpu_line}", flush=True)
    if max(errs.values()) > PATH_RTOL:
        raise AssertionError("an HTTP response differs from engine.predict")
    del engine
    torch.cuda.empty_cache()
    return dict(requests_per_s=rps, latency_ms_p50=float(np.percentile(lat, 50)),
                latency_ms_p99=float(np.percentile(lat, 99)),
                waves=[dict(seconds=w[0], batcher_calls=sorted(len(g[0]) for g in w[2]))
                       for w in waves],
                batch_ms=1e3 * batch_s, json_ms=1e3 * json_s, launches=launches,
                rel_err=errs, across_buckets_rel=across)


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
    evaluation = eval_phase(cfg, assets, gpu_line, profile)
    recipe_batch = recipe_config(cfg).train.batch_size
    recipe_bwd = conv_backward_phase(cfg, batch=recipe_batch, dtypes=("bfloat16",), seed=11)
    recipe_held = hold_path_kernels(cfg, verts_nums, recipe_batch, seed=12)
    print(f"[recipe] the path's kernels at batch {recipe_batch} against their plain versions: "
          f"B2 bfloat16 (wgmma) forward and dx above, forward again max|Δ| "
          f"{recipe_held['conv3x3']:.3e}; B1 float32 (the in-training eval) max|Δ| "
          f"{recipe_held['fused_mha']:.3e}", flush=True)
    recipe, recipe_state = recipe_train_phase(cfg, assets, gpu_line, profile)
    mano = mano_train_phase(cfg, assets, gpu_line)
    recipe_parity = recipe_parity_phase(cfg, assets)
    buckets = bucket_phase(cfg, assets)
    aux_serve = aux_serve_phase(cfg, assets, recipe_state)
    http = http_phase(cfg, assets, gpu_line)
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
        dict(name="conv3x3_same", path="recipe_train", route="cuda",
             source=f"{src}/csrc/conv3x3.cu", replaces="renderih_tpu/kernels/conv_pallas.py:160",
             **_train_summary(recipe_bwd, recipe["launches"]["conv3x3"])),
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
                       "eval_path": evaluation, "recipe_conv_backward": recipe_bwd,
                       "recipe_held": recipe_held, "recipe_path": recipe, "mano_path": mano,
                       "recipe_parity": recipe_parity, "buckets": buckets,
                       "aux_serve": aux_serve,
                       "http_path": http, "kernels": kernels}, f, indent=1,
                      default=float)
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
                             "predict at the largest bucket, one refined sample, "
                             "one training step, one eval batch and one recipe step "
                             "with and without the aux heads (torch.profiler)")
    args = parser.parse_args()
    try:
        return run(args.json, args.profile)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
