#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`renderih_tpu_torch/`) on one NVIDIA H100.

    python3 chip_smoke.py [--json PATH] [--profile]

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit (`nvcc`). Four phases; any failure exits non-zero and prints no
result line:

1. Build: compiles the port's CUDA kernels from `renderih_tpu_torch/csrc/`
   with nvcc for sm_90a (one nvcc per source, in parallel) and prints
   `-Xptxas -v` (registers, shared memory, spills), then the card's name
   and power limit.
2. Kernels against their plain versions on the card, at every shape the
   flagship path gives them at batch 256: B2 (3x3 conv) in bf16 and f32,
   B1 (fused attention) in f32. Each line has max|Δ| and its tolerance,
   the kernel's time (CUDA events after warm-up), the plain version's,
   one library call's (cuDNN `F.conv2d`, `F.scaled_dot_product_attention`;
   a yardstick the port never calls) and the bound: the larger of the
   bytes moved (inputs read once, output written once) over 3.35 TB/s
   and the FLOPs over the peak for the input type (989 TFLOP/s bf16,
   67 TFLOP/s f32; H100 SXM data sheet).
3. The main path: the flagship `Config()` (ResNet-50, bf16 encoder, f32
   decoder) on synthetic assets with seeded random weights, served
   through `InferenceEngine` + `BatchingServer` (64 single-image
   requests) and one `predict` of 256 images. The launch counters must
   rise by exactly 13 (B2) and 24 (B1) per forward. Then, in f32 with
   TF32 off, the card's outputs are held against the same engine run on
   the CPU (the plain versions) on the same weights and images.
4. The result: a `{"kernels": [...]}` line (per-forward totals at batch
   256, the flagship's dtypes), and as the last line
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
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
BATCH = 256
N_REQUESTS = 64
CONV_TOL = {"bfloat16": (1e-2, 1.6e-2), "float32": (1e-4, 1e-4)}  # atol, rtol
MHA_TOL = (1e-4, 1e-4)
PATH_RTOL = 1e-4  # card vs CPU, relative to each output's max |value|


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


def _bound(n_bytes: int, flops: int, dtype_name: str) -> dict:
    """The least time for this work: bytes over the HBM rate or FLOPs over
    the peak for the type, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return dict(bytes_ms=t_bytes, ops_ms=t_ops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


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
            y = conv3x3.conv3x3_same(x, w)
            torch.cuda.synchronize()
            err = _check(f"conv3x3 {dname} {side}²x{c}", y,
                         conv3x3.conv3x3_reference(x, w), atol, rtol)
            x_lib = x.permute(0, 3, 1, 2)  # NCHW view, channels_last
            w_lib = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            n_bytes = (x.numel() + w.numel() + y.numel()) * x.element_size()
            flops = 2 * BATCH * side * side * c * c * 9
            row = dict(
                dtype=dname, shape=[BATCH, side, side, c, c], launches_per_forward=per_fwd,
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
                  f"({row['bound_by']})  launches/forward={per_fwd}", flush=True)
            del x, w, y, x_lib, w_lib

    atol, rtol = MHA_TOL
    for n, d, per_fwd in mha_shapes(cfg, verts_nums):
        q, k, v = (torch.randn(BATCH, n, cfg.model.num_attn_heads, d, device=dev,
                               generator=g) for _ in range(3))
        out = fused_attention.fused_mha(q, k, v)
        torch.cuda.synchronize()
        err = _check(f"fused_mha N={n} D={d}", out,
                     fused_attention.mha_reference(q, k, v), atol, rtol)
        ql, kl, vl = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        n_bytes = (q.numel() + k.numel() + v.numel() + out.numel()) * 4
        flops = 4 * BATCH * cfg.model.num_attn_heads * n * n * d
        row = dict(
            dtype="float32", shape=[BATCH, n, cfg.model.num_attn_heads, d],
            launches_per_forward=per_fwd, max_abs_err=err, atol=atol, rtol=rtol,
            ms=_time_ms(lambda: fused_attention.fused_mha(q, k, v)),
            plain_ms=_time_ms(lambda: fused_attention.mha_reference(q, k, v)),
            library_ms=_time_ms(lambda: F.scaled_dot_product_attention(ql, kl, vl)),
            **_bound(n_bytes, flops, "float32"))
        rows["fused_mha"].append(row)
        print(f"[B1] fused_mha f32 q=k=v({BATCH},{n},{cfg.model.num_attn_heads},{d}): "
              f"max|Δ|={err:.3e} (atol {atol:g}, rtol {rtol:g})  "
              f"kernel_ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
              f"library_ms={row['library_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
              f"({row['bound_by']})  launches/forward={per_fwd}", flush=True)
    return rows


def main_path_phase(cfg, assets, gpu_line: str, profile: bool = False) -> dict:
    import numpy as np
    import torch

    from renderih_tpu_torch.kernels import conv3x3, fused_attention
    from renderih_tpu_torch.serve import BatchingServer, InferenceEngine

    size = cfg.model.img_size
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (BATCH, size, size, 3), dtype=np.uint8)

    engine = InferenceEngine(cfg, assets=assets, device="cuda", seed=0)
    engine.warmup()
    forwards = [0]
    hook = engine.model.register_forward_pre_hook(
        lambda mod, args: forwards.__setitem__(0, forwards[0] + 1))

    conv3x3.launches.reset()
    fused_attention.launches.reset()
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
                "fused_mha": fused_attention.launches.value}
    hook.remove()

    n_fwd = forwards[0]
    per_fwd = {"conv3x3": sum(n for _, _, n in conv_shapes(cfg)),  # 13
               "fused_mha": sum(n for _, _, n in mha_shapes(  # 24
                   cfg, assets.left.verts_nums))}
    want = {k: n * n_fwd for k, n in per_fwd.items()}
    print(f"[path] {N_REQUESTS} requests in {n_served_batches} served batches + "
          f"predict({BATCH}): {n_fwd} forwards, launches {launches} "
          f"(expected {want})", flush=True)
    if n_fwd == 0 or launches != want:
        raise AssertionError(f"kernel launches {launches} != {want}")
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
    result = {"launches": launches, "forwards": n_fwd, "images_per_s": rate,
              "images_per_s_runs": rates}
    if profile:
        result["profile"] = profile_phase(engine, images[:engine.buckets[-1]])
    del engine
    torch.cuda.empty_cache()
    return result


def profile_phase(engine, images) -> dict:
    """Device time by kernel over one flagship predict (torch.profiler):
    only device-side events count (kernels, memcpy, memset), and the busy
    time is the union of their intervals."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine.predict(images)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.predict(images)
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
    print(f"[profile] predict({len(images)}) under the profiler: wall {wall_ms:.2f} ms, "
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


def _summary(rows: list, launches: int) -> dict:
    """One kernel's totals over the launches of one forward at batch 256."""
    def total(key):
        return sum(r[key] * r["launches_per_forward"] for r in rows)

    t_bytes, t_ops = total("bytes_ms"), total("ops_ms")
    return dict(launches=launches, max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=total("ms"), plain_ms=total("plain_ms"),
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=total("library_ms"))


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
    logs = _build.build(["conv3x3", "fused_attention"], verbose=True)
    for name, log in logs.items():
        print(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)} {name}.cu:\n{log.strip()}")
    print(f"[build] {sorted(logs)} built in {time.perf_counter() - t0:.1f} s into "
          f"{_build.BUILD_DIR}", flush=True)
    gpu_line = _gpu_line()
    print(f"[card] {gpu_line}", flush=True)

    cfg = Config()
    assets = make_synthetic_assets(0)
    verts_nums = assets.left.verts_nums
    rows = kernel_phase(cfg, verts_nums)
    path = main_path_phase(cfg, assets, gpu_line, profile)
    errs = parity_phase(cfg, assets)

    src = "renderih_tpu_torch"
    kernels = [
        dict(name="conv3x3_same", route="cuda", source=f"{src}/csrc/conv3x3.cu",
             replaces="renderih_tpu/kernels/conv_pallas.py:160",
             **_summary([r for r in rows["conv3x3"] if r["dtype"] == "bfloat16"],
                        path["launches"]["conv3x3"])),
        dict(name="fused_mha", route="cuda", source=f"{src}/csrc/fused_attention.cu",
             replaces="renderih_tpu/kernels/fused_attention.py:43",
             **_summary(rows["fused_mha"], path["launches"]["fused_mha"])),
    ]
    if json_path:
        with open(json_path, "w") as f:
            json.dump({"card": gpu_line, "torch": torch.__version__, "rows": rows,
                       "main_path": path, "parity": errs, "kernels": kernels}, f,
                      indent=1)
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
                             "predict at the largest bucket (torch.profiler)")
    args = parser.parse_args()
    try:
        return run(args.json, args.profile)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
