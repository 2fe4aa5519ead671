"""Full-split evaluation (counterpart of `renderih_tpu/eval/evaluator.py`;
reference `apps/eval_interhand.py`).

Feeds a packed split through the model in eval mode, gathers the
per-sample metric vectors (`eval/metrics.py`) on the host and prints the
reference's summary: ori/scaled MPJPE/MPVPE, PA metrics, MRRPE, CDev,
the double metrics, optionally bucketed by an inter-hand mask-IoU vector
(`iou_0_27w.npy`-style, `apps/eval_interhand.py:230-235`).

Runs on the card (`device=None` means `cuda`) and raises where there is
none; `device="cpu"` runs the plain versions on the CPU. With a mesh
(`parallel/mesh.py`; JAX's `mesh=`, `renderih_tpu/eval/evaluator.py:86-95`)
the model is replicated on each of its devices and every batch is split
over them, one contiguous slice a device, and gathered back in order.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from renderih_tpu_torch.assets import Assets
from renderih_tpu_torch.config import Config
from renderih_tpu_torch.data.interhand import IMG_SIZE, PackedInterHand
from renderih_tpu_torch.eval.metrics import two_hand_metrics
from renderih_tpu_torch.models.model import model_call_kwargs
from renderih_tpu_torch.ops.image import normalize_imagenet
from renderih_tpu_torch.parallel.mesh import Mesh, split_batch
from renderih_tpu_torch.serve import replicate, resolve_device

METRIC_KEYS = (
    "ori_mpjpe", "ori_mpvpe", "mpjpe", "mpvpe", "pa_mpjpe", "pa_mpvpe",
)
DOUBLE_KEYS = (
    "double_mpjpe", "double_mpvpe", "double_pa_mpjpe", "double_pa_mpvpe",
)
# metric conventions: (root_idx, length_joints), see two_hand_metrics
CONVENTIONS = {
    "default": (0, (0, 1)),   # apps/eval_interhand.py:323-351
    "newmpjpe": (9, (0, 9)),  # apps/eval_interhand_newmpjpe.py:323-351
}
_CACHED_KEYS = ("img_u8", "v3d_left", "v3d_right")


@contextlib.contextmanager
def eval_mode(model: torch.nn.Module):
    """The model in eval mode, under no_grad; its mode restored after."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            yield model
    finally:
        model.train(was_training)


def make_eval_fn(model: torch.nn.Module, assets: Assets, device: torch.device,
                 convention: str = "default"):
    """`fn(img_u8, v3d_left, v3d_right) -> {name: (B,) metric vector}` on
    `device`: ImageNet normalisation on the device, the forward (the
    caller sets eval mode), `two_hand_metrics` against the labels."""
    call_kwargs = model_call_kwargs(assets, device)
    j_reg = {hand: getattr(assets, hand).j_reg_21.to(device) for hand in ("left", "right")}
    root_idx, length_joints = CONVENTIONS[convention]

    def fn(img_u8, v3d_left, v3d_right):
        # eval preprocessing: normalise only (`apps/eval_interhand.py:205-210`)
        out = model(normalize_imagenet(img_u8.float() / 255.0), **call_kwargs)
        return two_hand_metrics(out.verts3d, {"left": v3d_left, "right": v3d_right},
                                j_reg, root_idx=root_idx, length_joints=length_joints)

    return fn


def evaluate_vectors(
    cfg: Config,
    model: torch.nn.Module,
    assets: Assets,
    dataset: PackedInterHand,
    batch_size: int = 512,
    convention: str = "default",
    device_cache: bool | None = None,
    device_cache_limit_mb: int = 2048,
    device: torch.device | str | None = None,
    mesh: Mesh | None = None,
) -> tuple:
    """Per-sample metric vectors of `dataset` and the run's timing:
    ({name: (N,) numpy}, {"images_per_sec", "num_samples", "device_cache",
    "cache_upload_s"}). See `evaluate_packed`."""
    if cfg.model.img_size != IMG_SIZE:
        raise ValueError(f"the packed split holds {IMG_SIZE}² images and eval feeds them "
                         f"unresized: model.img_size is {cfg.model.img_size}")
    device = resolve_device(device)
    on = next(model.parameters()).device
    if on.type != device.type or device.index not in (None, on.index):
        raise ValueError(f"the model is on {on}, the eval on {device}")
    n = len(dataset)
    batch_size = min(batch_size, n)
    if mesh is None:
        mesh = Mesh((device,))  # one device: one replica, the batch whole
    elif not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh (make_mesh), got {mesh!r}")
    batch_size -= batch_size % mesh.n_data  # divisible global batch, as JAX's
    if batch_size <= 0:
        raise ValueError(f"batch_size < the data axis' {mesh.n_data} devices")
    starts = list(range(0, n, batch_size))
    if device_cache is None:
        device_cache = dataset.nbytes / 1e6 <= device_cache_limit_mb
    replicas = replicate(model, mesh.devices)
    fns = [make_eval_fn(r, assets, d, convention) for r, d in zip(replicas, mesh.devices)]

    def upload(host: dict) -> list:
        """A host batch split over the mesh, each device's slice on that
        device: [(img_u8, v3d_left, v3d_right)] by device."""
        return list(zip(*(split_batch(mesh, torch.from_numpy(host[k])) for k in _CACHED_KEYS)))

    def host_batch(start: int) -> dict:
        # fixed-size batches: the tail is padded with its last sample, so
        # every batch has one shape
        idx = np.minimum(np.arange(start, start + batch_size), n - 1)
        return dataset.batch(idx)

    def run(per_device: list) -> dict:
        # every device's forward is queued before any result is read
        ms = [fn(*args) for fn, args in zip(fns, per_device)]
        keys = list(ms[0])
        host = np.concatenate([torch.stack([m[k] for k in keys]).cpu().numpy() for m in ms],
                              axis=1)  # the device syncs
        return dict(zip(keys, host))

    acc: dict = {}
    total_time = upload_s = 0.0
    with contextlib.ExitStack() as stack:
        for r in replicas:
            stack.enter_context(eval_mode(r))
        if device_cache:
            # the whole split, padded to whole batches, uploaded once,
            # batch by batch
            t0 = time.perf_counter()
            split = dataset.batch(np.minimum(np.arange(len(starts) * batch_size), n - 1))
            cache = [upload({k: v[s0:s0 + batch_size] for k, v in split.items()})
                     for s0 in starts]
            for d in mesh.devices:
                if d.type == "cuda":
                    torch.cuda.synchronize(d)
            upload_s = time.perf_counter() - t0
        else:
            nxt = host_batch(starts[0])
        for j, s0 in enumerate(starts):
            t0 = time.perf_counter()
            if device_cache:
                m = run(cache[j])
            else:
                # dispatch batch j, gather batch j+1 on the host meanwhile
                m = run(upload(nxt))
                if j + 1 < len(starts):
                    nxt = host_batch(starts[j + 1])
            if s0 > 0:  # the first batch (allocator, cuDNN plans) is not timed
                total_time += time.perf_counter() - t0
            valid = min(batch_size, n - s0)
            for k, v in m.items():
                acc.setdefault(k, []).append(v[:valid])
    timed_images = max(n - batch_size, 0)
    stats = {"images_per_sec": timed_images / total_time if total_time > 0 else 0.0,
             "num_samples": n, "device_cache": bool(device_cache),
             "cache_upload_s": round(upload_s, 3)}
    return {k: np.concatenate(v) for k, v in acc.items()}, stats


def evaluate_packed(
    cfg: Config,
    model: torch.nn.Module,
    assets: Assets,
    dataset: PackedInterHand,
    batch_size: int = 512,
    iou: np.ndarray | None = None,
    convention: str = "default",
    device_cache: bool | None = None,
    device_cache_limit_mb: int = 2048,
    device: torch.device | str | None = None,
    mesh: Mesh | None = None,
) -> dict:
    """Evaluate `dataset` with `model` (on `device`); returns the summary
    of `summarize` with `images_per_sec`, `num_samples`, `device_cache`
    and `cache_upload_s`.

    `convention` picks the root/length definition ('default' =
    eval_interhand, 'newmpjpe' = eval_interhand_newmpjpe). `device_cache`
    (by default on when the split fits `device_cache_limit_mb`): upload the
    split once and slice each batch on the device; otherwise each batch is
    gathered on the host while the previous one runs. Batches have one
    size, the tail padded with its last sample. images/s leaves out the
    first batch and counts each batch to its metrics on the host. The
    model's train/eval mode is left as it was.

    `mesh` (`parallel.mesh.make_mesh`; `model` on its first device):
    `batch_size` is cut to a multiple of the data axis, the model is
    replicated on every device, each batch runs split over them and the
    metric vectors are gathered in order; the device cache holds each
    device's slices on that device.
    """
    vectors, stats = evaluate_vectors(cfg, model, assets, dataset, batch_size, convention,
                                      device_cache, device_cache_limit_mb, device, mesh)
    return {**summarize(vectors, iou), **stats}


def _nanmean(x):
    return float(np.nanmean(x)) if len(x) and not np.isnan(x).all() else float("nan")


def summarize(vectors: dict, iou: np.ndarray | None = None) -> dict:
    """Aggregate per-sample vectors into the reference's printed metrics (mm)."""
    out = {}
    for key in METRIC_KEYS:
        left = vectors[f"{key}_left"]
        right = vectors[f"{key}_right"]
        out[f"{key}_left_mm"] = 1000.0 * left.mean()
        out[f"{key}_right_mm"] = 1000.0 * right.mean()
        out[f"{key}_mm"] = 500.0 * (left.mean() + right.mean())
    out["mrrpe_mm"] = 1000.0 * vectors["mrrpe"].mean()
    out["cdev_mm"] = 1000.0 * _nanmean(vectors["cdev"])
    for key in DOUBLE_KEYS:
        if key in vectors:
            out[f"{key}_mm"] = 1000.0 * vectors[key].mean()

    if iou is not None:
        n = min(len(iou), len(vectors["mrrpe"]))
        buckets = {
            "iou033": iou[:n] < 0.33,
            "iou067": (iou[:n] >= 0.33) & (iou[:n] < 0.67),
            "iou1": iou[:n] >= 0.67,
        }
        for bname, mask in buckets.items():
            if mask.sum() == 0:
                continue
            for key in ("ori_mpjpe", "mpjpe", "pa_mpjpe"):
                left = vectors[f"{key}_left"][:n][mask]
                right = vectors[f"{key}_right"][:n][mask]
                out[f"{key}_{bname}_mm"] = 500.0 * (left.mean() + right.mean())
            out[f"mrrpe_{bname}_mm"] = 1000.0 * vectors["mrrpe"][:n][mask].mean()
            out[f"cdev_{bname}_mm"] = 1000.0 * _nanmean(vectors["cdev"][:n][mask])
    return out


def print_summary(summary: dict) -> None:
    print("ori joint mpjpe:")
    print(f"    left: {summary['ori_mpjpe_left_mm']:.3f} mm, "
          f"right: {summary['ori_mpjpe_right_mm']:.3f} mm")
    print(f"    all: {summary['ori_mpjpe_mm']:.3f} mm")
    print("ori vert mean error:")
    print(f"    all: {summary['ori_mpvpe_mm']:.3f} mm")
    print("joint mean error (length-normalized):")
    print(f"    all: {summary['mpjpe_mm']:.3f} mm")
    print("vert mean error (length-normalized):")
    print(f"    all: {summary['mpvpe_mm']:.3f} mm")
    print("joint pa mean error:")
    print(f"    all_pa: {summary['pa_mpjpe_mm']:.3f} mm")
    print("vert pa mean error:")
    print(f"    all_pa: {summary['pa_mpvpe_mm']:.3f} mm")
    print(f"mrrpe: {summary['mrrpe_mm']:.3f} mm")
    print(f"cdev: {summary['cdev_mm']:.3f} mm")
    if "double_mpjpe_mm" in summary:
        print(f"double MPJPE: {summary['double_mpjpe_mm']:.3f} mm")
        print(f"double MPVPE: {summary['double_mpvpe_mm']:.3f} mm")
        print(f"double PAMPJPE: {summary['double_pa_mpjpe_mm']:.3f} mm")
        print(f"double PAMPVPE: {summary['double_pa_mpvpe_mm']:.3f} mm")
    print(f"throughput: {summary['images_per_sec']:.1f} images/sec "
          f"({summary['num_samples']} samples)")
