"""The port's mask-IoU tool (`renderih_tpu_torch/tools/compute_maskiou.py`)
against the JAX tool (`tools/compute_maskiou.py`) on one packed split in
each camera mode, and its vector read by the port's `eval_interhand --iou`.

Tolerance: each sample's IoU within 2/res² of JAX's (a pixel whose centre
lies on a shared edge may fall to either face under other rounding; the
number of samples that differ at all is printed)."""

import importlib.util
import os
import shutil

import numpy as np
import pytest
import torch

from renderih_tpu_torch.apps import eval_interhand
from renderih_tpu_torch.config import dump_config, load_config
from renderih_tpu_torch.data.interhand import LABEL_KEYS, _label_shape
from renderih_tpu_torch.mano.layer import mano_forward
from renderih_tpu_torch.mano.params import make_synthetic_mano
from renderih_tpu_torch.ops.projection import orthographic_project
from renderih_tpu_torch.ops.rotation import rodrigues
from renderih_tpu_torch.tools import compute_maskiou

_TOOL = os.path.join(os.path.dirname(__file__), "..", "tools", "compute_maskiou.py")
N, RES, BS = 20, 64, 8


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_compute_maskiou", _TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    """Two packed splits of N frames: `persp` with camera-space vertices
    at ~0.5 m and per-frame intrinsics `camera_in`, `orth` without them
    (v2d from orthographic cameras). The right hand is moved towards the
    left by a random amount, so the IoUs spread from 0 to near 1."""
    root = tmp_path_factory.mktemp("packed")
    rng = np.random.default_rng(0)
    verts = {}
    for side, dx in (("left", -0.05), ("right", 0.05)):
        root_aa = torch.from_numpy(rng.normal(0, 0.5, (N, 3)).astype(np.float32))
        pose = torch.from_numpy(rng.normal(0, 0.3, (N, 45)).astype(np.float32))
        v, _ = mano_forward(make_synthetic_mano(0, side == "right"), rodrigues(root_aa), pose,
                            torch.zeros(N, 10), center_idx=None, use_pca=False)
        verts[side] = v.numpy() + np.array([dx, 0.0, 0.0], np.float32)
    pull = rng.uniform(0.0, 0.12, (N, 1, 1)).astype(np.float32)
    verts["right"] = verts["right"] - pull * np.array([1.0, 0.0, 0.0], np.float32)
    for split in ("persp", "orth"):
        labels = {k: np.zeros((N,) + _label_shape(k), np.float32) for k in LABEL_KEYS}
        if split == "persp":
            f = rng.uniform(300.0, 500.0, N).astype(np.float32)
            K = np.zeros((N, 3, 3), np.float32)
            K[:, 0, 0], K[:, 1, 1], K[:, 2, 2] = f, f * 1.05, 1.0
            K[:, :2, 2] = 128.0 + rng.uniform(-10, 10, (N, 2))
            labels["camera_in"] = K
            for side in ("left", "right"):
                labels[f"v3d_{side}"] = verts[side] + np.array([0.0, 0.0, 0.5], np.float32)
        else:
            scale = torch.from_numpy(rng.uniform(2.0, 3.0, N).astype(np.float32))
            trans = torch.from_numpy(rng.uniform(-0.2, 0.2, (N, 2)).astype(np.float32))
            for side in ("left", "right"):
                labels[f"v3d_{side}"] = verts[side]
                labels[f"v2d_{side}"] = orthographic_project(
                    scale, trans, torch.from_numpy(verts[side]), 256).numpy()
        np.savez(root / f"{split}_labels.npz", **labels)
        np.zeros((N, 256, 256, 3), np.uint8).tofile(root / f"{split}_images.u8")
    return root


@pytest.mark.parametrize("split", ["persp", "orth"])
def test_iou_vector_matches_jax_tool(packed, tmp_path, split):
    argv = ["--data", str(packed), "--split", split, "--res", str(RES), "--bs", str(BS)]
    got = compute_maskiou.main(argv + ["--out", str(tmp_path / "port.npy"), "--device", "cpu"])
    _jax_tool().main(argv + ["--out", str(tmp_path / "jax.npy")])
    want = np.load(tmp_path / "jax.npy")
    assert np.array_equal(np.load(tmp_path / "port.npy"), got)
    assert got.shape == want.shape == (N,) and got.dtype == np.float32
    differ = got != want
    print(f"mask IoU ({split}): {differ.sum()} of {N} samples differ from JAX's, max |Δ| "
          f"{np.abs(got - want).max():.3e} (limit {2 / RES ** 2:.3e})")
    assert np.abs(got - want).max() <= 2 / RES ** 2
    assert want.min() < 0.1 and want.max() > 0.3 and 0.0 <= got.min() and got.max() <= 1.0


def test_eval_interhand_reads_the_ports_vector(packed, tmp_path):
    """`eval_interhand --iou` on the port's vector: the interaction buckets
    are summarised over exactly the samples the vector puts in them."""
    iou_path = tmp_path / "iou.npy"
    iou = compute_maskiou.main(["--data", str(packed), "--split", "persp", "--out",
                                str(iou_path), "--res", str(RES), "--device", "cpu"])
    cfg = load_config(overrides={"model": {"encoder": "resnet18", "grid_size": 4},
                                 "train": {"precision": "f32"}})
    dump_config(cfg, str(tmp_path / "cfg.yaml"))
    data = tmp_path / "data"
    shutil.copytree(packed, data)
    prev = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        with_iou = eval_interhand.main(["--cfg", str(tmp_path / "cfg.yaml"), "--data", str(data),
                                        "--split", "persp", "--bs", "10", "--device", "cpu",
                                        "--iou", str(iou_path), "--json"])
    finally:
        torch.set_num_threads(prev)
    buckets = {k: v for k, v in with_iou.items() if "iou" in k}
    assert buckets, with_iou
    counts = {"iou033": (iou < 0.33).sum(), "iou067": ((iou >= 0.33) & (iou < 0.67)).sum(),
              "iou1": (iou >= 0.67).sum()}
    for name, count in counts.items():
        keys = [k for k in buckets if name in k]
        if count:
            assert keys and all(np.isfinite(buckets[k]) for k in keys), (name, buckets)
