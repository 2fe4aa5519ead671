"""The ViT-L configuration: it resolves to its reference, whose forward's work
matches figures worked by hand, and `vit_b1_roofline.offline` reads the trunk's
bfloat16 D = 64 attention alone on a slice written by hand."""

from __future__ import annotations

import importlib.util

import pytest

from cardbench.harness import peaks
from cardbench.harness.cell import ROOT, Cell, load_json, reference_of
from cardbench.harness.trace import SliceSummary
from cardbench.harness.work import forward_work

CELL = "vit_l_graph.offline256"
VIT_L = load_json(ROOT / "cardbench" / "configs" / "vit_l_graph.json")
# FLOPs an image: the trunk (patch-16 embedding + 24 blocks of qkv, proj, fc1,
# fc2 and the attention core over 256 tokens), the stride-8 embedding, conv1,
# and the pooled block (fc0, sr, q, kv, the core, linear1, linear2)
BLOCK = (2 * 256 * 1024 * (3 * 1024 + 1024 + 2 * 4096)) + 4 * 16 * 256 * 256 * 64
TRUNK = 2 * 16 * 16 * 1024 * 3 * 16 * 16 + 24 * BLOCK
EMBED8 = 2 * 32 * 32 * 1024 * 3 * 8 * 8
CONV1 = 2 * 32 * 32 * 1024 * 1024
POOLED = (2 * 64 * 1024 * (4096 + 1024 + 1024 + 2048 + 2048) + 2 * 256 * 2048 * 1024
          + 4 * 8 * 64 * 256 * 128)


def test_configuration_resolves():
    cell = Cell(CELL, 2 ** 31 + 12345, 1.0, False, device="cpu")
    assert cell.entry["config"] == "vit_l_graph" and cell.traffic["kind"] == "offline"
    assert cell.reference is reference_of(VIT_L)
    assert cell.reference.__name__ == "cardbench.reference.vit"
    meta = cell.reference.build(cell.config, "meta")
    keys = meta.state_dict()
    assert {k.split(".")[0] for k in keys} == {
        "encoder", "patch_embed", "conv1", "downsample", "decoder"}
    assert keys["encoder.blocks.23.mlp.fc1.weight"].shape == (4096, 1024)
    assert keys["downsample.fc0.weight"].shape == (1024, 4096)
    assert "encoder.blocks.24.norm1.weight" not in keys
    assert sum(v.numel() for k, v in keys.items() if k.startswith("encoder.")) > 300e6
    assert set(cell.config["limits"]) == {"verts3d", "trans2d", "decoder"}


def test_forward_flops_by_hand():
    assert TRUNK == 161_463_926_784
    assert (EMBED8, CONV1, POOLED) == (402_653_184, 2_147_483_648, 2_483_027_968)
    w = forward_work(VIT_L, 2)
    assert w.flops["bfloat16"] == 2 * (TRUNK + EMBED8 + CONV1 + POOLED) == 2 * 166_497_091_584
    flagship = forward_work(load_json(ROOT / "cardbench" / "configs" / "resnet50_graph.json"), 2)
    # the same decoder at 1024-wide maps: only its three patchify convolutions widen
    assert w.flops["float32"] > flagship.flops["float32"]


def test_sites_and_the_first_of_each_kind():
    w = forward_work(VIT_L, 2)
    assert w.b2 == []
    shapes = [l.shape for l in w.b1]
    assert shapes[:24] == [(2, 256, 256, 16, 64)] * 24
    assert shapes[24] == (2, 64, 256, 8, 128)
    assert len(shapes) == 49 and all(l.dtype == "float32" for l in w.b1[25:])
    trunk, pooled = w.b1[0], w.b1[24]
    assert trunk.dtype == pooled.dtype == "bfloat16"
    assert trunk.flops == 4 * 2 * 16 * 256 * 256 * 64 == 536_870_912
    assert trunk.exps == 2 * 16 * 256 * 256
    assert trunk.n_bytes == 4 * 2 * 256 * 1024 * 2 == 4_194_304
    # bound by bytes: 4,194,304 B / 3.35 TB/s = 1.2520 us > 536,870,912 / 989e12 = 0.5428 us
    assert peaks.bound_s(trunk.n_bytes, trunk.flops, "bfloat16", trunk.exps) == pytest.approx(
        4_194_304 / 3.35e12)
    assert pooled.flops == 4 * 2 * 8 * 64 * 256 * 128
    assert pooled.n_bytes == (2 * 64 * 1024 + 2 * 2 * 256 * 1024 + 2 * 64 * 1024) * 2


def _reader(name: str):
    path = ROOT / "cardbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("reader_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def test_vit_b1_roofline_reads_the_trunks_bf16_d64_instance():
    read = _reader("vit_b1_roofline.offline")
    cell = Cell(CELL, 7, 1.0, False, device="cpu")
    s = SliceSummary(wall_s=1.0, busy_s=0.5, events=4, by_name={
        "void mha_mma_kernel<__nv_bfloat16, 64>(__nv_bfloat16 const*, int)": [8e-3, 48],
        "void mha_mma_kernel<__nv_bfloat16, 128>(__nv_bfloat16 const*, int)": [1.0, 2],
        "void mha_mma_kernel<float, 64>(float const*, int)": [1.0, 48],
        "void mha_mma_kernel<float, 32>(float const*, int)": [1.0, 48]},
        forward_batches=[128, 128], images=256)
    # 2 forwards x 24 trunk sites of 128 images, each bound by its bytes
    want = 100 * 2 * 24 * (4 * 128 * 256 * 1024 * 2 / 3.35e12) / 8e-3
    assert read(cell, {"slice": s}) == pytest.approx(want)
    assert 0 < want < 100
    assert read(cell, {"slice": None}) is None
    s.by_name.pop("void mha_mma_kernel<__nv_bfloat16, 64>(__nv_bfloat16 const*, int)")
    assert read(cell, {"slice": s}) is None


def test_the_metric_lists_the_cell_and_the_reader_stays_silent_elsewhere():
    bench = load_json(ROOT / "BENCHMARK.json")
    metric = next(m for m in bench["per_layer"] if m["name"] == "vit_b1_roofline.offline")
    assert metric["workloads"] == [CELL] and metric["moves"] == "infer_images_per_s"
    flagship = Cell("resnet50_graph.offline256", 7, 1.0, False, device="cpu")
    s = SliceSummary(wall_s=1.0, busy_s=0.5, events=1,
                     by_name={"void mha_mma_kernel<float, 64>(float const*, int)": [1e-3, 24]},
                     forward_batches=[128], images=128)
    assert _reader("vit_b1_roofline.offline")(flagship, {"slice": s}) is None
