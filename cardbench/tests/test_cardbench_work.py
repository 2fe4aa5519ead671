"""The work counters against figures worked by hand, and the peaks' arithmetic."""

from __future__ import annotations

import pytest

from cardbench.harness import peaks
from cardbench.harness.cell import ROOT, load_json
from cardbench.harness.work import forward_work

FLAGSHIP = load_json(ROOT / "cardbench" / "configs" / "resnet50_graph.json")


def test_b2_first_site_by_hand():
    # layer1.0.conv2: x (2, 64, 64, 64) bf16, w (3, 3, 64, 64), y (2, 64, 64, 64)
    w = forward_work(FLAGSHIP, 2)
    first = w.b2[0]
    assert first.shape == (2, 64, 64, 64) and first.dtype == "bfloat16"
    assert first.flops == 2 * 2 * 64 * 64 * 9 * 64 * 64 == 603_979_776
    assert first.n_bytes == (2 * 64 * 64 * 64 + 9 * 64 * 64 + 2 * 64 * 64 * 64) * 2 == 2_170_880
    # bound by bytes: 2,170,880 B / 3.35 TB/s = 648.0 ns > 603,979,776 / 989e12 = 610.7 ns
    assert peaks.bound_s(first.n_bytes, first.flops, first.dtype) == pytest.approx(648.024e-9, rel=1e-5)


def test_b1_first_site_by_hand():
    # stage 0, img_ex_left's grid self-attention: 64 tokens, 4 heads of 64, f32
    w = forward_work(FLAGSHIP, 2)
    first = w.b1[0]
    assert first.shape == (2, 64, 64, 4, 64) and first.dtype == "float32"
    assert first.flops == 4 * 2 * 4 * 64 * 64 * 64 == 8_388_608
    assert first.exps == 2 * 4 * 64 * 64 == 32_768
    assert first.n_bytes == (3 * 2 * 64 * 256 + 2 * 64 * 256) * 4 == 524_288
    # f32 held to the TF32 peak: 8,388,608 / 495e12 = 16.95 ns; bytes 156.5 ns lead
    assert peaks.bound_s(first.n_bytes, first.flops, "float32", first.exps) == pytest.approx(
        524_288 / 3.35e12)


def test_site_counts_and_forward_flops():
    w = forward_work(FLAGSHIP, 4)
    assert (len(w.b2), len(w.b1)) == (13, 24)
    # ResNet-50 trunk ~10.7 GFLOP at 256² (4.09 GMAC at 224², scaled) + the mid's three
    # 1x1 projections (0.47 GFLOP): 11.0-11.3 GFLOP an image in bf16
    assert 11.0e9 < w.flops["bfloat16"] / 4 < 11.3e9
    hrnet = forward_work(load_json(ROOT / "cardbench" / "configs" / "hrnet_w32_graph.json"), 4)
    assert (len(hrnet.b2), len(hrnet.b1)) == (216, 24)
    assert w.flops["float32"] == hrnet.flops["float32"]  # the same decoder


def test_work_scales_with_batch():
    one, four = forward_work(FLAGSHIP, 1), forward_work(FLAGSHIP, 4)
    for dtype, flops in one.flops.items():
        assert four.flops[dtype] == pytest.approx(4 * flops)
