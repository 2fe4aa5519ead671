"""The port's ViT-L network against the benchmark's plain reference
(`cardbench/reference/vit.py`) on the CPU.

The configuration `vit_l_graph` at its widths (1024 wide, 16 heads, MLP x4,
the pooled block's 8 heads), 256² images, batch 2, in float32, the depth cut
to 2 blocks on both sides; the weights are the benchmark's seeded draw in the
upstream layout (`cardbench/reference/weights.py`), loaded into both as they
are. The four outputs agree to 1e-4 of their largest value, and each planted
fault of the reference breaks that: the pooled block's LayerNorm at eps 1e-6,
tanh-approximated GELU, no qkv bias, a bilinear in place of the nearest 2x
upsample. The pooled block's LayerNorm sees unit-scale inputs under the seeded
draw, where eps 1e-5 against 1e-6 moves its output by ~1e-6; the faults are
planted on a copy of the draw whose `fc0` and `sr` are scaled by 1e-2, so that
the eps shows, and the clean comparison holds on that copy too."""

import numpy as np
import pytest
import torch

from cardbench.harness.cell import OUTPUT_KEYS, ROOT, Cell, gap_stats, load_json
from cardbench.reference import vit as ref_vit
from renderih_tpu_torch.models import vit

CONFIG = load_json(ROOT / "cardbench" / "configs" / "vit_l_graph.json")
DEPTH = 2
TRAFFIC = dict(kind="offline", batch=2, buckets=[2], pool_images=2, warmup_requests=0,
               check_requests=1, trace_requests=1)
ROWS = np.arange(2)
TOL = 1e-4


def _small_pooled_inputs(state_dict: dict) -> dict:
    return {k: v * 1e-2 if k.startswith(("downsample.fc0.", "downsample.sr.")) else v
            for k, v in state_dict.items()}


@pytest.fixture(scope="module")
def runs():
    """{weights: (cell, the port's outputs, its state dict's shapes)} for the
    seeded draw ("seeded") and its copy with small pooled-block inputs
    ("small_pooled")."""
    config = dict(CONFIG, depth=DEPTH, precision={"encoder": "float32", "decoder": "float32"})
    cells = {name: Cell("vit_l_graph.offline256", 987654321987, 1.0, False, device="cpu",
                        config=config, traffic=TRAFFIC) for name in ("seeded", "small_pooled")}
    draw = cells["small_pooled"].state_dict
    cells["small_pooled"].state_dict = lambda: _small_pooled_inputs(draw())
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(vit._VIT_CONFIGS, "vit_large", dict(vit._VIT_CONFIGS["vit_large"], depth=DEPTH))
        engine = cells["seeded"].engine()
    out = {}
    for name, cell in cells.items():  # one engine, each draw loaded into it in turn
        engine.model.load_state_dict(cell.state_dict())
        out[name] = (cell, engine.predict(cell.pool()[ROWS]),
                     {k: tuple(v.shape) for k, v in engine.model.state_dict().items()})
    return out


def _gaps(cell, got) -> dict:
    return gap_stats(got, cell.reference_outputs(ROWS))["max_abs"]


def test_configuration_widths_are_the_ports():
    want = vit._VIT_CONFIGS[CONFIG["encoder"]]
    assert {k: CONFIG[k] for k in want} == want
    assert CONFIG["pool_heads"] == vit._POOL_HEADS
    block = vit.ViTBlock(64, 4)
    assert block.mlp.fc1.out_features == CONFIG["mlp_ratio"] * 64
    assert CONFIG["deconv_dims"] == [want["embed_dim"]] * 3


def test_state_dict_layout_is_the_programs(runs):
    cell, _, theirs = runs["seeded"]
    ours = {k: tuple(v.shape) for k, v in cell.state_dict().items()}
    assert ours == theirs
    assert {k.split(".")[0] for k in ours} == {
        "encoder", "patch_embed", "conv1", "downsample", "decoder"}


@pytest.mark.parametrize("weights", ["seeded", "small_pooled"])
def test_port_matches_reference_f32(runs, weights):
    cell, got, _ = runs[weights]
    gaps = _gaps(cell, got)
    assert set(gaps) == set(OUTPUT_KEYS)
    assert max(gaps.values()) <= TOL, gaps


def _drop_qkv_bias(mp):
    forward = ref_vit.Attention.forward

    def without_bias(self, x):
        with torch.no_grad():
            self.qkv.bias.zero_()
        return forward(self, x)

    mp.setattr(ref_vit.Attention, "forward", without_bias)


FAULTS = {
    "pooled_ln_eps_1e-6": lambda mp: mp.setattr(ref_vit, "POOL_LN_EPS", 1e-6),
    "tanh_gelu": lambda mp: mp.setattr(ref_vit, "GELU_APPROXIMATE", "tanh"),
    "no_qkv_bias": _drop_qkv_bias,
    "bilinear_upsample": lambda mp: mp.setattr(ref_vit, "UPSAMPLE", "bilinear"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_fails_the_comparison(runs, monkeypatch, fault):
    cell, got, _ = runs["small_pooled"]
    FAULTS[fault](monkeypatch)
    gaps = _gaps(cell, got)
    assert max(gaps.values()) > TOL, gaps
