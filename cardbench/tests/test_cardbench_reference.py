"""The plain reference against the program on the CPU, at a small size.

Both configurations of the benchmark at 128² (grid 4), the program in float32
on its plain CPU paths: the same state dict loads into both (the upstream
layout), and the outputs agree to float32 rounding. The configurations'
widths are kept; only the image size and the grid are cut."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cardbench.harness.cell import OUTPUT_KEYS, ROOT, Cell, gap_stats, load_json

SMALL = dict(img_size=128, grid_size=4)
TRAFFIC = dict(kind="offline", batch=2, buckets=[2], pool_images=2, warmup_requests=0,
               check_requests=1, trace_requests=1)


def small_cell(name: str, precision: dict | None = None) -> Cell:
    config = dict(load_json(ROOT / "cardbench" / "configs" / f"{name}.json"), **SMALL)
    if precision is not None:
        config["precision"] = precision
    return Cell(f"{name}.offline256", 987654321987, 1.0, False, device="cpu",
                config=config, traffic=TRAFFIC)


@pytest.mark.parametrize("name", ["resnet50_graph", "hrnet_w32_graph"])
def test_reference_matches_program_f32(name):
    torch.manual_seed(0)
    cell = small_cell(name, {"encoder": "float32", "decoder": "float32"})
    engine = cell.engine()
    rows = np.arange(2)
    got = engine.predict(cell.pool()[rows])
    gaps = gap_stats(got, cell.reference_outputs(rows))["max_abs"]
    assert set(gaps) == set(OUTPUT_KEYS)
    assert max(gaps.values()) < 1e-4, gaps


@pytest.mark.parametrize("name", ["resnet50_graph", "hrnet_w32_graph"])
def test_state_dict_layout_is_the_programs(name):
    """Every key and shape of the program's model, and no other."""
    cell = small_cell(name)
    engine = cell.engine()
    ours = {k: tuple(v.shape) for k, v in cell.state_dict().items()}
    theirs = {k: tuple(v.shape) for k, v in engine.model.state_dict().items()}
    assert ours == theirs


def test_weights_repeat_for_a_seed_and_differ_across_seeds():
    a, b = small_cell("resnet50_graph"), small_cell("resnet50_graph")
    c = Cell("resnet50_graph.offline256", 5, 1.0, False, device="cpu",
             config=a.config, traffic=TRAFFIC)
    wa, wb, wc = a.state_dict(), b.state_dict(), c.state_dict()
    key = "decoder.coord_head.weight"
    assert torch.equal(wa[key], wb[key]) and not torch.equal(wa[key], wc[key])
    assert np.array_equal(a.pool(), b.pool()) and not np.array_equal(a.pool(), c.pool())
