"""Every entry of `BENCHMARK.json` resolves to its files, and the file keeps to
the shape the harness reads: each configuration to its file, each cell to a
configuration and a traffic file whose kind has a module, each per-layer
metric to a reader with `read`, each metric's cells to cells that exist."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = {w["name"]: w for w in BENCH["workloads"]}
CONFIGS = {c["name"]: c for c in BENCH["configs"]}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cardbench"]
    assert BENCH["command"][1] == "cardbench/run.py" and (ROOT / BENCH["command"][1]).is_file()
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_resolves(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(config["name"]) and all(NAME.match(k) for k in config["reduced"])
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["name"] == config["name"] and data["source"] == config["source"]
    assert sorted(data["reduced"]) == sorted(config["reduced"])
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and cell["config"] in CONFIGS and cell["chips"] in (1, 4)
    traffic = json.loads((ROOT / "cardbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    assert (ROOT / "cardbench" / "kinds" / f"{traffic['kind']}.py").is_file()
    assert 1 <= len(cell["why"]) <= 200
    reported = [m for m in BENCH["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
    assert any(cell["name"] in m["workloads"] for m in BENCH["per_layer"])


@pytest.mark.parametrize("metric", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(metric):
    assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher") and 0.01 <= metric["bound"] <= 0.25
    assert metric["source"] in ("host_clock", "device_trace")
    assert set(metric.get("workloads", [])) <= set(CELLS)


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_has_a_reader(metric):
    assert set(metric) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    e2e = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
    assert set(metric["workloads"]) <= set(e2e.get("workloads", CELLS))
    path = ROOT / "cardbench" / "metrics" / f"{metric['name']}.py"
    spec = importlib.util.spec_from_file_location("reader_" + metric["name"].replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    assert callable(module.read)
