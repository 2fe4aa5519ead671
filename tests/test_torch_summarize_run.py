"""The port's run summary (`renderih_tpu_torch/tools/summarize_run.py`)
prints what the JAX tool (`tools/summarize_run.py`) prints, on a
metrics.jsonl written by the port's `MetricsWriter`."""

import importlib.util
import os
import sys

import pytest

from renderih_tpu_torch.tools import summarize_run
from renderih_tpu_torch.utils.metrics_writer import MetricsWriter

_TOOL = os.path.join(os.path.dirname(__file__), "..", "tools", "summarize_run.py")


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_summarize_run", _TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("markdown", [False, True])
@pytest.mark.parametrize("evals", [0, 1, 3])
def test_summary_equals_jax_tools(tmp_path, capsys, monkeypatch, markdown, evals):
    with MetricsWriter(str(tmp_path)) as w:
        for step in range(1, 31):
            if step % 4 == 1:
                w.write(step, {"total": 10.0 / step, "vert3d": 0.1}, prefix="train/")
            if evals and step % (30 // evals) == 0:
                w.write(step, {"mpjpe_mm": 100.0 - step, "pa_mpjpe_mm": 50.0 - step,
                               "mpvpe_mm": 90.0 - step}, prefix="eval/")
    argv = [str(tmp_path / "metrics.jsonl")] + (["--markdown"] if markdown else [])
    summarize_run.main(argv)
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["summarize_run.py"] + argv)
    _jax_tool().main()
    assert got == capsys.readouterr().out and "train/total" in got


def test_no_train_records(tmp_path, capsys):
    (tmp_path / "m.jsonl").write_text("")
    summarize_run.main([str(tmp_path / "m.jsonl")])
    assert capsys.readouterr().out == "no train records\n"
