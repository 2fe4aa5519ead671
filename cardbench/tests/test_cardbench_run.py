"""`run.py` without a card: no result and a non-zero exit; which metrics a
cell reports; the window's line by quarter."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from cardbench import run


@pytest.mark.skipif(torch.cuda.is_available(), reason="holds where no card is visible")
def test_no_card_prints_no_result(capsys):
    before = os.sched_getaffinity(0)
    try:
        rc = run.main(["--workload", "resnet50_graph.offline256", "--seed", str(2 ** 33 + 1),
                       "--seconds", "1"])
    finally:
        os.sched_setaffinity(0, before)  # the offline traffic holds the process to one core
    out = capsys.readouterr().out
    assert rc != 0 and not any(line.startswith("{") for line in out.splitlines())


def test_metrics_reported_by_their_workloads():
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    by_name = {m["name"]: m for m in bench["end_to_end"] + bench["per_layer"]}
    assert run.reported(by_name["setup_s"], "resnet50_graph.online")
    assert not run.reported(by_name["infer_images_per_s"], "resnet50_graph.online")
    assert run.reported(by_name["batch_fill.online"], "resnet50_graph.online")
    assert not run.reported(by_name["batch_fill.online"], "resnet50_graph.offline256")


def test_timeline_line_counts_each_quarter():
    at = np.array([0.5, 1.5, 2.5, 3.5, 3.6, 3.7])
    latency = np.array([0.010, 0.020, 0.030, 0.040, 0.050, np.inf])
    line = run.timeline_line((at, latency), 4.0)
    assert line == "window by quarter: 1 at 10.0 ms, 1 at 20.0 ms, 1 at 30.0 ms, 2 at 45.0 ms"
