"""The port's tracer (`renderih_tpu_torch/utils/trace.py`) and the spans and
counters of the serving path and the model, on the CPU at a small config:
nesting and parents, `drain`, tracing off (the default) under a profiler,
`predict`'s spans and ranges once turned on, the rows counters against the
buckets, no CUDA graph on the CPU, the cyclic collector held off across
overlapping captures, and the queue spans of `BatchingServer` on a
profiler trace's clock."""

import gc
import json
import threading

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from renderih_tpu_torch.assets import make_synthetic_assets
from renderih_tpu_torch.config import load_config
from renderih_tpu_torch.kernels import _build
from renderih_tpu_torch.serve import (GRAPHED_PARTS, BatchingServer, InferenceEngine,
                                     _collector_paused)
from renderih_tpu_torch.utils import trace

OVERRIDES = {
    "model": {"encoder": "resnet18", "img_size": 256, "grid_size": 4,
              "gcn_in_dims": [64, 32, 16], "gcn_out_dims": [32, 16, 8],
              "img_dims": [32, 16, 8], "deconv_dims": [32, 32, 32, 32],
              "graph_layer_num": 2},
    "train": {"precision": "f32"},
}
ENGINE_SPANS = {"engine.predict", "engine.upload", "engine.forward", "engine.copy_back",
                "model.encoder", "model.mid_model", "model.decoder"}


@pytest.fixture(autouse=True)
def tracer():
    """Each test starts with no records and ends with tracing off, as a
    process starts, and no records."""
    trace.drain()
    yield
    trace.enable(False)
    trace.drain()


@pytest.fixture(scope="module")
def engine():
    return InferenceEngine(load_config(overrides=OVERRIDES), make_synthetic_assets(0),
                           buckets=(1, 4), device="cpu")


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 256, 256, 3), np.uint8)


def _chrome(prof, tmp_path) -> list:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def _program_ranges(events) -> list:
    return [e for e in events if e.get("cat") == "user_annotation"
            and e.get("name", "").startswith(trace.PREFIX)]


def test_spans_nest_record_their_parents_and_drain_once():
    trace.enable(True)
    with trace.span("outer"):
        with trace.span("inner"):
            token = trace.begin("wait", 7)
        with trace.span("second"):
            pass
    ended = threading.Thread(target=trace.end, args=(token,))
    ended.start()
    ended.join(timeout=10)
    assert not ended.is_alive()
    spans = {s.name: s for s in trace.drain()}
    assert set(spans) == {"outer", "inner", "second", "wait"}
    outer, inner, second, wait = (spans[k] for k in ("outer", "inner", "second", "wait"))
    assert outer.parent == -1 and inner.parent == second.parent == outer.id
    assert wait.parent == inner.id and wait.rid == 7 and outer.rid == -1
    assert {s.tid for s in spans.values()} == {threading.get_native_id()}  # where each began
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= second.start_ns <= outer.end_ns
    assert wait.start_ns <= wait.end_ns
    assert trace.drain() == []


def test_off_records_nothing_and_opens_no_range_under_the_profiler(engine, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.predict(_images(2))
    assert trace.drain() == []
    assert trace.span("x") is trace.span("y")  # one shared null context
    assert trace.begin("serve.queue", 0) is None
    assert _program_ranges(_chrome(prof, tmp_path)) == []


def test_on_predict_records_its_spans_with_and_without_the_profiler(engine, tmp_path):
    trace.enable(True)
    engine.predict(_images(2))
    assert {s.name for s in trace.drain()} == ENGINE_SPANS  # no profiler needed
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.predict(_images(5))
    spans = trace.drain()
    names = [s.name for s in spans]
    assert set(names) == ENGINE_SPANS
    # 5 images at buckets (1, 4): chunks of 4 and 1, each uploaded, run and copied back
    assert [names.count(k) for k in ("engine.upload", "engine.forward", "engine.copy_back",
                                     "model.encoder", "engine.predict")] == [2, 2, 2, 2, 1]
    by_id = {s.id: s for s in spans}
    parent = lambda s: by_id[s.parent].name
    for s in spans:
        if s.name.startswith("model."):
            assert parent(s) == "engine.forward"
        elif s.name != "engine.predict":
            assert parent(s) == "engine.predict"
    ranges = _program_ranges(_chrome(prof, tmp_path))
    assert sorted(e["name"] for e in ranges) == sorted(trace.PREFIX + n for n in names)


def test_vit_spans_hold_the_trunk_then_the_pyramid_inside_the_encoder(monkeypatch):
    """A one-block ViT at 64 wide: each forward's `model.encoder` holds a
    `model.vit.trunk` and then a `model.vit.pyramid`, once each, and the
    other model spans as the CNN encoders have them."""
    from renderih_tpu_torch.models import vit

    monkeypatch.setitem(vit._VIT_CONFIGS, "vit_trace_test",
                        dict(embed_dim=64, depth=1, num_heads=2))
    overrides = dict(OVERRIDES, model=dict(OVERRIDES["model"], encoder="vit_trace_test"))
    eng = InferenceEngine(load_config(overrides=overrides), make_synthetic_assets(0),
                          buckets=(1, 4), device="cpu")
    trace.enable(True)
    eng.predict(_images(5))
    spans = trace.drain()
    vit_spans = {"model.vit.trunk", "model.vit.pyramid"}
    assert {s.name for s in spans} == ENGINE_SPANS | vit_spans
    by_id = {s.id: s for s in spans}
    encoders = [s for s in spans if s.name == "model.encoder"]
    assert len(encoders) == 2  # chunks of 4 and 1
    for enc in encoders:
        inner = sorted((s for s in spans if s.parent == enc.id), key=lambda s: s.start_ns)
        assert [s.name for s in inner] == ["model.vit.trunk", "model.vit.pyramid"]
        assert enc.start_ns <= inner[0].start_ns <= inner[0].end_ns <= inner[1].start_ns
        assert inner[1].end_ns <= enc.end_ns
    assert all(by_id[s.parent].name == "model.encoder" for s in spans if s.name in vit_spans)


def test_rows_counters_count_the_buckets_of_predict(monkeypatch):
    """A `predict` of 5 and of 130 images on the default buckets (1, 8, 32,
    128): 5 -> one forward at 8; 130 -> 128, then 2 at 8."""
    eng = InferenceEngine(load_config(overrides=OVERRIDES), make_synthetic_assets(0),
                          device="cpu")
    chunks = []

    def forward(self, img_u8):
        chunks.append(len(img_u8))
        return {"verts3d_left": torch.zeros(self._bucket(len(img_u8)), 3)}

    monkeypatch.setattr(InferenceEngine, "_forward", forward)
    rows, pad = trace.counter("engine.rows"), trace.counter("engine.pad_rows")
    for n, want_chunks, want_pad in ((5, [5], 3), (130, [128, 2], 6)):
        before = (rows.value, pad.value)
        chunks.clear()
        assert eng.predict(_images(n))["verts3d_left"].shape == (n, 3)
        assert chunks == want_chunks
        assert (rows.value - before[0], pad.value - before[1]) == (n, want_pad)
    assert trace.counters()["engine.rows"] == rows.value


def test_the_launch_counters_are_the_tracers_counter_type():
    assert _build.LaunchCounter is trace.Counter
    c = _build.LaunchCounter()
    c.add()
    c.add(4)
    assert c.value == 5
    c.reset()
    assert c.value == 0
    with trace.hold() as held:  # a CUDA graph's capture: held back, not counted
        c.add(2)
    c.add()
    assert (c.value, held) == (1, [(c, 2)])


def test_an_engine_on_the_cpu_captures_no_graph(engine):
    """CUDA graphs are the card's: on the CPU the model's parts keep their
    own `forward`, and a `predict` captures, replays and counts nothing."""
    names = ("engine.graph_captures", "engine.graph_replays", "engine.eager_forwards")
    before = [trace.counters()[n] for n in names]
    engine.predict(_images(1))
    assert [trace.counters()[n] for n in names] == before
    assert not any("forward" in vars(getattr(engine.model, p)) for p in GRAPHED_PARTS)


@pytest.mark.parametrize("on", [True, False])
def test_the_collector_stays_off_until_the_last_capture_ends(on):
    """Two captures in flight at once, the first ending first: Python's
    cyclic collector is off from the first one's start to the second one's
    end, then as it was before them."""
    was = gc.isenabled()
    try:
        gc.enable() if on else gc.disable()
        first, second = _collector_paused(), _collector_paused()
        first.__enter__()
        assert not gc.isenabled()
        second.__enter__()
        first.__exit__(None, None, None)
        assert not gc.isenabled()
        second.__exit__(None, None, None)
        assert gc.isenabled() == on
    finally:
        gc.enable() if was else gc.disable()


def test_queue_spans_land_on_the_trace_clock(engine, tmp_path):
    """Each request has one `serve.queue` record. Placed on the trace by the
    offset the program's ranges give, its end lies inside the
    `serve.coalesce` range of the batch that took it (within 50 µs), and the
    first request a batch took ends within 50 µs of that range's start."""
    server = BatchingServer(engine, max_wait_ms=20.0)
    try:
        engine.predict(_images(4))  # warm: the first forward is the slowest
        trace.enable(True)
        config = _ExperimentalConfig(profile_all_threads=True)  # the batcher's thread too
        with profile(activities=[ProfilerActivity.CPU], experimental_config=config) as prof:
            futures = []
            for burst in (3, 1, 4):
                futures += [server.submit(img) for img in _images(burst, seed=burst)]
                for f in futures:
                    f.result(timeout=60)
        spans = trace.drain()
    finally:
        server.close()
    waits = [s for s in spans if s.name == "serve.queue"]
    assert sorted(s.rid for s in waits) == list(range(8))
    events = _chrome(prof, tmp_path)
    ranges = _program_ranges(events)
    offset = trace.clock_offset_us(
        [(e["tid"], e["name"][len(trace.PREFIX):], float(e["ts"])) for e in ranges], spans)
    assert offset is not None
    batcher = server._thread.native_id
    coalesce = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in ranges
                      if e["name"] == trace.PREFIX + "serve.coalesce" and e["tid"] == batcher)
    assert len(coalesce) == sum(1 for s in spans if s.name == "serve.coalesce") >= 3
    first_end = {}
    for s in waits:
        at = s.end_ns / 1e3 + offset
        took = [c for c in coalesce if c[0] - 50 <= at <= c[1] + 50]
        assert len(took) == 1, (s, at, coalesce)
        first_end[took[0]] = min(first_end.get(took[0], at), at)
    assert len(first_end) == len(coalesce)
    for (start, _), at in first_end.items():
        assert abs(at - start) <= 50, (at, start)
