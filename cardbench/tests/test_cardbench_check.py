"""The check that decides `correct`, driven through a whole run of each kind on
the CPU at a small size (the harness's look for a card skipped): a sound run
passes; a run whose timed path is broken underneath, or the lower-precision
control put in the program's place, comes out not correct at the
configuration's limits. The decoder's own number holds the kept decoder
calls to the float32 reference decoder on the same inputs: the program's
bfloat16 decoder path and a decoder output altered where it is produced fail it.

Faults planted where the program produces its answers: the served chunk's
outputs handed back in the wrong order (each image gets another image's
answer), and, in the online kind, a batch that raises. On the CPU the
program's bfloat16 path rounds where the reference in the stated precision
does, so a sound run reads about 1 against limits of 2 and more."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from cardbench.harness.cell import Cell, ROOT, load_json
from cardbench.harness.hooks import DecoderCapture
from cardbench.kinds import offline, online
from cardbench.reference.model import Precision

STATED = {"encoder": "bfloat16", "decoder": "float32"}
OFFLINE = dict(kind="offline", batch=4, buckets=[1, 4], pool_images=8, warmup_requests=1,
               check_requests=2, trace_requests=1)
ONLINE = dict(kind="online", rate_per_s=40, max_wait_ms=2.0, buckets=[1, 4], pool_images=8,
              warmup_requests=2, check_requests=6, trace_seconds=0.5, drain_s=30.0)


def small_cell(kind: str, precision=STATED) -> Cell:
    config = dict(load_json(ROOT / "cardbench" / "configs" / "resnet50_graph.json"),
                  img_size=128, grid_size=4, precision=precision)
    if kind == "offline":
        return Cell("resnet50_graph.offline256", 2 ** 33 + 7, 1.0, False, device="cpu",
                    config=config, traffic=OFFLINE)
    return Cell("resnet50_graph.online", 2 ** 31 + 3, 0.5, False, device="cpu",
                config=config, traffic=ONLINE)


def run(cell: Cell) -> dict:
    kind = offline if cell.traffic["kind"] == "offline" else online
    t0 = time.perf_counter()
    return kind.run(cell, lambda: time.perf_counter() - t0)


@pytest.mark.parametrize("kind", ["offline", "online"])
def test_sound_run_is_correct(kind):
    cell = small_cell(kind)
    res = run(cell)
    ok, checked = cell.check(res)
    assert ok, checked
    assert res["failed"] == 0 and len(res["check_rows"]) == len(res["check_outputs"]["verts3d_left"])


@pytest.mark.parametrize("kind", ["offline", "online"])
def test_answers_handed_to_the_wrong_images_fail(kind, monkeypatch):
    from renderih_tpu_torch.serve import InferenceEngine

    forward = InferenceEngine._forward

    def reversed_rows(self, img_u8):
        return {k: v.flip(0) for k, v in forward(self, img_u8).items()}

    monkeypatch.setattr(InferenceEngine, "_forward", reversed_rows)
    cell = small_cell(kind)
    ok, checked = cell.check(run(cell))
    assert not ok, checked


def test_a_failing_batch_fails_the_online_run(monkeypatch):
    from renderih_tpu_torch.serve import InferenceEngine

    predict, calls = InferenceEngine.predict, []

    def sometimes(self, images):
        calls.append(len(images))
        if len(calls) == 3:  # a batch of the window (warm-up batches come first)
            raise RuntimeError("planted")
        return predict(self, images)

    monkeypatch.setattr(InferenceEngine, "predict", sometimes)
    cell = small_cell("online")
    res = run(cell)
    ok, _ = cell.check(res)
    assert res["failed"] > 0 and not ok


def test_control_in_the_programs_place_fails():
    """The reference one precision below the configuration's (float8 e4m3
    encoder and mid convolutions, TF32 decoder) fails the limits."""
    cell = small_cell("offline")
    rows = np.arange(8)
    low = Precision(encoder="fp8", decoder="tf32")
    ref = cell.reference.build(cell.config, "cpu")
    ref.load_state_dict(cell.state_dict())
    ref.set_precision(low)
    capture = DecoderCapture(ref.decoder, np.random.default_rng(0), 2, 4)
    with torch.no_grad():
        ref(torch.from_numpy(cell.pool()[rows]), *cell.positional())
    capture.remove()
    control = cell.reference_outputs(rows, low)
    ok, checked = cell.check({"check_rows": rows, "check_outputs": control, "failed": 0,
                              "decoder_kept": capture.kept})
    assert not ok, checked


def test_a_bfloat16_decoder_fails_the_decoder_check(monkeypatch):
    """The program's own lower-precision decoder path (`decoder_bf16`) in
    place of the float32 decoder that the configuration states fails the
    decoder's number."""
    from renderih_tpu_torch.serve import InferenceEngine

    init = InferenceEngine.__init__

    def bf16_decoder(self, *args, **kwargs):
        init(self, *args, decoder_bf16=True, **kwargs)

    monkeypatch.setattr(InferenceEngine, "__init__", bf16_decoder)
    cell = small_cell("offline")
    ok, checked = cell.check(run(cell))
    assert not ok and checked["decoder"]["value"] > checked["decoder"]["limit"], checked


def test_decoder_outputs_altered_where_produced_fail(monkeypatch):
    """A decoder whose camera scale is off by one part in a thousand: within
    the bfloat16 encoder's noise end to end, caught by the decoder's number."""
    from renderih_tpu_torch.models.decoder import GraphDecoder

    forward = GraphDecoder.forward

    def nudged(self, *args, **kwargs):
        out = forward(self, *args, **kwargs)
        return out._replace(scale={h: s * 1.001 for h, s in out.scale.items()})

    monkeypatch.setattr(GraphDecoder, "forward", nudged)
    cell = small_cell("offline")
    ok, checked = cell.check(run(cell))
    assert not ok and checked["decoder"]["value"] > checked["decoder"]["limit"], checked
