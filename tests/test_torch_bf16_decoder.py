"""The bf16-decoder serving knob (`InferenceEngine(decoder_bf16=)`,
`serve_http --decoder_bf16`) and its accuracy tool
(`tools/validate_bf16_decoder.py`) in the port, on the CPU at a small
config."""

import copy
import json

import numpy as np
import pytest
import torch

from renderih_tpu_torch import serve_http
from renderih_tpu_torch.assets import make_synthetic_assets
from renderih_tpu_torch.config import dump_config, load_config
from renderih_tpu_torch.serve import InferenceEngine
from renderih_tpu_torch.tools import validate_bf16_decoder

OVERRIDES = {
    "model": {"encoder": "resnet18", "img_size": 256, "grid_size": 4,
              "gcn_in_dims": [64, 32, 16], "gcn_out_dims": [32, 16, 8],
              "img_dims": [32, 16, 8], "deconv_dims": [32, 32, 32, 32],
              "graph_layer_num": 2},
    "train": {"precision": "f32"},
}


@pytest.fixture(scope="module")
def assets():
    return make_synthetic_assets(0)


def test_knob_equals_a_decoder_f32_false_engine_and_leaves_the_callers_config(assets):
    """bf16 compute (decoder_f32 matters only there): the knob's engine
    gives the outputs of one built on `decoder_f32=False`, bit for bit."""
    cfg = load_config(overrides={**OVERRIDES, "train": {"precision": "bf16"}})
    before = copy.deepcopy(cfg)
    knob = InferenceEngine(cfg, assets, buckets=(2,), device="cpu", decoder_bf16=True)
    assert cfg == before and cfg.model.decoder_f32  # the caller's config is untouched
    assert not knob.cfg.model.decoder_f32
    off = copy.deepcopy(cfg)
    off.model.decoder_f32 = False
    plain = InferenceEngine(off, assets, buckets=(2,), device="cpu")
    f32 = InferenceEngine(cfg, assets, buckets=(2,), device="cpu")
    imgs = np.random.default_rng(0).integers(0, 256, (2, 256, 256, 3), np.uint8)
    got, want, ref = knob.predict(imgs), plain.predict(imgs), f32.predict(imgs)
    assert got.keys() == want.keys()
    for k in got:
        assert np.array_equal(got[k], want[k]), k
    assert any(not np.array_equal(got[k], ref[k]) for k in got)  # bf16 moves the outputs


def test_bf16_decoder_layer_norms_take_one_dtype(assets):
    """Every LayerNorm of a `decoder_f32=False` forward gets its input in
    its parameters' dtype: the CUDA kernel refuses a bf16 input with
    float32 parameters (the CPU kernel takes it, so the card's failure
    shows here only as the mix), and returns the input's dtype (bf16, as
    flax's `LayerNorm(dtype=bf16)`)."""
    from torch.overrides import TorchFunctionMode

    from renderih_tpu_torch.models import init_model, model_call_kwargs

    seen = []

    class Record(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if func is torch.nn.functional.layer_norm:
                weight = kwargs["weight"] if "weight" in kwargs else args[2]
                seen.append((args[0].dtype, weight.dtype))
            return out

    cfg = load_config(overrides={**OVERRIDES, "train": {"precision": "bf16"}})
    cfg.model.decoder_f32 = False
    model = init_model(cfg, assets, torch.Generator().manual_seed(0)).eval()
    modules = []
    for mod in model.modules():
        if isinstance(mod, torch.nn.LayerNorm):
            mod.register_forward_hook(lambda m, a, out: modules.append((a[0].dtype, out.dtype)))
    x = torch.rand(1, 256, 256, 3)
    with torch.no_grad(), Record():
        model(x, **model_call_kwargs(assets, "cpu"))
    assert seen and all(a == w for a, w in seen), sorted(set(seen))
    assert set(modules) == {(torch.bfloat16, torch.bfloat16)}


def test_serve_http_flag_reaches_the_engine(monkeypatch):
    made = {}

    class Engine:
        buckets = (1,)

        def __init__(self, cfg, **kwargs):
            made.update(kwargs)

    class Server:
        port = 0

        def __init__(self, engine, host, port):
            pass

        def serve_forever(self):
            raise KeyboardInterrupt

        def close(self):
            made["closed"] = True

    monkeypatch.setattr(serve_http, "InferenceEngine", Engine)
    monkeypatch.setattr(serve_http, "HandPoseHTTPServer", Server)
    serve_http.main(["--decoder_bf16", "--device", "cpu", "--port", "0"])
    assert made["decoder_bf16"] is True and made["device"] == "cpu" and made["closed"]
    made.clear()
    serve_http.main(["--device", "cpu", "--port", "0"])
    assert made["decoder_bf16"] is False


def test_validate_bf16_decoder_prints_its_json_line(tmp_path, capsys):
    """Two steps at batch 4 on 8 samples, bf16 as `Config()`: the two
    decoders' predictions differ and every number is finite."""
    cfg = load_config(overrides={**OVERRIDES, "train": {"precision": "bf16"}})
    dump_config(cfg, str(tmp_path / "small.yaml"))
    prev = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        report = validate_bf16_decoder.main(["--cfg", str(tmp_path / "small.yaml"), "--steps",
                                             "2", "--bs", "4", "--n", "8", "--device", "cpu"])
    finally:
        torch.set_num_threads(prev)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == pytest.approx(report, nan_ok=True)
    for key in ("mpjpe_f32_mm", "mpjpe_bf16_mm", "mpjpe_delta_mm", "mpvpe_delta_mm",
                "pa_mpjpe_delta_mm", "mean_vert_displacement_mm"):
        assert np.isfinite(line[key]), key
    assert line["steps"] == 2 and line["mean_vert_displacement_mm"] > 0
    assert abs(line["mpjpe_delta_mm"] - (line["mpjpe_bf16_mm"] - line["mpjpe_f32_mm"])) < 1e-3
