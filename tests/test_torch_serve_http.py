"""The port's HTTP front end (`renderih_tpu_torch/serve_http.py`): the six
cases of tests/test_serve_http.py (npy single image and batch, JSON, a bad
shape, an unknown path, the health check) on a small config on the CPU;
each response equals `InferenceEngine.predict` of the same images."""

import io
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from renderih_tpu_torch.assets import make_synthetic_assets
from renderih_tpu_torch.config import load_config
from renderih_tpu_torch.serve import InferenceEngine
from renderih_tpu_torch.serve_http import HandPoseHTTPServer

SIZE = 128
SMALL = {
    "model": {"encoder": "resnet18", "img_size": SIZE, "grid_size": 4,
              "gcn_in_dims": [64, 32, 16], "gcn_out_dims": [32, 16, 8],
              "img_dims": [32, 16, 8], "deconv_dims": [32, 32, 32, 32],
              "graph_layer_num": 2},
    "train": {"precision": "f32"},
}
ATOL = 2e-5  # tests/test_serve_http.py's


@pytest.fixture(scope="module")
def server():
    torch.manual_seed(0)
    engine = InferenceEngine(load_config(overrides=SMALL), assets=make_synthetic_assets(0),
                             buckets=(1, 4), device="cpu")
    srv = HandPoseHTTPServer(engine, host="127.0.0.1", port=0, max_wait_ms=5.0)
    srv.start()
    yield srv
    srv.close()


def _post(server, body: bytes, ctype: str):
    req = urllib.request.Request(f"http://127.0.0.1:{server.port}/predict", data=body,
                                 headers={"Content-Type": ctype}, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.headers.get("Content-Type"), r.read()


def _images(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 255, (n, SIZE, SIZE, 3), np.uint8)


def _npy(a: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def test_healthz(server):
    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/healthz", timeout=30) as r:
        info = json.loads(r.read())
    assert info == {"status": "ok", "buckets": [1, 4], "encoder": "resnet18"}


def test_npy_single_image_round_trip(server):
    img = _images(1)[0]
    ctype, body = _post(server, _npy(img), "application/x-npy")
    assert ctype == "application/x-npz"
    out = np.load(io.BytesIO(body))
    ref = server.engine.predict(img[None])
    assert set(out.files) == set(ref)
    for key, want in ref.items():
        assert out[key].shape == want.shape[1:]
        np.testing.assert_allclose(out[key], want[0], atol=ATOL, err_msg=key)


def test_npy_batch_round_trip(server):
    imgs = _images(3, seed=1)
    _, body = _post(server, _npy(imgs), "application/x-npy")
    out = np.load(io.BytesIO(body))
    assert out["verts3d_left"].shape == (3, 778, 3)
    for key, want in server.engine.predict(imgs).items():
        np.testing.assert_allclose(out[key], want, atol=ATOL, err_msg=key)


def test_json_round_trip(server):
    img = _images(1, seed=2)[0]
    ctype, resp = _post(server, json.dumps({"image": img.tolist()}).encode(),
                        "application/json")
    assert ctype == "application/json"
    out = json.loads(resp)
    for key, want in server.engine.predict(img[None]).items():
        np.testing.assert_allclose(np.asarray(out[key], np.float32), want[0], atol=ATOL,
                                   err_msg=key)


def test_bad_shape_is_400_not_500(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, _npy(np.zeros((16, 16, 3), np.uint8)), "application/x-npy")
    assert e.value.code == 400
    assert "expected" in json.loads(e.value.read())["error"]


def test_unknown_path_404(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/nope", timeout=30):
            pass
    assert e.value.code == 404
