"""Data-parallel eval and serving of the port on a mesh of two CPU devices
(`parallel/mesh.py`) against JAX's on two of the 8 CPU devices.

`tests/test_torch_eval.py`'s config (resnet18 at 256², the small
decoder, f32) with weights drawn by numpy in the shapes of JAX's init
(traced, not run) and random BatchNorm statistics, carried to the port by
`state_dict_from_jax`; one packed split of 10 samples written by the
port's `make_synthetic_packed(seed=3)` (the format both load), the right
hand of samples 0-4 moved onto the left (contact for CDev). Batch 5, which both evaluators cut to 4 on a
data axis of 2, so the tail batch is padded. Checked:
  * `evaluate_packed(mesh=make_mesh(2, devices=[cpu, cpu]))` against
    JAX's `evaluate_packed(mesh=make_mesh(data=2))` (JAX compiles once, in
    the module fixture, its batches streamed): every per-sample metric vector within
    1e-4·max|verts3d| (`test_torch_eval.py`'s bar), the same NaN pattern;
    the device cache and the streamed batches equal; the mesh eval against
    the one-device eval within 1e-6·max|verts3d|; `eval_interhand
    --mesh_data 2` equal to a direct mesh eval;
  * `InferenceEngine(mesh=...)`: its buckets JAX's (each rounded up to a
    multiple of the data axis, `renderih_tpu/serve.py:67-72`); its outputs
    within 1e-5 of each output's largest value of the one-device engine's
    on the same weights, also through `BatchingServer`.
"""

import jax
import numpy as np
import pytest
import torch

from renderih_tpu.assets import make_synthetic_assets as jax_assets
from renderih_tpu.config import load_config as jax_load_config
from renderih_tpu.data.interhand import PackedInterHand as JaxPacked
from renderih_tpu.eval import evaluator as jax_evaluator
from renderih_tpu.models.model import build_model as jax_build_model
from renderih_tpu.models.model import model_call_kwargs as jax_call_kwargs
from renderih_tpu.parallel.mesh import make_mesh as jax_make_mesh
from renderih_tpu_torch.apps import eval_interhand
from renderih_tpu_torch.assets import make_synthetic_assets
from renderih_tpu_torch.config import dump_config, load_config
from renderih_tpu_torch.data.interhand import PackedInterHand, make_synthetic_packed
from renderih_tpu_torch.eval.evaluator import evaluate_packed, evaluate_vectors, summarize
from renderih_tpu_torch.models import build_model, model_call_kwargs
from renderih_tpu_torch.ops.image import normalize_imagenet
from renderih_tpu_torch.parallel.mesh import make_mesh
from renderih_tpu_torch.serve import BatchingServer, InferenceEngine
from renderih_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_eval import N, OVERRIDES, TIMING

BS = 5
BUCKETS = (1, 3, 8)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("packed"))
    jcfg = jax_load_config(overrides=OVERRIDES)
    jassets = jax_assets(0)
    make_synthetic_packed(root, "test", make_synthetic_assets(0), n=N, seed=3)
    labels = dict(np.load(f"{root}/test_labels.npz"))
    rng = np.random.default_rng(0)
    labels["v3d_right"][:5] = (labels["v3d_left"][:5] + [0.002, 0.0, 0.0]
                               + rng.normal(0, 0.001, (5, 778, 3))).astype(np.float32)
    np.savez(f"{root}/test_labels.npz", **labels)

    jmodel = jax_build_model(jcfg, jassets)
    shapes = jax.eval_shape(lambda key: jmodel.init(
        key, np.zeros((1, 256, 256, 3), np.float32), train=False,
        **jax_call_kwargs(jcfg, jassets)), jax.random.PRNGKey(0))

    def draw(path, leaf):  # kernels N(0, 1/fan_in), scales 1 + N(0, 0.05²), the rest N(0, 0.05²)
        name, shape = path[-1].key, leaf.shape
        a = (rng.normal(0, np.prod(shape[:-1]) ** -0.5, shape) if name == "kernel"
             else rng.uniform(0.5, 1.5, shape) if name == "var"
             else (name == "scale") + rng.normal(0, 0.05, shape))
        return a.astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    variables["params"]["decoder"]["upsample_weight"] = np.asarray(jassets.left.upsample_init)
    captured = {}
    summarize_jax = jax_evaluator.summarize

    def capture(vectors, iou=None):
        captured.update(vectors)
        return summarize_jax(vectors, iou)

    jax_evaluator.summarize = capture  # JAX returns the summary only
    try:
        jsummary = jax_evaluator.evaluate_packed(
            jcfg, jmodel, variables, jassets, JaxPacked.load(root, "test"), batch_size=BS,
            mesh=jax_make_mesh(data=2, model=1, devices=jax.devices()[:2]), device_cache=False)
    finally:
        jax_evaluator.summarize = summarize_jax

    cfg = load_config(overrides=OVERRIDES)
    assets = make_synthetic_assets(0)
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    model = build_model(cfg, assets)
    model.load_state_dict(sd)
    model = model.to(memory_format=torch.channels_last)
    dataset = PackedInterHand.load(root, "test")
    mesh = make_mesh(2, devices=["cpu", "cpu"])
    vectors, stats = evaluate_vectors(cfg, model, assets, dataset, batch_size=BS, device="cpu",
                                      mesh=mesh)
    with torch.no_grad():
        img = normalize_imagenet(torch.from_numpy(np.array(dataset.images)).float() / 255.0)
        out = model.eval()(img, **model_call_kwargs(assets))
    scale = max(float(v.abs().max()) for v in out.verts3d.values())
    return dict(root=root, cfg=cfg, assets=assets, model=model, sd=sd, dataset=dataset,
                jvectors=captured, jsummary=jsummary, mesh=mesh, vectors=vectors,
                stats=stats, scale=scale)


def test_mesh_eval_matches_jax_mesh_eval(setup):
    vectors, stats, want = setup["vectors"], setup["stats"], setup["jvectors"]
    assert vectors.keys() == want.keys() and stats["num_samples"] == N
    tol = 1e-4 * setup["scale"]
    for k, w in want.items():
        g, w = vectors[k], np.asarray(w)
        assert g.shape == w.shape == (N,), k
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=k)
        ok = ~np.isnan(w)
        assert np.abs(g[ok] - w[ok]).max() <= tol, (k, np.abs(g[ok] - w[ok]).max(), tol)
    assert np.isfinite(vectors["cdev"][:5]).all() and np.isnan(vectors["cdev"][5:]).any()


def test_mesh_eval_cache_streaming_and_one_device_agree(setup):
    """The streamed batches equal the device cache's (the fixture's run);
    the one-device eval at the batch the mesh cut to (4) agrees; the
    model's train mode is left as it was."""
    assert setup["stats"]["device_cache"]
    model = setup["model"].train()
    try:
        streamed, stats = evaluate_vectors(setup["cfg"], model, setup["assets"],
                                           setup["dataset"], batch_size=BS, device="cpu",
                                           device_cache=False, mesh=setup["mesh"])
        assert model.training and not stats["device_cache"]
        with pytest.raises(TypeError, match="Mesh"):
            evaluate_packed(setup["cfg"], model, setup["assets"], setup["dataset"],
                            device="cpu", mesh=object())
    finally:
        model.eval()
    for k, v in setup["vectors"].items():
        np.testing.assert_array_equal(streamed[k], v, err_msg=k)
    one, _ = evaluate_vectors(setup["cfg"], setup["model"], setup["assets"], setup["dataset"],
                              batch_size=BS - 1, device="cpu")
    for k, v in one.items():
        np.testing.assert_allclose(setup["vectors"][k], v, rtol=0, atol=1e-6 * setup["scale"],
                                   err_msg=k)


def test_eval_cli_mesh_data_equals_a_direct_mesh_eval(setup, tmp_path):
    torch.save({"epoch": 0, "network": setup["sd"]}, tmp_path / "w.pth")
    dump_config(setup["cfg"], str(tmp_path / "cfg.yaml"))
    got = eval_interhand.main(["--cfg", str(tmp_path / "cfg.yaml"), "--torch_ckpt",
                               str(tmp_path / "w.pth"), "--data", setup["root"], "--bs", str(BS),
                               "--device", "cpu", "--mesh_data", "2", "--json"])
    # the fixture's mesh eval, as evaluate_packed summarises it
    want = {**summarize(setup["vectors"]), **setup["stats"]}
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k not in TIMING:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_mesh_engine_rounds_buckets_and_matches_one_device(setup):
    mesh = setup["mesh"]
    engine = InferenceEngine(setup["cfg"], setup["assets"], state_dict=setup["sd"],
                             buckets=BUCKETS, mesh=mesh)
    one = InferenceEngine(setup["cfg"], setup["assets"], state_dict=setup["sd"],
                          buckets=BUCKETS, device="cpu")
    # JAX's rule (renderih_tpu/serve.py:67-72): each bucket rounded up to a
    # multiple of the data axis, duplicates merged
    assert engine.buckets == tuple(sorted({-(-b // 2) * 2 for b in BUCKETS})) == (2, 4, 8)
    assert one.buckets == BUCKETS
    images = np.random.default_rng(2).integers(0, 255, (5, 256, 256, 3), dtype=np.uint8)
    wants = {}
    for n in (3, 5):  # buckets 4 and 8 on the mesh, 3 and 8 on one device
        got, want = engine.predict(images[:n]), one.predict(images[:n])
        wants[n] = want
        assert got.keys() == want.keys()
        for k, w in want.items():
            assert got[k].shape == w.shape and len(w) == n, k
            assert np.abs(got[k] - w).max() <= 1e-5 * np.abs(w).max(), k
    server = BatchingServer(engine, max_wait_ms=50.0)
    try:
        futs = [server.submit(img) for img in images[:3]]
        outs = [f.result(timeout=120) for f in futs]
    finally:
        server.close()
    want = wants[3]
    for i, out in enumerate(outs):
        for k, v in out.items():
            assert np.abs(v - want[k][i]).max() <= 1e-5 * np.abs(want[k]).max(), (i, k)
    with pytest.raises(ValueError, match="first"):
        InferenceEngine(setup["cfg"], setup["assets"], device="cuda:1", mesh=mesh)
