"""The port's whole slice against the JAX package on the CPU: synthetic
assets, the full `HandNet` at a small config, the weight converter, and
the serving engine on uint8 images."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderih_tpu.assets import make_synthetic_assets as jax_assets
from renderih_tpu.graph import ops as jax_graph_ops
from renderih_tpu.mano import params as jax_mano
from renderih_tpu.models.decoder import GraphDecoder as JaxGraphDecoder
from renderih_tpu.config import Config as JaxConfig
from renderih_tpu.config import load_config as jax_load_config
from renderih_tpu.models import build_model as jax_build_model
from renderih_tpu.models import model_call_kwargs as jax_call_kwargs
from renderih_tpu.serve import InferenceEngine as JaxEngine
from renderih_tpu.utils.checkpoint_convert import export_reference_checkpoint
from renderih_tpu_torch.assets import make_synthetic_assets
from renderih_tpu_torch.config import Config, load_config
from renderih_tpu_torch.graph import ops as graph_ops
from renderih_tpu_torch.mano import params as mano
from renderih_tpu_torch.models import build_model, init_model, model_call_kwargs
from renderih_tpu_torch.models.decoder import GraphDecoder
from renderih_tpu_torch.utils import weights
from renderih_tpu_torch.serve import BatchingServer, InferenceEngine
from renderih_tpu_torch.utils.weights import state_dict_from_jax

SMALL = {
    "model": {"encoder": "resnet18", "img_size": 128, "grid_size": 4,
              "gcn_in_dims": [64, 32, 16], "gcn_out_dims": [32, 16, 8],
              "img_dims": [32, 16, 8], "deconv_dims": [32, 32, 32, 32],
              "graph_layer_num": 2},
    "train": {"precision": "f32"},
}
OUTPUTS = ("verts3d", "verts2d", "scale", "trans2d")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def small():
    """JAX model + variables (random BN statistics) at the small config,
    and the port's model loaded with the same weights."""
    jcfg = jax_load_config(overrides=SMALL)
    jassets = jax_assets(0)
    jmodel = jax_build_model(jcfg, jassets)
    variables = jax.jit(lambda key: jmodel.init(
        key, jnp.zeros((1, 128, 128, 3)), train=False,
        **jax_call_kwargs(jcfg, jassets)))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 1.5, a.shape) if path[-1].key == "var"
                         else rng.normal(0.0, 0.1, a.shape)).astype(np.float32),
        variables["batch_stats"])
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    cfg = load_config(overrides=SMALL)
    assets = make_synthetic_assets(0)
    state_dict = state_dict_from_jax(params, stats)
    model = build_model(cfg, assets)
    model.load_state_dict(state_dict)
    return dict(jcfg=jcfg, jassets=jassets, jmodel=jmodel, params=params,
                stats=stats, cfg=cfg, assets=assets, state_dict=state_dict,
                model=model.eval())


def _assert_outputs_close(got: dict, want: dict):
    """max|Δ| ≤ 1e-4 on verts3d, scale, trans2d; ≤ 1e-4 relative on verts2d
    (pixels)."""
    for key, ref in want.items():
        ref = np.asarray(ref)
        err = np.abs(np.asarray(got[key]) - ref).max()
        limit = 1e-4 * max(np.abs(ref).max(), 1.0) if "verts2d" in key else 1e-4
        assert err <= limit, f"{key}: max|Δ| {err:.3e} > {limit:.3e}"


def test_synthetic_assets_match_jax(small):
    a, ja = small["assets"], small["jassets"]
    for hand in ("left", "right"):
        h, jh = getattr(a, hand), getattr(ja, hand)
        assert h.verts_nums == jh.verts_nums == (61, 122, 244)
        for name in ("pe", "upsample_init", "j_reg_21", "perm", "perm_reverse"):
            np.testing.assert_array_equal(getattr(h, name).numpy(),
                                          np.asarray(getattr(jh, name)))
        for name in ("v_template", "shapedirs", "J_regressor", "faces",
                     "hands_components_inv"):
            np.testing.assert_array_equal(getattr(h.mano, name).numpy(),
                                          np.asarray(getattr(jh.mano, name)))


def test_handnet_matches_jax(small):
    rng = np.random.default_rng(1)
    img = rng.normal(size=(2, 128, 128, 3)).astype(np.float32)
    jout = jax.jit(lambda v, x: small["jmodel"].apply(
        v, x, train=False, **jax_call_kwargs(small["jcfg"], small["jassets"])))(
            {"params": small["params"], "batch_stats": small["stats"]},
            jnp.asarray(img))
    with torch.no_grad():
        out = small["model"](torch.from_numpy(img),
                             **model_call_kwargs(small["assets"]))
    flat = lambda o: {f"{k}_{h}": getattr(o, k)[h] for k in OUTPUTS
                      for h in ("left", "right")}
    got = {k: v.numpy() for k, v in flat(out).items()}
    _assert_outputs_close(got, flat(jout))
    for hand in ("left", "right"):
        np.testing.assert_allclose(out.coarse_verts3d[hand][0].numpy(),
                                   np.asarray(jout.coarse_verts3d[hand][0]),
                                   atol=1e-4)


def test_state_dict_from_jax_matches_export(small):
    ref = export_reference_checkpoint(small["params"], small["stats"])
    sd = small["state_dict"]
    counters = {k for k in sd if k.endswith(".num_batches_tracked")}
    assert set(sd) - counters == set(ref)
    for key, val in ref.items():
        np.testing.assert_array_equal(sd[key].numpy(), val)
    assert set(small["model"].state_dict()) == set(sd)
    build_model(small["cfg"], small["assets"]).load_state_dict(sd, strict=True)


def test_engine_predict_matches_jax_engine(small):
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, (3, 128, 128, 3), dtype=np.uint8)
    jengine = JaxEngine(small["jcfg"], assets=small["jassets"],
                        variables={"params": small["params"],
                                   "batch_stats": small["stats"]},
                        buckets=(4,))
    engine = InferenceEngine(small["cfg"], assets=small["assets"],
                             state_dict=small["state_dict"], buckets=(2,),
                             device="cpu")
    want = jengine.predict(imgs)
    got = engine.predict(imgs)  # chunks of 2 and 1 (padded to 2)
    assert set(got) == set(want)
    for key in got:
        assert got[key].shape == want[key].shape
    _assert_outputs_close(got, want)


def test_engine_empty_predict_raises(small):
    engine = InferenceEngine(small["cfg"], assets=small["assets"],
                             state_dict=small["state_dict"], buckets=(1,),
                             device="cpu")
    with pytest.raises(ValueError):
        engine.predict(np.zeros((0, 128, 128, 3), np.uint8))


def test_batching_server_matches_predict(small):
    engine = InferenceEngine(small["cfg"], assets=small["assets"],
                             state_dict=small["state_dict"], buckets=(4,),
                             device="cpu")
    imgs = np.random.default_rng(3).integers(0, 256, (3, 128, 128, 3),
                                             dtype=np.uint8)
    want = engine.predict(imgs)
    server = BatchingServer(engine, max_wait_ms=50.0)
    try:
        results = [f.result(timeout=120) for f in
                   [server.submit(im) for im in imgs]]
    finally:
        server.close()
    with pytest.raises(RuntimeError, match="closed"):
        server.submit(imgs[0])
    for i, res in enumerate(results):
        np.testing.assert_allclose(res["verts3d_left"], want["verts3d_left"][i],
                                   atol=1e-5)


@pytest.mark.parametrize("override", [
    {"encoder": "hrnet_w32"}, {"paired_lr": True}, {"use_cheby": True},
    {"encoder": "vit_base"}, {"encoder": "vit_large"}])
def test_unported_variants_raise(small, override):
    cfg = load_config(overrides={"model": override})
    with pytest.raises(NotImplementedError, match="not ported yet"):
        build_model(cfg, small["assets"])


@pytest.mark.parametrize("override", [{"decoder": "mano"}, {"with_aux_heads": True}])
def test_ported_variants_build(small, override):
    cfg = load_config(overrides={**SMALL, "model": {**SMALL["model"], **override}})
    model = build_model(cfg, small["assets"])
    assert (model.decoder.param_regressor is not None) == ("decoder" in override)
    assert (model.hms_head is not None) == ("with_aux_heads" in override)


def test_config_matches_jax_config():
    ours = dataclasses.asdict(Config())
    theirs = dataclasses.asdict(JaxConfig())
    del theirs["model"]["pallas_conv"]  # the port has no kernel switch
    assert ours == theirs


def test_graph_ops_match_jax(small):
    x = np.random.default_rng(4).normal(size=(2, 976, 5)).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for p in (1, 2, 4):
        for name in ("graph_pool_avg", "graph_pool_max", "graph_upsample"):
            np.testing.assert_allclose(
                getattr(graph_ops, name)(xt, p).numpy(),
                np.asarray(getattr(jax_graph_ops, name)(xj, p)), rtol=1e-6)
    perm, perm_rev = small["assets"].left.perm, small["assets"].left.perm_reverse
    verts = xt[:, :778]
    np.testing.assert_array_equal(
        graph_ops.vert_to_gcn(verts, perm).numpy(),
        np.asarray(jax_graph_ops.vert_to_gcn(jnp.asarray(verts.numpy()),
                                             jnp.asarray(perm.numpy()))))
    np.testing.assert_array_equal(
        graph_ops.gcn_to_vert(xt, perm_rev).numpy(),
        np.asarray(jax_graph_ops.gcn_to_vert(xj, jnp.asarray(perm_rev.numpy()))))


def test_mano_npz_loader_and_left_fix_match_jax(tmp_path):
    """Both packages read one converted-MANO npz alike, and the left-hand
    shapedirs fix agrees (here it applies: x-components made equal)."""
    right = jax_mano.make_synthetic_mano(seed=0, is_right=True)
    left = jax_mano.make_synthetic_mano(seed=0, is_right=False)
    paths = {}
    for name, m in (("left", left), ("right", right)):
        sd = np.asarray(m.shapedirs).copy()
        sd[:, 0, :] = np.asarray(right.shapedirs)[:, 0, :]
        paths[name] = tmp_path / f"{name}.npz"
        np.savez(paths[name], v_template=np.asarray(m.v_template), shapedirs=sd,
                 posedirs=np.asarray(m.posedirs),
                 J_regressor=np.asarray(m.J_regressor),
                 weights=np.asarray(m.weights),
                 hands_components=np.asarray(m.hands_components),
                 hands_mean=np.asarray(m.hands_mean), faces=np.asarray(m.faces),
                 kintree_parents=np.asarray(jax_mano.MANO_PARENTS, np.int32),
                 is_right=np.asarray(name == "right"))
    ours = {k: mano.load_mano_npz(str(p)) for k, p in paths.items()}
    theirs = {k: jax_mano.load_mano_npz(str(p)) for k, p in paths.items()}
    fixed = mano.fix_left_shapedirs(ours["left"], ours["right"])
    fixed_j = jax_mano.fix_left_shapedirs(theirs["left"], theirs["right"])
    np.testing.assert_array_equal(fixed.shapedirs.numpy(),
                                  np.asarray(fixed_j.shapedirs))
    assert not np.array_equal(fixed.shapedirs.numpy(),
                              ours["left"].shapedirs.numpy())
    for name in ("v_template", "hands_components_inv", "faces"):
        np.testing.assert_array_equal(getattr(ours["right"], name).numpy(),
                                      np.asarray(getattr(theirs["right"], name)))
    assert ours["right"].is_right and not ours["left"].is_right


@pytest.mark.parametrize("decoder_f32", [True, False])
def test_precision_policy(small, decoder_f32):
    """bf16 encoder; decoder trunk f32 unless decoder_f32=False; heads f32."""
    cfg = load_config(overrides={**SMALL, "train": {"precision": "bf16"},
                                 "model": {**SMALL["model"],
                                           "decoder_f32": decoder_f32}})
    model = build_model(cfg, small["assets"]).eval()
    seen = {}
    hook = lambda name: (lambda mod, args, out: seen.__setitem__(
        name, (out[0] if isinstance(out, (list, tuple)) else out).dtype))
    model.encoder.register_forward_hook(hook("encoder"))
    model.decoder.dual_gcn.layers[0].graph_left.register_forward_hook(hook("trunk"))
    with torch.no_grad():
        out = model(torch.zeros(1, 128, 128, 3), **model_call_kwargs(small["assets"]))
    assert seen["encoder"] == torch.bfloat16
    assert seen["trunk"] == (torch.float32 if decoder_f32 else torch.bfloat16)
    assert out.verts3d["left"].dtype == torch.float32
    assert torch.isfinite(out.verts3d["left"]).all()


def test_decoder_with_bbox_info_matches_jax(small):
    """The graph head alone with CLIFF bbox conditioning (global feature
    width 64 + 3)."""
    rng = np.random.default_rng(5)
    a = small["assets"].left
    gf = rng.normal(size=(2, 64)).astype(np.float32)
    bbox = rng.normal(size=(2, 3)).astype(np.float32)
    fmaps = [rng.normal(size=(2, s, s, 24)).astype(np.float32) for s in (4, 8, 16)]
    dims = dict(gcn_in_dims=(64, 32, 16), gcn_out_dims=(32, 16, 8),
                img_sizes=(4, 8, 16), grid_f_dims=(32, 16, 8), grid_size=4,
                graph_layer_num=2, img_size=128)
    jdec = JaxGraphDecoder(verts_nums=a.verts_nums, **dims)
    args = (jnp.asarray(gf), [jnp.asarray(f) for f in fmaps], jnp.asarray(a.pe.numpy()),
            jnp.asarray(small["assets"].right.pe.numpy()),
            jnp.asarray(a.upsample_init.numpy()))
    params = jax.jit(lambda k: jdec.init(k, *args, bbox_info=jnp.asarray(bbox)))(
        jax.random.PRNGKey(3))["params"]
    want = jax.jit(lambda p: jdec.apply({"params": p}, *args,
                                        bbox_info=jnp.asarray(bbox)))(params)
    dec = GraphDecoder(a.verts_nums, 64, (24, 24, 24), bbox_dim=3, **dims)
    sd = {}
    weights._decoder(jax.tree_util.tree_map(np.asarray, params), "m", sd)
    dec.load_state_dict({k[2:]: v for k, v in sd.items()})
    with torch.no_grad():
        got = dec.eval()(torch.from_numpy(gf),
                         [torch.from_numpy(f).permute(0, 3, 1, 2) for f in fmaps],
                         a.pe, small["assets"].right.pe, torch.from_numpy(bbox))
    flat = lambda o, conv: {f"{k}_{h}": conv(getattr(o, k)[h]) for k in OUTPUTS
                            for h in ("left", "right")}
    _assert_outputs_close(flat(got, lambda t: t.numpy()), flat(want, np.asarray))


@pytest.mark.parametrize("zero_init_heads", [False, True])
def test_init_model_is_seeded_and_follows_the_config(small, zero_init_heads):
    cfg = load_config(overrides={**SMALL, "model": {
        **SMALL["model"], "zero_init_heads": zero_init_heads}})
    m1 = init_model(cfg, small["assets"], torch.Generator().manual_seed(7))
    m2 = init_model(cfg, small["assets"], torch.Generator().manual_seed(7))
    for (k, v1), v2 in zip(m1.state_dict().items(), m2.state_dict().values()):
        torch.testing.assert_close(v1, v2, rtol=0, atol=0, msg=k)
    dec = m1.decoder
    torch.testing.assert_close(dec.unsample_layer.weight,
                               small["assets"].left.upsample_init)
    for head in (dec.coord_head, dec.params_head):
        assert bool((head.weight == 0).all()) == zero_init_heads
    assert bool((dec.avg_head.weight != 0).any())  # never zeroed
