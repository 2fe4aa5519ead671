"""The ViT encoder of the port (`models/vit.py`) against the JAX package on
the CPU, on the same seeded numpy inputs and weights (carried with
`utils/weights.py`; drawn with numpy, biases and norms off their init):

  * `ViTBlock` at ViT-B's width (768, 12 heads, N = 256), batch 2;
  * `PooledKVAttention` at 768/8 (D = 96) and 1024/8 (D = 128);
  * `ViTEncoder` + `ViTMid` and the whole `HandNet` (`configs/vitpose_base.yaml`:
    `decoder: mano`, with a tiny ViT and a small decoder), in float32
    within 1e-4 of each output's largest |value| (PARITY.md:14);
  * the pyramid's dtypes under `precision: bf16`;
  * one AdamW step of that network against `make_train_step`: the loss
    terms within 1e-4 relative, the gradients (Adam's first moment over
    0.1) within tests/test_torch_train.py's limits (every tensor 1.5e-3 of
    its largest value, 80% of the tensors within 1e-4);
  * the weights round trip: the port's state_dict through JAX's
    `convert_vit_wrapper` gives back the JAX parameters it came from, and
    the converter reads every key of the port's encoder, no more.

The tiny ViT (`TINY`) is added to both packages' registries for this
module only. The JAX steps run the default XLA path (einsum attention),
the plain route of B1.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from renderih_tpu.assets import make_synthetic_assets as jax_assets
from renderih_tpu.config import load_config as jax_load_config
from renderih_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from renderih_tpu.models import build_model as jax_build_model
from renderih_tpu.models import model_call_kwargs as jax_call_kwargs
from renderih_tpu.models import vit as jax_vit
from renderih_tpu.train.state import create_train_state as jax_create_train_state
from renderih_tpu.train.trainer import make_train_step as jax_make_train_step
from renderih_tpu.utils import checkpoint_convert
from renderih_tpu_torch.assets import make_synthetic_assets
from renderih_tpu_torch.config import load_config
from renderih_tpu_torch.models import build_model, model_call_kwargs, vit
from renderih_tpu_torch.train.state import create_train_state
from renderih_tpu_torch.train.trainer import make_train_step
from renderih_tpu_torch.utils import weights
from renderih_tpu_torch.utils.weights import state_dict_from_jax

TINY_NAME, TINY = "vit_tiny_port_test", dict(embed_dim=64, depth=2, num_heads=4)
YAML = str(Path(__file__).resolve().parents[1] / "configs" / "vitpose_base.yaml")
B, SPE, LR = 2, 10, 1e-3
OVERRIDES = {
    "model": {"encoder": TINY_NAME, "grid_size": 4, "gcn_in_dims": [64, 32, 16],
              "gcn_out_dims": [32, 16, 8], "img_dims": [32, 16, 8],
              "graph_layer_num": 2, "dropout": 0.0},
    "train": {"precision": "f32", "batch_size": B, "warmup_epochs": 0,
              "optimizer": "adamw", "lr": LR},
    "loss": {"norm_epoch": 0, "camera": 1.0},
}
OUTPUTS = ("verts3d", "verts2d", "scale", "trans2d", "mano_pose", "mano_shape")
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _tiny_vit_and_one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_vit._VIT_CONFIGS, TINY_NAME, TINY)
        mp.setitem(vit._VIT_CONFIGS, TINY_NAME, TINY)
        mp.setitem(checkpoint_convert._VIT_DEPTHS, TINY_NAME, TINY["depth"])
        yield
    torch.set_num_threads(prev)


def _random_params(init, *args, seed: int):
    """Parameters of the shapes `init(key, *args)` makes (traced, not run),
    drawn with numpy: kernels N(0, 1/fan_in), scales 1 + N(0, 0.05²),
    biases and the rest N(0, 0.05²)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        a = (rng.normal(0, np.prod(shape[:-1]) ** -0.5, shape) if name == "kernel"
             else (name == "scale") + rng.normal(0, 0.05, shape))
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        draw, jax.eval_shape(init, jax.random.PRNGKey(0), *args)["params"])


def _close(got: torch.Tensor, want, tol: float = TOL):
    want = np.asarray(want)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


def _load(module: torch.nn.Module, sd: dict, prefix: str = "") -> torch.nn.Module:
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=True)
    return module.eval()


def test_vit_block_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 256, 768)).astype(np.float32)
    jblk = jax_vit.ViTBlock(768, 12)
    params = _random_params(jblk.init, x, seed=1)
    want = jax.jit(jblk.apply)({"params": params}, x)
    sd = {}
    weights._vit_block(params, "b", sd)
    blk = _load(vit.ViTBlock(768, 12), sd, "b.")
    with torch.no_grad():
        _close(blk(torch.from_numpy(x)), want)


@pytest.mark.parametrize("dim", [768, 1024])
def test_pooled_kv_attention_matches_jax(dim):
    """8 heads: D = 96 (ViT-B) and 128 (ViT-L), N = 64 queries, M = 256 keys."""
    fmap = np.random.default_rng(2).normal(size=(2, 16, 16, dim)).astype(np.float32)
    jattn = jax_vit.PooledKVAttention(dim)
    params = _random_params(jattn.init, fmap, seed=4)
    want = jax.jit(jattn.apply)({"params": params}, fmap)
    sd = {}
    weights._pooled_kv(params, "d", sd)
    attn = _load(vit.PooledKVAttention(dim), sd, "d.")
    with torch.no_grad():
        got = attn(torch.from_numpy(fmap).permute(0, 3, 1, 2), torch.float32)
    _close(_nhwc(got), want)
    with pytest.raises(ValueError, match="16x16"):
        attn(torch.zeros(1, dim, 8, 8), torch.float32)


def test_vit_encoder_and_mid_match_jax():
    img = np.random.default_rng(5).normal(size=(2, 256, 256, 3)).astype(np.float32)
    jenc, jmid = jax_vit.ViTEncoder(TINY_NAME), jax_vit.ViTMid()
    params = _random_params(jenc.init, img, seed=7)
    pyramid = jax.jit(jenc.apply)({"params": params}, img)
    gf, fmaps = jmid.apply({}, pyramid)
    sd = {}
    weights._vit(params, sd)
    enc = _load(vit.ViTEncoder(TINY_NAME), sd)
    with torch.no_grad():
        got = enc(torch.from_numpy(img).permute(0, 3, 1, 2))
        got_gf, got_fmaps = vit.ViTMid()(got)
    assert [tuple(f.shape) for f in got] == [(2, 64, s, s) for s in (8, 16, 32)]
    for g, w in zip(got, pyramid):
        _close(_nhwc(g), w)
    for g, w in zip(got_fmaps, fmaps):
        _close(_nhwc(g), w)
    _close(got_gf, gf)


@pytest.fixture(scope="module")
def net():
    """JAX's HandNet at the vitpose config (tiny ViT, small decoder, f32)
    with perturbed parameters, the port's loaded with them, and a batch."""
    jcfg = jax_load_config(YAML, overrides=OVERRIDES)
    jassets = jax_assets(0)
    jmodel = jax_build_model(jcfg, jassets)
    init = lambda key, x: jmodel.init(key, x, train=False, **jax_call_kwargs(jcfg, jassets))
    x = jnp.zeros((1, 256, 256, 3))
    assert "batch_stats" not in jax.eval_shape(init, jax.random.PRNGKey(0), x)  # no BatchNorm
    params = _random_params(init, x, seed=8)
    params["decoder"]["upsample_weight"] = np.asarray(jassets.left.upsample_init)
    cfg = load_config(YAML, overrides=OVERRIDES)
    assert cfg.model.decoder == "mano" and cfg.model.encoder == TINY_NAME
    assets = make_synthetic_assets(0)
    sd = state_dict_from_jax(params, {})
    model = build_model(cfg, assets)
    model.load_state_dict(sd, strict=True)
    labels = np.random.default_rng(9)
    batch = {k: np.asarray(v) for k, v in jax_synthetic_batch(
        jassets, jax.random.PRNGKey(1), batch_size=B, img_size=256).items()}
    batch.update({f"pose_{h}": (labels.normal(size=(B, 48)) * 0.3).astype(np.float32)
                  for h in ("left", "right")})
    batch.update({f"shape_{h}": labels.normal(size=(B, 10)).astype(np.float32)
                  for h in ("left", "right")})
    batch["img"] = labels.normal(size=(B, 256, 256, 3)).astype(np.float32)
    return dict(jcfg=jcfg, jassets=jassets, jmodel=jmodel, params=params, cfg=cfg,
                assets=assets, sd=sd, model=model.eval(), batch=batch)


def test_handnet_vit_matches_jax(net):
    img = net["batch"]["img"]
    jout = jax.jit(lambda p, x: net["jmodel"].apply(
        {"params": p}, x, train=False, **jax_call_kwargs(net["jcfg"], net["jassets"])))(
            net["params"], jnp.asarray(img))
    with torch.no_grad():
        out = net["model"](torch.from_numpy(img), **model_call_kwargs(net["assets"]))
    for key in OUTPUTS:
        for hand in ("left", "right"):
            _close(getattr(out, key)[hand], getattr(jout, key)[hand])


def test_pyramid_dtypes_under_bf16_match_jax(net):
    """flax's dtype flow: f8 and f32 in bf16, f16 (last_norm) and the
    global feature in float32."""
    bf16 = {**OVERRIDES, "train": {**OVERRIDES["train"], "precision": "bf16"}}
    jcfg = jax_load_config(YAML, overrides=bf16)
    jmodel = jax_build_model(jcfg, net["jassets"])
    img = net["batch"]["img"][:1]
    jgf, jfmaps = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, method=jmodel.encode))(
        net["params"], jnp.asarray(img))
    model = build_model(load_config(YAML, overrides=bf16), net["assets"])
    model.load_state_dict(net["sd"])
    with torch.no_grad():
        x = torch.from_numpy(img).to(model.dtype).permute(0, 3, 1, 2)
        gf, fmaps = model.eval().mid_model(vit.vit_pyramid(model, x))
    name = lambda dt: str(dt).rsplit(".", 1)[-1]
    assert [name(f.dtype) for f in fmaps] == [name(f.dtype) for f in jfmaps] \
        == ["bfloat16", "float32", "bfloat16"]
    assert name(gf.dtype) == name(jgf.dtype) == "float32"
    for g, w in zip(fmaps, jfmaps):
        assert torch.isfinite(g.float()).all()
        _close(_nhwc(g), np.asarray(w, np.float32), tol=0.1)


def test_weights_round_trip_through_jax_converter(net):
    """The port's state_dict -> `convert_vit_wrapper` -> the JAX encoder
    parameters it came from, bit for bit; the converter reads every
    non-decoder key of the port's state_dict and nothing else."""
    read = set()

    class Tracked(dict):
        def __getitem__(self, key):
            read.add(key)
            return super().__getitem__(key)

    sd = Tracked((k, v.numpy()) for k, v in net["model"].state_dict().items())
    enc = checkpoint_convert.convert_vit_wrapper(sd, TINY_NAME)
    want = net["params"]["encoder"]
    assert jax.tree_util.tree_structure(enc) == jax.tree_util.tree_structure(want)
    for got, ref in zip(jax.tree_util.tree_leaves(enc), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(got), ref)
    assert read == {k for k in sd if not k.startswith("decoder.")}


def test_adamw_step_matches_jax(net):
    jcfg = net["jcfg"]
    state0 = jax_create_train_state(jcfg, {"params": net["params"], "batch_stats": {}}, SPE)
    jstep, _ = jax_make_train_step(jcfg, net["jmodel"], net["jassets"], SPE,
                                   params_template=net["params"])
    state1, jterms = jstep(state0, {k: jnp.asarray(v) for k, v in net["batch"].items()},
                           jax.random.PRNGKey(2))
    model = build_model(net["cfg"], net["assets"])
    model.load_state_dict(net["sd"])
    state = create_train_state(net["cfg"], model, SPE)
    terms = make_train_step(net["cfg"], net["assets"], SPE, "cpu")(
        state, {k: torch.tensor(v) for k, v in net["batch"].items()})

    assert float(jterms["skipped_nonfinite"]) == 0.0
    assert set(terms) == set(jterms) and {"mano_pose", "mano_shape"} <= set(terms)
    for k, ref in jterms.items():
        assert abs(float(terms[k]) - float(ref)) <= 1e-4 * abs(float(ref)) + 1e-7, (
            k, float(terms[k]), float(ref))
    assert state.step == int(state1.step) == 1

    adam = [s for s in jax.tree_util.tree_leaves(
        state1.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(adam) == 1

    def fill(p, x):
        if isinstance(p, dict):
            return {k: fill(p[k], x[k]) for k in p}
        return np.zeros_like(p) if isinstance(x, optax.MaskedNode) else np.asarray(x)

    mu = state_dict_from_jax(fill(net["params"], adam[0].mu), {})
    tight = []
    for name, p in state.model.named_parameters():
        if not p.requires_grad:
            assert name == "decoder.unsample_layer.weight"
            continue
        if name.endswith("w_ks.bias"):  # gradient 0 but for rounding (test_torch_train.py)
            continue
        g, g_ref = state.optimizer.state[p]["exp_avg"].numpy() / 0.1, mu[name].numpy() / 0.1
        err, scale = np.abs(g - g_ref).max(), np.abs(g_ref).max()
        assert err <= 1.5e-3 * scale + 1e-7, (name, err, scale)
        tight.append(err <= 1e-4 * scale + 1e-7)
    assert np.mean(tight) >= 0.8, np.mean(tight)
