"""The HRNet encoder of the port (`models/hrnet.py`) against the JAX
package on the CPU, on the same seeded numpy inputs and weights (carried
with `utils/weights.py`; parameters perturbed off their init, BatchNorm
statistics random), in float32 within 1e-4 of each output's largest
|value| (PARITY.md:14):

  * `HRNetEncoder` + `HRNetMid` (w18 at 128², as tests/test_hrnet.py), and
    a training-mode forward's running-statistics update;
  * the whole `HandNet` with `hrnet_w18` and the MLP graph decoder;
  * the weights round trip: the port's state_dict through JAX's
    `convert_reference_hrnet` gives back the JAX parameters and statistics
    it came from, and the converter reads every non-decoder key;
  * where B2 runs: exactly JAX's `Conv3x3` sites, 216 a w32 forward.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderih_tpu.assets import make_synthetic_assets as jax_assets
from renderih_tpu.config import load_config as jax_load_config
from renderih_tpu.models import build_model as jax_build_model
from renderih_tpu.models import hrnet as jax_hrnet
from renderih_tpu.models import model_call_kwargs as jax_call_kwargs
from renderih_tpu.utils import checkpoint_convert
from renderih_tpu_torch.assets import make_synthetic_assets
from renderih_tpu_torch.config import load_config
from renderih_tpu_torch.models import build_model, hrnet, model_call_kwargs, resnet
from renderih_tpu_torch.utils import weights
from renderih_tpu_torch.utils.weights import state_dict_from_jax

SIZE = 128
SMALL = {
    "model": {"encoder": "hrnet_w18", "img_size": SIZE, "grid_size": 4,
              "gcn_in_dims": [64, 32, 16], "gcn_out_dims": [32, 16, 8],
              "img_dims": [32, 16, 8], "deconv_dims": [32, 32, 32, 32],
              "graph_layer_num": 2},
    "train": {"precision": "f32"},
}
OUTPUTS = ("verts3d", "verts2d", "scale", "trans2d")
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _random_variables(init, *args, seed: int):
    """Variables of the shapes `init(key, *args)` makes (traced, not run),
    drawn with numpy: kernels N(0, 1/fan_in), scales 1 + N(0, 0.05²),
    biases N(0, 0.05²), BatchNorm means N(0, 0.1²) and variances
    U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            a = rng.normal(0, np.prod(shape[:-1]) ** -0.5, shape)
        elif name == "var":
            a = rng.uniform(0.5, 1.5, shape)
        elif name == "mean":
            a = rng.normal(0, 0.1, shape)
        else:
            a = (name == "scale") + rng.normal(0, 0.05, shape)
        return a.astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    return variables["params"], variables["batch_stats"]


def _close(got: torch.Tensor, want, tol: float = TOL):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.fixture(scope="module")
def trunk():
    """JAX's HRNetEncoder + HRNetMid (w18), random variables, an image, and
    the port's modules loaded with the same weights."""
    img = np.random.default_rng(0).normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    jenc, jmid = jax_hrnet.HRNetEncoder("hrnet_w18"), jax_hrnet.HRNetMid()
    enc_params, enc_stats = _random_variables(jenc.init, img, seed=1)
    pyramid = jax.eval_shape(jenc.apply, {"params": enc_params, "batch_stats": enc_stats}, img)
    mid_params, mid_stats = _random_variables(jmid.init, pyramid, seed=2)
    params = {"encoder": enc_params, "mid": mid_params}
    stats = {"encoder": enc_stats, "mid": mid_stats}
    sd = {}
    weights._hrnet(params["encoder"], stats["encoder"], "encoder.hrnet", sd)
    weights._hrnet_mid(params["mid"], stats["mid"], "mid_model", sd)
    enc = hrnet.HRNetEncoder("hrnet_w18")
    mid = hrnet.HRNetMid(enc.hrnet.pyramid_dims)
    enc.load_state_dict({k[len("encoder."):]: v for k, v in sd.items()
                         if k.startswith("encoder.")})
    mid.load_state_dict({k[len("mid_model."):]: v for k, v in sd.items()
                         if k.startswith("mid_model.")})
    return dict(img=img, jenc=jenc, jmid=jmid, params=params, stats=stats, enc=enc, mid=mid)


def _jax_trunk(t, train: bool):
    """(pyramid, global feature, fmaps, new statistics or None)."""
    def run(params, stats, img):
        ev = {"params": params["encoder"], "batch_stats": stats["encoder"]}
        mv = {"params": params["mid"], "batch_stats": stats["mid"]}
        if not train:
            pyr = t["jenc"].apply(ev, img)
            return pyr, t["jmid"].apply(mv, pyr), None
        pyr, enc_new = t["jenc"].apply(ev, img, train=True, mutable=["batch_stats"])
        out, mid_new = t["jmid"].apply(mv, pyr, train=True, mutable=["batch_stats"])
        return pyr, out, {"encoder": enc_new["batch_stats"], "mid": mid_new["batch_stats"]}
    pyr, (gf, fmaps), new = jax.jit(run)(t["params"], t["stats"], jnp.asarray(t["img"]))
    return pyr, gf, fmaps, new


def test_hrnet_encoder_and_mid_match_jax(trunk):
    pyr, gf, fmaps, _ = _jax_trunk(trunk, train=False)
    with torch.no_grad():
        got = trunk["enc"].eval()(torch.from_numpy(trunk["img"]).permute(0, 3, 1, 2))
        got_gf, got_fmaps = trunk["mid"].eval()(got)
    assert [tuple(f.shape) for f in got] == [
        (2, 18 * 2**i, SIZE // 4 // 2**i, SIZE // 4 // 2**i) for i in (3, 2, 1, 0)]
    assert len(got_fmaps) == 4 and got_gf.shape == (2, 2048)
    for g, w in zip(got, pyr):
        _close(g.permute(0, 2, 3, 1), w)
    for g, w in zip(got_fmaps, fmaps):
        _close(g.permute(0, 2, 3, 1), w)
    _close(got_gf, gf)


def test_hrnet_running_statistics_match_jax(trunk):
    """A training-mode forward updates every BatchNorm's running mean and
    variance as flax does, within 1e-4 of each buffer's largest value. The
    activations are held in eval above: with batch statistics, a batch-2
    channel that a ReLU left nearly constant amplifies rounding through
    the 30-odd BatchNorms between the stem and stage 4 (the pyramid parts
    by 5.6e-5 to 1.1e-4, the projected maps by up to 6e-4 of their largest
    value, XLA against torch, at this draw), and the deepest statistics
    by up to 1.1e-5 (tests/test_torch_train.py holds the update itself to
    1e-5 on the ResNet)."""
    _, _, _, new_stats = _jax_trunk(trunk, train=True)
    enc, mid = copy.deepcopy(trunk["enc"]).train(), copy.deepcopy(trunk["mid"]).train()
    with torch.no_grad():
        mid(enc(torch.from_numpy(trunk["img"]).permute(0, 3, 1, 2)))
    got = {**enc.state_dict(prefix="encoder."), **mid.state_dict(prefix="mid_model.")}
    want = _stats_sd(trunk, new_stats)
    held = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(held) == 2 * sum(isinstance(m, torch.nn.BatchNorm2d)
                                for m in (*enc.modules(), *mid.modules()))
    for k in held:
        err = np.abs(got[k].numpy() - want[k].numpy()).max()
        assert err <= 1e-4 * np.abs(want[k].numpy()).max(), (k, err)


def _stats_sd(trunk, stats) -> dict:
    sd = {}
    weights._hrnet(trunk["params"]["encoder"], stats["encoder"], "encoder.hrnet", sd)
    weights._hrnet_mid(trunk["params"]["mid"], stats["mid"], "mid_model", sd)
    return sd


@pytest.fixture(scope="module")
def net():
    jcfg = jax_load_config(overrides=SMALL)
    jassets = jax_assets(0)
    jmodel = jax_build_model(jcfg, jassets)
    params, stats = _random_variables(
        lambda key, x: jmodel.init(key, x, train=False, **jax_call_kwargs(jcfg, jassets)),
        jnp.zeros((1, SIZE, SIZE, 3)), seed=3)
    params["decoder"]["upsample_weight"] = np.asarray(jassets.left.upsample_init)
    assets = make_synthetic_assets(0)
    sd = state_dict_from_jax(params, stats)
    model = build_model(load_config(overrides=SMALL), assets)
    model.load_state_dict(sd, strict=True)
    return dict(jcfg=jcfg, jassets=jassets, jmodel=jmodel, params=params, stats=stats,
                assets=assets, model=model.eval())


def test_handnet_hrnet_matches_jax(net):
    img = np.random.default_rng(4).normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    jout = jax.jit(lambda v, x: net["jmodel"].apply(
        v, x, train=False, **jax_call_kwargs(net["jcfg"], net["jassets"])))(
            {"params": net["params"], "batch_stats": net["stats"]}, jnp.asarray(img))
    with torch.no_grad():
        out = net["model"](torch.from_numpy(img), **model_call_kwargs(net["assets"]))
    for key in OUTPUTS:
        for hand in ("left", "right"):
            _close(getattr(out, key)[hand], getattr(jout, key)[hand])


def test_weights_round_trip_through_jax_converter(net):
    """The port's state_dict -> `convert_reference_hrnet` -> the JAX
    encoder and mid variables it came from, bit for bit; the converter
    reads every non-decoder key of the port's state_dict but the
    `num_batches_tracked` counters, and nothing else."""
    read = set()

    class Tracked(dict):
        def __getitem__(self, key):
            read.add(key)
            return super().__getitem__(key)

    sd = Tracked((k, v.numpy()) for k, v in net["model"].state_dict().items())
    params, stats = checkpoint_convert.convert_reference_hrnet(sd)
    for got, want in ((params, {k: net["params"][k] for k in ("encoder", "mid")}),
                      (stats, net["stats"])):
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
        for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(np.asarray(g), w)
    assert read == {k for k in sd if not k.startswith("decoder.")
                    and not k.endswith("num_batches_tracked")}


def test_b2_runs_at_jax_conv3x3_sites(monkeypatch):
    """B2 (`conv3x3_same`) runs exactly where the JAX package's `Conv3x3`
    does (the 3x3 `conv1`/`conv2` of its blocks): 216 calls a hrnet_w32
    forward (layer1 4, stage 2 16, stage 3 96, stage 4 96, the mid head's
    incre Bottlenecks 4), at 32, 64, 128 and 256 channels."""
    calls = []
    real = resnet.conv3x3_same
    monkeypatch.setattr(resnet, "conv3x3_same",
                        lambda x, w: calls.append(tuple(w.shape[2:])) or real(x, w))
    enc = hrnet.HRNetEncoder("hrnet_w32").eval()
    mid = hrnet.HRNetMid(enc.hrnet.pyramid_dims).eval()
    with torch.no_grad():
        mid(enc(torch.zeros(1, 3, 64, 64)))
    assert len(calls) == 216
    assert sorted(set(calls)) == [(32, 32), (64, 64), (128, 128), (256, 256)]

    jenc, jmid = jax_hrnet.HRNetEncoder("hrnet_w32"), jax_hrnet.HRNetMid()
    img = jnp.zeros((1, 64, 64, 3))
    enc_vars = jax.eval_shape(jenc.init, jax.random.PRNGKey(0), img)
    pyr = jax.eval_shape(lambda v: jenc.apply(v, img), enc_vars)
    mid_vars = jax.eval_shape(jmid.init, jax.random.PRNGKey(0), pyr)

    def n_conv3x3(tree: dict) -> int:
        return sum(n_conv3x3(sub) if "kernel" not in sub
                   else int(name in ("conv1", "conv2") and sub["kernel"].shape[:2] == (3, 3))
                   for name, sub in tree.items() if isinstance(sub, dict))

    assert n_conv3x3(enc_vars["params"]) + n_conv3x3(mid_vars["params"]) == 216
