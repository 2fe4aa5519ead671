"""The port's KTD head and experimental cross-hand attention against the
JAX package on the CPU: the same numpy-seeded inputs, the JAX modules'
initialised parameters carried across (`utils/weights.py`), max|Δ| ≤ 1e-4
in f32 (JAX at `highest` matmul precision, tests/conftest.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderih_tpu.assets import make_synthetic_assets as jax_assets
from renderih_tpu.models import experimental_attn as jax_exp
from renderih_tpu.models import ktd as jax_ktd
from renderih_tpu_torch.assets import make_synthetic_assets
from renderih_tpu_torch.models import experimental_attn, ktd
from renderih_tpu_torch.utils.weights import flax_module_state_dict, ktd_state_dict_from_jax

TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _init(module, *args):
    """The JAX module's parameters, numpy, with every zero-initialised
    leaf (biases, positions) drawn at random so that each one matters."""
    params = module.init(jax.random.PRNGKey(0), *(jnp.asarray(a) for a in args))["params"]
    rng = np.random.default_rng(7)
    return jax.tree_util.tree_map(
        lambda a: (rng.normal(0.0, 0.1, a.shape).astype(np.float32) if not np.any(a)
                   else np.asarray(a)), params)


def _apply(module, params, *args):
    return module.apply({"params": params}, *(jnp.asarray(a) for a in args))


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    err = np.abs(got - np.asarray(want)).max()
    assert err <= tol, f"max|Δ| {err:.3e} > {tol:g}"


def test_ktd_head_and_mano_outputs_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 64)).astype(np.float32)
    jhead = jax_ktd.KTDHead(hidden_dim=48)
    params = _init(jhead, x)
    # scale the chain's near-zero weights up so the 6D poses are far from 0
    params = {k: ({"kernel": v["kernel"] * 300.0, "bias": v["bias"]}
                  if k.startswith(("joint_reg", "decshape", "deccam")) else v)
              for k, v in params.items()}
    head = ktd.KTDHead(64, hidden_dim=48)
    head.load_state_dict(ktd_state_dict_from_jax(params))
    jpose, jshape, jcam = _apply(jhead, params, x)
    with torch.no_grad():
        pose, shape, cam = head.eval()(torch.from_numpy(x))
    assert pose.shape == (3, 96) and float(pose.abs().max()) > 0.1
    for got, want in ((pose, jpose), (shape, jshape), (cam, jcam)):
        _close(got, want)
    ours = ktd.ktd_mano_outputs(make_synthetic_assets(0).right.mano, pose, shape, cam)
    theirs = jax_ktd.ktd_mano_outputs(jax_assets(0).right.mano, jpose, jshape, jcam)
    assert set(ours) == set(theirs)
    for key in ours:
        tol = TOL * max(1.0, float(np.abs(np.asarray(theirs[key])).max()))
        _close(ours[key], theirs[key], tol)
    assert ktd.HAND_ANCESTORS == jax_ktd.HAND_ANCESTORS


def test_ktd_head_init_is_flax_small():
    head = ktd.KTDHead(64, hidden_dim=48)
    bound = (3e-4 / ((48 + 6) / 2)) ** 0.5
    assert float(head.joint_reg[0].weight.detach().abs().max()) <= bound
    assert not head.joint_reg[5].bias.any()


@pytest.mark.parametrize("b,v,f,h", [(2, 12, 16, 8), (1, 9, 24, 4)])
def test_point_attn_matches_jax(b, v, f, h):
    rng = np.random.default_rng(1)
    lf, rf, lp, rp = (rng.normal(size=(b, v, f)).astype(np.float32) for _ in range(4))
    jmod = jax_exp.PointAttn(f, n_heads=h)
    params = _init(jmod, lf, rf, lp, rp)
    mod = experimental_attn.PointAttn(f, h)
    mod.load_state_dict(flax_module_state_dict(params))
    with torch.no_grad():
        got = mod.eval()(*(torch.from_numpy(a) for a in (lf, rf, lp, rp)))
    _close(got, _apply(jmod, params, lf, rf, lp, rp))


def test_inter_point_matches_jax():
    """8 heads at width 64: the `SelfAttn` cores at D = 8 (B1's new head
    dim on the card; its plain version here)."""
    rng = np.random.default_rng(2)
    lf, rf = (rng.normal(size=(2, 16, 64)).astype(np.float32) for _ in range(2))
    jmod = jax_exp.InterPoint(64, 16)
    params = _init(jmod, lf, rf)
    mod = experimental_attn.InterPoint(64, 16)
    mod.load_state_dict(flax_module_state_dict(params))
    with torch.no_grad():
        got = mod.eval()(torch.from_numpy(lf), torch.from_numpy(rf))
    want = _apply(jmod, params, lf, rf)
    for g, w in zip(got, want):
        _close(g, w)


def test_linear_cross_attention_matches_jax():
    rng = np.random.default_rng(3)
    lf, rf = (rng.normal(size=(3, 20, 32)).astype(np.float32) for _ in range(2))
    jmod = jax_exp.LinearCrossAttention(32)
    params = _init(jmod, lf, rf)
    mod = experimental_attn.LinearCrossAttention(32)
    mod.load_state_dict(flax_module_state_dict(params))
    with torch.no_grad():
        got = mod.eval()(torch.from_numpy(lf), torch.from_numpy(rf))
    want = _apply(jmod, params, lf, rf)
    for g, w in zip(got, want):
        _close(g, w)


def test_point_attn_gradient_matches_jax():
    """The pairwise block's backward (training runs it under autograd)."""
    rng = np.random.default_rng(4)
    lf, rf, lp, rp = (rng.normal(size=(2, 10, 16)).astype(np.float32) for _ in range(4))
    jmod = jax_exp.PointAttn(16, n_heads=4)
    params = _init(jmod, lf, rf, lp, rp)
    jgrad = jax.grad(lambda x: jnp.sum(jmod.apply({"params": params}, x, jnp.asarray(rf),
                                                  jnp.asarray(lp), jnp.asarray(rp)) ** 2))(
        jnp.asarray(lf))
    mod = experimental_attn.PointAttn(16, 4)
    mod.load_state_dict(flax_module_state_dict(params))
    x = torch.from_numpy(lf).requires_grad_(True)
    (mod.eval()(x, *(torch.from_numpy(a) for a in (rf, lp, rp))) ** 2).sum().backward()
    _close(x.grad, jgrad, TOL * max(1.0, float(np.abs(np.asarray(jgrad)).max())))
