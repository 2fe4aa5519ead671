"""The port's auxiliary networks, focal/dice losses and domain adaptation
against the JAX package on the CPU: the same numpy-seeded inputs, the JAX
modules' initialised parameters carried across (`utils/weights.py`),
max|Δ| ≤ 1e-4 in f32. The port's maps are NCHW, the JAX modules' NHWC."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderih_tpu.losses import adapt as jax_adapt
from renderih_tpu.losses import focal as jax_focal
from renderih_tpu.models import aux_nets as jax_aux
from renderih_tpu_torch.losses import adapt, focal
from renderih_tpu_torch.models import aux_nets
from renderih_tpu_torch.utils.weights import aux_net_state_dict_from_jax, flax_module_state_dict

TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _init(module, *args):
    """Parameters as numpy, zero-initialised leaves drawn at random."""
    params = module.init(jax.random.PRNGKey(0), *args)["params"]
    rng = np.random.default_rng(7)
    return jax.tree_util.tree_map(
        lambda a: (rng.normal(0.0, 0.1, a.shape).astype(np.float32) if not np.any(a)
                   else np.asarray(a)), params)


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _close(got: torch.Tensor, want, nhwc: bool = False):
    got = got.detach()
    if nhwc:
        got = got.permute(0, 2, 3, 1)
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max()
    tol = TOL * max(1.0, float(np.abs(want).max()))
    assert err <= tol, f"max|Δ| {err:.3e} > {tol:.3e}"


def test_fpn_matches_jax():
    rng = np.random.default_rng(0)
    pyramid = [rng.normal(size=(2, s, s, c)).astype(np.float32)
               for s, c in ((4, 24), (8, 16), (16, 8))]
    jmod = jax_aux.FPN(out_dim=12)
    params = _init(jmod, [jnp.asarray(p) for p in pyramid])
    mod = aux_nets.FPN((24, 16, 8), 12)
    mod.load_state_dict(aux_net_state_dict_from_jax(params))
    want = jmod.apply({"params": params}, [jnp.asarray(p) for p in pyramid])
    with torch.no_grad():
        got = mod([_nchw(p) for p in pyramid])
    for g, w in zip(got, want):
        _close(g, w, nhwc=True)


def test_cbam_matches_jax():
    x = np.random.default_rng(1).normal(size=(2, 6, 5, 32)).astype(np.float32)
    jmod = jax_aux.CBAM(reduction=8)
    params = _init(jmod, jnp.asarray(x))
    mod = aux_nets.CBAM(32, reduction=8)
    mod.load_state_dict(aux_net_state_dict_from_jax(params))
    with torch.no_grad():
        got = mod(_nchw(x))
    _close(got, jmod.apply({"params": params}, jnp.asarray(x)), nhwc=True)


@pytest.mark.parametrize("depth", [1, 2])
def test_hourglass_head_matches_jax(depth):
    x = np.random.default_rng(2).normal(size=(2, 8, 8, 12)).astype(np.float32)
    jmod = jax_aux.HourglassHead(num_joints=5, width=16, depth=depth)
    params = _init(jmod, jnp.asarray(x))
    mod = aux_nets.HourglassHead(12, num_joints=5, width=16, depth=depth)
    mod.load_state_dict(aux_net_state_dict_from_jax(params))
    with torch.no_grad():
        got = mod(_nchw(x))
    assert got.shape == (2, 5, 8, 8)
    _close(got, jmod.apply({"params": params}, jnp.asarray(x)), nhwc=True)


def test_cross_hand_injection_matches_jax():
    rng = np.random.default_rng(3)
    a, b = (rng.normal(size=(2, 4, 6, 16)).astype(np.float32) for _ in range(2))
    jmod = jax_aux.CrossHandInjection(dim=24, n_heads=4)
    params = _init(jmod, jnp.asarray(a), jnp.asarray(b))
    mod = aux_nets.CrossHandInjection(16, 24, n_heads=4)
    mod.load_state_dict(aux_net_state_dict_from_jax(params))
    with torch.no_grad():
        got = mod(_nchw(a), _nchw(b))
    _close(got, jmod.apply({"params": params}, jnp.asarray(a), jnp.asarray(b)), nhwc=True)


def test_pose_discriminator_matches_jax():
    rot = np.random.default_rng(4).normal(size=(5, 15, 3, 3)).astype(np.float32)
    jmod = jax_aux.PoseDiscriminator()
    params = _init(jmod, jnp.asarray(rot))
    mod = aux_nets.PoseDiscriminator()
    mod.load_state_dict(aux_net_state_dict_from_jax(params))
    with torch.no_grad():
        got = mod(torch.from_numpy(rot))
    for g, w in zip(got, jmod.apply({"params": params}, jnp.asarray(rot))):
        _close(g, w)


@pytest.mark.parametrize("gamma,alpha", [(2.0, 0.25), (0.5, 0.75)])
def test_sigmoid_focal_loss_and_its_gradient_match_jax(gamma, alpha):
    rng = np.random.default_rng(5)
    logits = (rng.normal(size=(3, 16, 16)) * 4).astype(np.float32)
    targets = (rng.uniform(size=(3, 16, 16)) > 0.7).astype(np.float32)
    want, jgrad = jax.value_and_grad(
        lambda z: jax_focal.sigmoid_focal_loss(z, jnp.asarray(targets), gamma, alpha))(
        jnp.asarray(logits))
    z = torch.from_numpy(logits).requires_grad_(True)
    got = focal.sigmoid_focal_loss(z, torch.from_numpy(targets), gamma, alpha)
    got.backward()
    _close(got, want)
    _close(z.grad, jgrad)


def test_dice_loss_and_its_gradient_match_jax():
    rng = np.random.default_rng(6)
    pred = rng.uniform(size=(4, 2, 12, 12)).astype(np.float32)
    target = (rng.uniform(size=(4, 2, 12, 12)) > 0.5).astype(np.float32)
    want, jgrad = jax.value_and_grad(
        lambda p: jax_focal.dice_loss(p, jnp.asarray(target)))(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_(True)
    got = focal.dice_loss(p, torch.from_numpy(target))
    got.backward()
    _close(got, want)
    _close(p.grad, jgrad)


@pytest.mark.parametrize("lam", [1.0, 0.3])
def test_gradient_reversal_matches_jax(lam):
    x = np.random.default_rng(7).normal(size=(4, 6)).astype(np.float32)
    w = np.random.default_rng(8).normal(size=(4, 6)).astype(np.float32)
    f = lambda t: jnp.sum(jnp.asarray(w) * jax_adapt.gradient_reversal(t, lam) ** 2)
    want, jgrad = jax.value_and_grad(f)(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    out = adapt.gradient_reversal(t, lam)
    torch.testing.assert_close(out, t, rtol=0, atol=0)  # the identity forward
    got = torch.sum(torch.from_numpy(w) * out ** 2)
    got.backward()
    _close(got, want)
    _close(t.grad, jgrad)
    np.testing.assert_allclose(t.grad.numpy(), -lam * 2 * w * x, rtol=1e-6)


def test_domain_adaptation_loss_and_gradients_match_jax():
    """The loss, the discriminator's gradient (trained toward telling the
    domains apart) and the features' gradient (reversed) against JAX."""
    rng = np.random.default_rng(9)
    src, tgt = (rng.normal(size=(n, 32)).astype(np.float32) for n in (3, 5))
    jdisc = jax_adapt.DomainDiscriminator(hidden=16)
    params = _init(jdisc, jnp.zeros((1, 32)))
    lam = 0.5
    want, (jg_params, jg_src) = jax.value_and_grad(
        lambda p, s: jax_adapt.domain_adaptation_loss(jdisc, p, s, jnp.asarray(tgt), lam),
        argnums=(0, 1))(params, jnp.asarray(src))
    disc = adapt.DomainDiscriminator(32, hidden=16)
    disc.load_state_dict(flax_module_state_dict(params))
    s = torch.from_numpy(src).requires_grad_(True)
    got = adapt.domain_adaptation_loss(disc, s, torch.from_numpy(tgt), lam)
    got.backward()
    _close(got, want)
    _close(s.grad, jg_src)
    jg = flax_module_state_dict(jax.tree_util.tree_map(np.asarray, jg_params))
    for name, p in disc.named_parameters():
        _close(p.grad, jg[name].numpy())
