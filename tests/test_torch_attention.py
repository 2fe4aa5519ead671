"""The port's attention blocks (SelfAttn, InterAttn, ImgEx) against the JAX
package, eval mode, f32, same weights, on the CPU (plain attention path)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderih_tpu.models import attention as jatt
from renderih_tpu_torch.models import attention
from renderih_tpu_torch.utils import weights

ATOL = 2e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port(module, params, convert):
    """Load flax `params` into the port `module` through `convert`."""
    sd = {}
    convert(jax.tree_util.tree_map(np.asarray, params), "m", sd)
    module.load_state_dict({k[2:]: v for k, v in sd.items()})
    return module.eval()


def _inputs(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def test_self_attn_matches_jax():
    (x,) = _inputs((2, 61, 32))
    jm = jatt.SelfAttn(32, 4, 48, 0.1)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = jm.apply({"params": params}, jnp.asarray(x))
    port = _port(attention.SelfAttn(32, 4, 48, 0.1), params, weights._self_attn)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_inter_attn_matches_jax():
    lf, rf = _inputs((2, 61, 32), (2, 61, 32), seed=1)
    jm = jatt.InterAttn(32, 4, 0.1)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(lf), jnp.asarray(rf))["params"]
    want_l, want_r = jm.apply({"params": params}, jnp.asarray(lf), jnp.asarray(rf))
    port = _port(attention.InterAttn(32, 4, 0.1), params, weights._inter_attn)
    with torch.no_grad():
        got_l, got_r = port(torch.from_numpy(lf), torch.from_numpy(rf))
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=ATOL)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), atol=ATOL)


def test_img_ex_matches_jax():
    img, verts = _inputs((2, 8, 8, 24), (2, 61, 32), seed=2)
    jm = jatt.ImgEx(img_size=8, grid_size=4, grid_f_dim=16, verts_f_dim=32,
                    n_heads=4, dropout=0.1)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(img),
                     jnp.asarray(verts))["params"]
    want = jm.apply({"params": params}, jnp.asarray(img), jnp.asarray(verts))
    port = _port(attention.ImgEx(8, 4, 24, 16, 32, 4, 0.1), params,
                 weights._img_ex)
    with torch.no_grad():
        got = port(torch.from_numpy(img).permute(0, 3, 1, 2),
                   torch.from_numpy(verts))
    assert got.shape == (2, 61, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_training_mode_uses_dropout():
    """In training the attention core takes the plain version with dropout;
    in eval the same module is deterministic."""
    torch.manual_seed(0)
    m = attention.SelfAttn(32, 4, 32, 0.5)
    x = torch.randn(2, 9, 32)
    with torch.no_grad():
        m.eval()
        a, b = m(x), m(x)
        m.train()
        c = m(x)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, c)
