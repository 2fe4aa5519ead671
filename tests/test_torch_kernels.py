"""The port's kernel wrappers on the CPU: their plain versions against the
JAX package's Pallas kernels (interpret mode) and XLA references, and the
dispatch rule (CPU tensors take the plain version, other devices raise,
only a kernel launch counts). The CUDA kernels themselves are tested on
the card in `test_torch_cuda.py`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderih_tpu.kernels.conv_pallas import _pallas_conv3x3, _xla_conv3x3
from renderih_tpu.kernels.fused_attention import fused_mha as jax_fused_mha
from renderih_tpu_torch.kernels import conv3x3, fused_attention


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("shape", [(2, 8, 8, 32, 32), (1, 16, 16, 64, 64)])
def test_conv3x3_plain_matches_pallas_and_xla(shape):
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(0)
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    k = (rng.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    got = conv3x3.conv3x3_same(torch.from_numpy(x), torch.from_numpy(k)).numpy()
    pallas = np.asarray(_pallas_conv3x3(jnp.asarray(x), jnp.asarray(k),
                                        interpret=True))
    xla = np.asarray(_xla_conv3x3(jnp.asarray(x), jnp.asarray(k)))
    assert got.shape == (b, h, w, cout)
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, xla, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("n,m", [(61, 61), (63, 127)])
def test_mha_plain_matches_pallas(n, m):
    rng = np.random.default_rng(1)
    b, h, d = 2, 4, 16
    q = rng.normal(size=(b, n, h, d)).astype(np.float32)
    k = rng.normal(size=(b, m, h, d)).astype(np.float32)
    v = rng.normal(size=(b, m, h, d)).astype(np.float32)
    got = fused_attention.fused_mha(*(torch.from_numpy(a) for a in (q, k, v)))
    want = np.asarray(jax_fused_mha(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), interpret=True))
    assert got.shape == (b, n, h * d)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_cpu_calls_take_the_plain_version_and_count_nothing():
    x = torch.randn(1, 6, 6, 8)
    w = torch.randn(3, 3, 8, 4)
    q = torch.randn(1, 5, 2, 16)
    n_conv, n_mha = conv3x3.launches.value, fused_attention.launches.value
    torch.testing.assert_close(conv3x3.conv3x3_same(x, w),
                               conv3x3.conv3x3_reference(x, w), rtol=0, atol=0)
    torch.testing.assert_close(fused_attention.fused_mha(q, q, q),
                               fused_attention.mha_reference(q, q, q),
                               rtol=0, atol=0)
    assert conv3x3.launches.value == n_conv
    assert fused_attention.launches.value == n_mha


def test_other_devices_raise_instead_of_falling_back():
    x = torch.empty(1, 6, 6, 8, device="meta")
    w = torch.empty(3, 3, 8, 4, device="meta")
    q = torch.empty(1, 5, 2, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        conv3x3.conv3x3_same(x, w)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_attention.fused_mha(q, q, q)


def test_mha_training_dropout_is_plain_and_random():
    """Training runs the plain version with attention dropout (the kernel
    has none); p=0 equals the eval result."""
    q = torch.randn(2, 7, 4, 8)
    ref = fused_attention.mha_reference(q, q, q)
    torch.testing.assert_close(
        fused_attention.mha_reference(q, q, q, 0.0, training=True), ref)
    torch.manual_seed(0)
    dropped = fused_attention.mha_reference(q, q, q, 0.5, training=True)
    assert not torch.allclose(dropped, ref)
