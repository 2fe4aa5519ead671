"""The port's kernel wrappers on the CPU: their plain versions against the
JAX package's Pallas kernels (interpret mode) and XLA references, and the
dispatch rule (CPU tensors take the plain version, other devices raise,
only a kernel launch counts). The CUDA kernels themselves are tested on
the card in `test_torch_cuda.py`."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderih_tpu.kernels.conv_pallas import _pallas_conv3x3, _xla_conv3x3
from renderih_tpu.kernels.fused_attention import fused_mha as jax_fused_mha
from renderih_tpu_torch.kernels import _build, conv3x3, fused_attention


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


@pytest.mark.parametrize("d", [8, 16, 32, 64, 96, 128])
@pytest.mark.parametrize("n,m", [(61, 61), (63, 127)])
def test_mha_plain_matches_pallas(n, m, d):
    """The plain version the card's kernel is held to, against the Pallas
    kernel (interpret mode) at every head dim the kernel takes."""
    rng = np.random.default_rng(1)
    b, h = 2, 4
    q = rng.normal(size=(b, n, h, d)).astype(np.float32)
    k = rng.normal(size=(b, m, h, d)).astype(np.float32)
    v = rng.normal(size=(b, m, h, d)).astype(np.float32)
    got = fused_attention.fused_mha(*(torch.from_numpy(a) for a in (q, k, v)))
    want = np.asarray(jax_fused_mha(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), interpret=True))
    assert got.shape == (b, n, h * d)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


# The f32 route's arithmetic (csrc/fused_attention.cu), modelled on the CPU:
# why both products are split three ways.

MHA_TOL = (1e-4, 1e-4)  # atol, rtol: chip_smoke.MHA_TOL, kernel against plain version
# (N = M, D) of every attention core of the flagship decoder on the synthetic
# assets, where chip_smoke.py holds the kernel to MHA_TOL
FLAGSHIP_MHA = [(64, 64), (125, 64), (61, 64), (64, 32), (186, 32), (122, 32),
                (64, 16), (308, 16), (244, 16)]


def _tf32(x, nearest=True):
    """float32 rounded to TF32 (10 mantissa bits) by bit operations on the
    int32 view: to nearest with ties away from zero, as the kernel rounds
    hi, or truncated, as the tensor core reads an operand (the kernel's lo)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + (0x1000 if nearest else 0)) & -0x2000).view(torch.float32)


def _tf32_product(eq, a, b, passes):
    """einsum(eq, a, b) on TF32 operands with float32 sums: one pass (hi.hi)
    or 3xTF32 (lo.hi + hi.lo + hi.hi, each operand split x = hi + lo with
    hi = tf32(x) to nearest and lo = tf32(x - hi) truncated)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    out = torch.einsum(eq, a_hi, b_hi)
    if passes == 3:
        a_lo, b_lo = _tf32(a - a_hi, nearest=False), _tf32(b - b_hi, nearest=False)
        out = torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo) + out
    return out


def _mha_tf32_model(q, k, v, passes, chunk=64):
    """The kernel's f32 route: both products through `_tf32_product`, an
    online softmax over 64-key chunks, p = 2^(s c - m c), c = log2(e)/sqrt(D)."""
    b, n, h, d = q.shape
    c = math.log2(math.e) / math.sqrt(d)
    m_run = torch.full((b, h, n, 1), -math.inf)
    l_run = torch.zeros((b, h, n, 1))
    o = torch.zeros((b, h, n, d))
    for j in range(0, k.shape[1], chunk):
        s = _tf32_product("bnhd,bmhd->bhnm", q, k[:, j:j + chunk], passes)
        m_new = torch.maximum(m_run, s.amax(-1, keepdim=True))
        corr = torch.exp2((m_run - m_new) * c)
        p = torch.exp2(s * c - m_new * c)
        l_run = l_run * corr + p.sum(-1, keepdim=True)
        o = o * corr + _tf32_product("bhnm,bmhd->bhnd", p, v[:, j:j + chunk], passes)
        m_run = m_new
    return (o / l_run).permute(0, 2, 1, 3).reshape(b, n, h * d)


def _qkv(n, d, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(2, n, 4, d)).astype(np.float32))
            for _ in range(3))


@pytest.mark.parametrize("n,d", FLAGSHIP_MHA)
def test_mha_3xtf32_model_is_within_the_f32_tolerance(n, d):
    q, k, v = _qkv(n, d, seed=n * d)
    got = _mha_tf32_model(q, k, v, passes=3)
    torch.testing.assert_close(got, fused_attention.mha_reference(q, k, v),
                               atol=MHA_TOL[0], rtol=MHA_TOL[1])


def test_mha_one_pass_tf32_model_is_outside_the_f32_tolerance():
    """One-pass TF32 misses the tolerance where 3xTF32 meets it with room
    to spare: why the kernel splits both products."""
    q, k, v = _qkv(61, 64, seed=61 * 64)
    want = fused_attention.mha_reference(q, k, v)
    limit = MHA_TOL[0] + MHA_TOL[1] * want.abs()
    err1 = (_mha_tf32_model(q, k, v, passes=1) - want).abs()
    err3 = (_mha_tf32_model(q, k, v, passes=3) - want).abs()
    assert (err1 > limit).any()
    assert float(err3.max()) < 1e-5 < float(err1.max())


def test_tf32_rounding_keeps_ten_mantissa_bits_to_nearest():
    x = torch.tensor([1 + 2**-10, 1 + 2**-11, 1 + 3 * 2**-12, -(1 + 3 * 2**-12), 1 + 2**-12],
                     dtype=torch.float32)
    want = torch.tensor([1 + 2**-10, 1 + 2**-10, 1 + 2**-10, -(1 + 2**-10), 1.0])
    assert torch.equal(_tf32(x), want)
    assert torch.equal(_tf32(x, nearest=False), torch.tensor([1 + 2**-10, 1, 1, -1, 1]))
    y = torch.randn(1000)
    hi = _tf32(y)
    assert torch.equal(_tf32(hi), hi) and ((y - hi).abs() <= hi.abs() * 2**-11).all()


def test_flagship_attention_shapes_are_the_modelled_ones():
    """FLAGSHIP_MHA is every (N, D) at which chip_smoke.py measures B1."""
    import chip_smoke
    from renderih_tpu_torch.assets import make_synthetic_assets
    from renderih_tpu_torch.config import Config

    shapes = chip_smoke.shape_counts(Config(), make_synthetic_assets(0), "fused_mha")
    assert all(n == m and heads == 4 for n, m, heads, _ in shapes)
    assert sorted((n, d) for n, _, _, d in shapes) == sorted(FLAGSHIP_MHA)


def test_cpu_calls_take_the_plain_version_and_count_nothing():
    x = torch.randn(1, 6, 6, 8)
    w = torch.randn(3, 3, 8, 4)
    q = torch.randn(1, 5, 2, 16)
    n_conv, n_mha = conv3x3.launches.value, fused_attention.launches.value
    routes = {name: c.value for name, c in conv3x3.routes.items()}
    torch.testing.assert_close(conv3x3.conv3x3_same(x, w),
                               conv3x3.conv3x3_reference(x, w), rtol=0, atol=0)
    torch.testing.assert_close(fused_attention.fused_mha(q, q, q),
                               fused_attention.mha_reference(q, q, q),
                               rtol=0, atol=0)
    assert conv3x3.launches.value == n_conv
    assert {name: c.value for name, c in conv3x3.routes.items()} == routes
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


def test_library_hash_covers_headers(tmp_path, monkeypatch):
    """A library's name changes with every `csrc/*.cuh`, so an edited
    header never loads a stale build."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in _build.CSRC.glob("*.cu"):
        (csrc / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    bare = _build.library_path("conv3x3")
    header = csrc / "hopper.cuh"
    header.write_text("#pragma once\n")
    with_header = _build.library_path("conv3x3")
    header.write_text("#pragma once\n// edited\n")
    edited = _build.library_path("conv3x3")
    assert len({bare, with_header, edited}) == 3
    assert edited == _build.library_path("conv3x3")  # deterministic
    assert edited.parent == _build.BUILD_DIR and edited.name.startswith("libconv3x3-")
