"""The port's SDF ops against the JAX package on the CPU: the geometry
primitives, the plain version of kernel B3 (`sdf_grid_reference`, what
`sdf_grid` runs on a CPU tensor) against XLA `sdf_grid` and the Pallas
kernel in interpret mode, the trilinear sample and the penetration loss.

Tolerances: phi atol 1e-5 (float32 distances of a ~10 cm mesh; both sides
do the same arithmetic, measured agreement is ~2e-8) and inside masks
identical voxel for voxel. JAX `sdf_grid` reshapes the grid into blocks
of `block` voxels, so at G=24 (13824 voxels) it is called with block=512:
its default of 1024 raises there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderih_tpu.kernels.sdf_pallas import sdf_grid_pallas
from renderih_tpu.ops import sdf as jax_sdf
from renderih_tpu_torch.kernels import sdf as sdf_kernel
from renderih_tpu_torch.mano.layer import mano_forward
from renderih_tpu_torch.mano.params import make_synthetic_mano
from renderih_tpu_torch.ops import sdf
from renderih_tpu_torch.ops.rotation import rodrigues

CUBE_V = np.array([
    [-0.5, -0.5, -0.5], [0.5, -0.5, -0.5], [0.5, 0.5, -0.5], [-0.5, 0.5, -0.5],
    [-0.5, -0.5, 0.5], [0.5, -0.5, 0.5], [0.5, 0.5, 0.5], [-0.5, 0.5, 0.5],
], np.float32)
CUBE_F = np.array([
    [0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
    [2, 3, 7], [2, 7, 6], [1, 2, 6], [1, 6, 5], [0, 4, 7], [0, 7, 3],
], np.int64)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def hand():
    """The synthetic left hand posed by `mano_forward` at a seeded pose."""
    model = make_synthetic_mano(0, is_right=False)
    rng = np.random.default_rng(0)
    pose = torch.from_numpy(rng.normal(0, 0.4, (1, 45)).astype(np.float32))
    root = torch.from_numpy(rng.normal(0, 0.8, (1, 3)).astype(np.float32))
    v, _ = mano_forward(model, rodrigues(root), pose, torch.zeros(1, 10),
                        center_idx=None, use_pca=False)
    return v[0].numpy(), model.faces.numpy()


def _mesh(name, hand):
    return (CUBE_V, CUBE_F) if name == "cube" else hand


def test_point_triangle_distance_matches_jax():
    rng = np.random.default_rng(1)
    tri = rng.normal(size=(40, 3, 3)).astype(np.float32)
    tri[0, 2] = tri[0, 1]  # a degenerate triangle: the 1e-12 clamps
    p = rng.normal(scale=1.5, size=(64, 3)).astype(np.float32)
    got = sdf.point_triangle_distance_sq(torch.from_numpy(p)[:, None], torch.from_numpy(tri)[None])
    want = jax_sdf.point_triangle_distance_sq(jnp.asarray(p)[:, None], jnp.asarray(tri)[None])
    assert got.shape == (64, 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_ray_crossings_match_jax(hand):
    v, f = hand
    tri = v[f]
    rng = np.random.default_rng(2)
    p = (v.mean(0) + rng.normal(scale=0.06, size=(300, 3))).astype(np.float32)
    got = sdf.ray_crossings_x(torch.from_numpy(p), torch.from_numpy(tri))
    want = np.asarray(jax_sdf.ray_crossings_x(jnp.asarray(p), jnp.asarray(tri)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < (want % 2).sum() < 300  # points both inside and outside


@pytest.mark.parametrize("mesh", ["cube", "hand"])
@pytest.mark.parametrize("g", [8, 16, 24])
def test_sdf_grid_plain_matches_jax(hand, mesh, g):
    v, f = _mesh(mesh, hand)
    phi, bmin, scale = sdf.sdf_grid(torch.from_numpy(v), torch.from_numpy(f), g)
    jphi, jbmin, jscale = jax_sdf.sdf_grid(jnp.asarray(v), jnp.asarray(f, jnp.int32),
                                           grid_size=g, block=512)
    jphi = np.asarray(jphi)
    assert phi.shape == (g, g, g) and phi.dtype == torch.float32
    np.testing.assert_array_equal(phi.numpy() > 0, jphi > 0)
    np.testing.assert_allclose(phi.numpy(), jphi, atol=1e-5)
    np.testing.assert_array_equal(bmin.numpy(), np.asarray(jbmin))
    assert float(scale) == float(jscale)
    assert (jphi > 0).any() and (mesh == "cube" or (jphi == 0).any())


def test_sdf_grid_plain_matches_pallas_interpret():
    phi, _, _ = sdf.sdf_grid(torch.from_numpy(CUBE_V), torch.from_numpy(CUBE_F), 8)
    want, _, _ = sdf_grid_pallas(jnp.asarray(CUBE_V), jnp.asarray(CUBE_F, jnp.int32),
                                 grid_size=8, interpret=True)
    np.testing.assert_array_equal(phi.numpy() > 0, np.asarray(want) > 0)
    np.testing.assert_allclose(phi.numpy(), np.asarray(want), atol=1e-5)


def test_sdf_grid_ragged_last_block_and_int32_faces(hand):
    v, f = hand
    full = sdf.sdf_grid(torch.from_numpy(v), torch.from_numpy(f), 10)[0]
    ragged = sdf_kernel.sdf_grid_reference(torch.from_numpy(v),
                                           torch.from_numpy(f.astype(np.int32)), 10, block=96)[0]
    torch.testing.assert_close(ragged, full, rtol=0, atol=0)


def _points(rng, n=200):
    # inside and around the cube's bbox, and some far outside it
    p = rng.uniform(-0.7, 0.7, (n, 3))
    p[: n // 10] *= 4.0
    return p.astype(np.float32)


def test_trilinear_sample_value_and_gradient_match_jax():
    phi, bmin, scale = jax_sdf.sdf_grid(jnp.asarray(CUBE_V), jnp.asarray(CUBE_F, jnp.int32),
                                        grid_size=8, block=512)
    pts = _points(np.random.default_rng(3))
    w = np.random.default_rng(4).normal(size=(len(pts),)).astype(np.float32)
    x = torch.from_numpy(pts).requires_grad_()
    got = sdf.sample_sdf_trilinear(torch.from_numpy(np.array(phi)), torch.from_numpy(np.array(bmin)),
                                   torch.tensor(float(scale)), x)
    (got * torch.from_numpy(w)).sum().backward()
    want, vjp = jax.vjp(lambda q: jax_sdf.sample_sdf_trilinear(phi, bmin, scale, q), jnp.asarray(pts))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(vjp(jnp.asarray(w))[0]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("robustifier", [None, 0.05])
def test_penetration_loss_value_and_gradient_match_jax(hand, robustifier):
    v, f = hand
    rng = np.random.default_rng(5)
    va = v[None]
    vb = (v * 0.8 + v.mean(0) * 0.2 + rng.normal(scale=0.01, size=v.shape)).astype(np.float32)[None]
    x = torch.from_numpy(vb).requires_grad_()
    loss = sdf.sdf_penetration_loss(torch.from_numpy(va), x, torch.from_numpy(f), 16,
                                    robustifier=robustifier)
    loss.backward()
    want, grad = jax.value_and_grad(lambda b: jax_sdf.sdf_penetration_loss(
        jnp.asarray(va), b, jnp.asarray(f, jnp.int32), grid_size=16,
        robustifier=robustifier))(jnp.asarray(vb))
    grad = np.asarray(grad)
    assert float(want) > 0
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    # float32 rounding of the trilinear weights and of the robustifier's
    # quotient: 1e-4 relative, plus 1e-6 of the largest component
    np.testing.assert_allclose(x.grad.numpy(), grad, rtol=1e-4, atol=1e-6 * np.abs(grad).max())


def test_grid_refuses_verts_that_require_grad():
    v = torch.from_numpy(CUBE_V).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        sdf.sdf_grid(v, torch.from_numpy(CUBE_F), 8)
    with torch.no_grad():
        sdf.sdf_grid(v, torch.from_numpy(CUBE_F), 8)
