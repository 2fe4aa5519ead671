"""The port's rotations and MANO forward against the JAX package, on the
synthetic MANO assets (bit-identical in both packages) and numpy-made
poses. Tolerance: atol 1e-5 on vertices and joints (float32, ~10 cm hand:
a few units in the last place of the LBS sums)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderih_tpu.mano import layer as jax_layer
from renderih_tpu.mano.params import make_synthetic_mano as jax_make_mano
from renderih_tpu.ops import rotation as jax_rot
from renderih_tpu_torch.mano import layer
from renderih_tpu_torch.mano.params import KINEMATIC_LEVELS, make_synthetic_mano, to_device
from renderih_tpu_torch.ops import rotation

ATOL = 1e-5


@pytest.fixture(scope="module")
def models():
    return {right: (make_synthetic_mano(0, is_right=right), jax_make_mano(0, is_right=right))
            for right in (False, True)}


def test_rodrigues_matches_jax_including_the_zero_pose_branch():
    rng = np.random.default_rng(0)
    aa = rng.normal(0, 1.0, (64, 3)).astype(np.float32)
    aa[:4] *= 1e-5  # t² < 1e-8: the Taylor branch
    aa[4] = 0.0
    got = rotation.rodrigues(torch.from_numpy(aa)).numpy()
    want = np.asarray(jax_rot.rodrigues(jnp.asarray(aa)))
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("at_zero", [True, False])
def test_rodrigues_gradient_matches_jax(at_zero):
    rng = np.random.default_rng(1)
    aa = np.zeros((5, 3), np.float32) if at_zero else rng.normal(0, 0.7, (5, 3)).astype(np.float32)
    w = rng.normal(size=(5, 3, 3)).astype(np.float32)
    x = torch.from_numpy(aa).requires_grad_()
    (rotation.rodrigues(x) * torch.from_numpy(w)).sum().backward()
    want = jax.grad(lambda a: jnp.sum(jax_rot.rodrigues(a) * w))(jnp.asarray(aa))
    assert torch.isfinite(x.grad).all()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), atol=1e-5)


def test_other_rotations_match_jax():
    rng = np.random.default_rng(2)
    aa = rng.normal(0, 0.8, (16, 3)).astype(np.float32)
    rot = np.array(jax_rot.rodrigues(jnp.asarray(aa)))
    np.testing.assert_allclose(rotation.rodrigues_inverse(torch.from_numpy(rot)).numpy(),
                               np.asarray(jax_rot.rodrigues_inverse(jnp.asarray(rot))),
                               atol=1e-5)
    x6 = rng.normal(size=(16, 6)).astype(np.float32)
    np.testing.assert_allclose(rotation.rot6d_to_rotmat(torch.from_numpy(x6)).numpy(),
                               np.asarray(jax_rot.rot6d_to_rotmat(jnp.asarray(x6))), atol=1e-6)
    pts = rng.normal(size=(16, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        rotation.axis_angle_rotate(torch.from_numpy(pts), torch.from_numpy(aa)).numpy(),
        np.asarray(jax_rot.axis_angle_rotate(jnp.asarray(pts), jnp.asarray(aa))), atol=1e-5)
    deg = rng.uniform(-180, 180, (16,)).astype(np.float32)
    np.testing.assert_allclose(rotation.rotmat_z(torch.from_numpy(deg)).numpy(),
                               np.asarray(jax_rot.rotmat_z(jnp.asarray(deg))), atol=1e-6)


def test_kinematic_levels_and_pca_maps(models):
    from renderih_tpu.mano.params import KINEMATIC_LEVELS as JAX_LEVELS

    assert KINEMATIC_LEVELS == JAX_LEVELS
    model, jmodel = models[True]
    rng = np.random.default_rng(3)
    pca = rng.normal(size=(4, 12)).astype(np.float32)
    axis = layer.pca_to_axis(model, torch.from_numpy(pca))
    np.testing.assert_allclose(axis.numpy(), np.asarray(jax_layer.pca_to_axis(jmodel, jnp.asarray(pca))),
                               atol=1e-5)
    np.testing.assert_allclose(layer.axis_to_pca(model, axis).numpy(),
                               np.asarray(jax_layer.axis_to_pca(jmodel, jnp.asarray(axis.numpy()))),
                               atol=1e-4)


@pytest.mark.parametrize("right", [False, True])
@pytest.mark.parametrize("use_pca,center_idx,with_trans,new_skel", [
    (True, 9, False, False), (False, None, True, False), (False, 9, True, True),
    (True, None, False, True)])
def test_mano_forward_matches_jax(models, right, use_pca, center_idx, with_trans, new_skel):
    model, jmodel = models[right]
    rng = np.random.default_rng(4)
    b = 3
    root = rng.normal(0, 0.8, (b, 3)).astype(np.float32)
    pose = rng.normal(0, 0.4, (b, 12 if use_pca else 45)).astype(np.float32)
    shape = rng.normal(0, 0.6, (b, 10)).astype(np.float32)
    trans = rng.normal(0, 0.1, (b, 3)).astype(np.float32)
    scale = rng.uniform(0.8, 1.2, (b,)).astype(np.float32)
    kw = dict(center_idx=center_idx, use_pca=use_pca, new_skel=new_skel)
    t = torch.from_numpy
    v, j = layer.mano_forward(model, rotation.rodrigues(t(root)), t(pose), t(shape),
                              trans=t(trans) if with_trans else None,
                              scale=t(scale) if center_idx is not None else None, **kw)
    jv, jj = jax_layer.mano_forward(
        jmodel, jax_rot.rodrigues(jnp.asarray(root)), jnp.asarray(pose), jnp.asarray(shape),
        trans=jnp.asarray(trans) if with_trans else None,
        scale=jnp.asarray(scale) if center_idx is not None else None, **kw)
    assert v.shape == (b, 778, 3) and j.shape == (b, 21, 3)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=ATOL)
    np.testing.assert_allclose(j.numpy(), np.asarray(jj), atol=ATOL)


def test_mano_forward_gradient_matches_jax(models):
    model, jmodel = models[False]
    rng = np.random.default_rng(5)
    root = rng.normal(0, 0.8, (1, 3)).astype(np.float32)
    pose = np.zeros((1, 45), np.float32)  # the refinement's zero-pose start
    shape = rng.normal(0, 0.6, (1, 10)).astype(np.float32)
    w = rng.normal(size=(1, 778, 3)).astype(np.float32)
    p = torch.from_numpy(pose).requires_grad_()
    v, _ = layer.mano_forward(model, rotation.rodrigues(torch.from_numpy(root)), p,
                              torch.from_numpy(shape), center_idx=None, use_pca=False)
    (v * torch.from_numpy(w)).sum().backward()
    want = jax.grad(lambda q: jnp.sum(jax_layer.mano_forward(
        jmodel, jax_rot.rodrigues(jnp.asarray(root)), q, jnp.asarray(shape),
        center_idx=None, use_pca=False)[0] * w))(jnp.asarray(pose))
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_to_device_keeps_every_tensor(models):
    model, _ = models[True]
    moved = to_device(model, "cpu")
    assert moved.faces is model.faces and moved.is_right is True
