"""The port's joints -> MANO IK (`renderih_tpu_torch/mano/ik.py`) against
the JAX package's (`renderih_tpu/mano/ik.py`) on the synthetic MANO, and
`tests/test_ik.py`'s round-trip properties on the port at that file's own
thresholds.

Tolerances: `ik_from_joints` (analytic IK) within 1e-5 of JAX on every
output; `fit_mano_to_joints` at 5 Adam steps within 1e-4. At the full
iteration counts the fit is chaotic under float rounding (the pose
regulariser pins only the twist null space), so there only the fit's
quality is held, at test_ik.py's bars."""

import numpy as np
import pytest
import torch

from renderih_tpu_torch.mano.ik import adaptive_ik, fit_mano_to_joints, ik_from_joints, ik_template
from renderih_tpu_torch.mano.layer import mano_forward
from renderih_tpu_torch.mano.params import make_synthetic_mano
from renderih_tpu_torch.ops.rotation import rodrigues

# skeleton-joint rows of the 21 (the tips are LBS vertices)
_SKEL_ROWS = [0, 1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19]


@pytest.fixture(scope="module")
def mano():
    return make_synthetic_mano(seed=0, is_right=True)  # make_synthetic_assets(0).right.mano


def _random_gt(mano, seed, b=4, pose_scale=0.4, shape_scale=0.0):
    rng = np.random.default_rng(seed)
    root = rodrigues(torch.from_numpy(rng.normal(size=(b, 3)).astype(np.float32) * 0.5))
    pose = torch.from_numpy(rng.normal(size=(b, 45)).astype(np.float32) * pose_scale)
    shape = torch.from_numpy(rng.normal(size=(b, 10)).astype(np.float32) * shape_scale)
    with torch.no_grad():
        v, j = mano_forward(mano, root, pose, shape, center_idx=None, use_pca=False)
    return root, pose, shape, v, j


@pytest.fixture(scope="module")
def jax_side():
    """The JAX IK's outputs on the joints of `_random_gt` (computed once)."""
    import jax.numpy as jnp

    from renderih_tpu.mano import ik as jik
    from renderih_tpu.mano.params import make_synthetic_mano as jax_mano

    jmano = jax_mano(seed=0, is_right=True)
    port_mano = make_synthetic_mano(seed=0, is_right=True)
    joints = {seed: _random_gt(port_mano, seed, b=3, pose_scale=0.4,
                               shape_scale=0.5)[4].numpy() for seed in (21, 22)}
    out = {}
    j = jnp.asarray(joints[21])
    out["template"] = np.asarray(jik.ik_template(jmano))
    r0, rot = jik.adaptive_ik(jnp.asarray(out["template"]), j)
    out["aik"] = (np.asarray(r0), np.asarray(rot))
    out["ik"] = [np.asarray(x) for x in jik.ik_from_joints(jmano, j)]
    out["fit5"] = [np.asarray(x) for x in jik.fit_mano_to_joints(
        jmano, jnp.asarray(joints[22]), iters=5)]
    return joints, out


def test_ik_matches_jax(mano, jax_side):
    """ik_template, adaptive_ik and ik_from_joints (1e-5) and
    fit_mano_to_joints at 5 steps (1e-4) against the JAX package."""
    joints, ref = jax_side
    np.testing.assert_allclose(ik_template(mano).numpy(), ref["template"], atol=1e-6)
    r0, rot = adaptive_ik(ik_template(mano), torch.from_numpy(joints[21]))
    np.testing.assert_allclose(r0.numpy(), ref["aik"][0], atol=1e-5)
    np.testing.assert_allclose(rot.numpy(), ref["aik"][1], atol=1e-5)
    fit = ik_from_joints(mano, torch.from_numpy(joints[21]))
    for got, want in zip(fit, ref["ik"]):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    fit5 = fit_mano_to_joints(mano, torch.from_numpy(joints[22]), iters=5)
    for got, want in zip(fit5, ref["fit5"]):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_aik_zero_pose_is_identity(mano):
    template = ik_template(mano)
    r0, rotmats = adaptive_ik(template, template[None])
    np.testing.assert_allclose(r0[0].numpy(), np.eye(3), atol=1e-4)
    np.testing.assert_allclose(rotmats[0].numpy(), np.broadcast_to(np.eye(3), (15, 3, 3)),
                               atol=2e-3)


def test_aik_skeleton_joint_roundtrip_random_pose(mano):
    _, _, _, _, j_gt = _random_gt(mano, seed=1)
    r0, rotmats = adaptive_ik(ik_template(mano), j_gt)
    _, j_rec = mano_forward(mano, r0, rotmats, torch.zeros((4, 10)), center_idx=None,
                            use_pca=False)
    err = ((j_rec - j_rec[:, :1]) - (j_gt - j_gt[:, :1])).abs().numpy()
    assert err[:, _SKEL_ROWS].max() < 1e-3, err[:, _SKEL_ROWS].max()


def test_fit_vertex_roundtrip_swing_only_pose(mano):
    """test_ik.py's bars: joint max <= 0.5 mm, vertex mean <= 0.6 mm,
    vertex max <= 3 mm, on a swing-only ground truth at 300 steps."""
    _, _, _, _, j_seed = _random_gt(mano, seed=2)
    r0, rotmats = adaptive_ik(ik_template(mano), j_seed)  # swing-only GT pose
    with torch.no_grad():
        v_gt, j_gt = mano_forward(mano, r0, rotmats, torch.zeros((4, 10)),
                                  center_idx=None, use_pca=False)
    fit = fit_mano_to_joints(mano, j_gt, iters=300)
    with torch.no_grad():
        v_rec, j_rec = mano_forward(mano, rodrigues(fit.root_aa), fit.pose_aa, fit.shape,
                                    center_idx=None, use_pca=False)
    err_v = ((v_rec - j_rec[:, :1]) - (v_gt - j_gt[:, :1])).abs().numpy()
    err_j = ((j_rec - j_rec[:, :1]) - (j_gt - j_gt[:, :1])).abs().numpy()
    assert err_j.max() < 0.5e-3, err_j.max()
    assert err_v.mean() < 0.6e-3, err_v.mean()
    assert err_v.max() < 3e-3, err_v.max()


def test_ik_from_joints_unit_invariance(mano):
    _, _, _, _, j_gt = _random_gt(mano, seed=3, b=2)
    fit_m = ik_from_joints(mano, j_gt)
    fit_mm = ik_from_joints(mano, j_gt * 1000.0 + 5.0)
    np.testing.assert_allclose(fit_m.pose_aa.numpy(), fit_mm.pose_aa.numpy(), atol=1e-4)


def test_fit_refinement_improves_and_recovers_shape(mano):
    _, _, _, _, j_gt = _random_gt(mano, seed=4, b=2, pose_scale=0.3, shape_scale=0.8)
    a_err = float(ik_from_joints(mano, j_gt).joint_err.mean())
    f_err = float(fit_mano_to_joints(mano, j_gt, iters=150).joint_err.mean())
    assert f_err < a_err, (f_err, a_err)
    assert f_err < 1.5e-3, f_err  # < 1.5 mm mean joint residual
