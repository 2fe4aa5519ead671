"""The MANO-parameter head of `decoder="mano"` against the JAX package on
the CPU: `ParamRegressor` (outputs and their gradient) and the losses of
`losses/mano_loss.py`, on the same seeded numpy inputs and weights
(carried with `utils/weights.py`), within 1e-5 (relative to the largest
|value| for the regressor's outputs and gradient). The regressor's inputs
are scaled so that its hard-swish inputs fall on all three pieces
(below -3, between, above 3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderih_tpu.losses import mano_loss as jax_mano_loss
from renderih_tpu.models.decoder import DecoderOutput as JaxDecoderOutput
from renderih_tpu.models.decoder import ParamRegressor as JaxParamRegressor
from renderih_tpu_torch.losses import mano_loss
from renderih_tpu_torch.models.decoder import DecoderOutput, ParamRegressor
from renderih_tpu_torch.utils import weights

TOL = 1e-5
HANDS = ("left", "right")


@pytest.fixture(scope="module")
def regressor():
    verts = (np.random.default_rng(0).normal(size=(3, 778, 3)) * 3.0).astype(np.float32)
    jreg = JaxParamRegressor()
    params = jax.tree_util.tree_map(
        np.asarray, jreg.init(jax.random.PRNGKey(0), jnp.asarray(verts))["params"])
    sd = {}
    weights._param_regressor(params, "reg", sd)
    reg = ParamRegressor()
    reg.load_state_dict({k.removeprefix("reg."): v for k, v in sd.items()})
    return dict(verts=verts, jreg=jreg, params=params, reg=reg)


def _close(got: torch.Tensor, want, tol: float = TOL):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert np.abs(got.detach().numpy() - want).max() <= tol * max(1.0, np.abs(want).max())


def test_param_regressor_matches_jax(regressor):
    r = regressor
    pieces = []
    h = torch.from_numpy(r["verts"]).reshape(3, -1)
    for layer in r["reg"].dense:
        h = layer(h)
        pieces.append(((h > 3).sum(), ((h > -3) & (h < 3)).sum(), (h < -3).sum()))
        h = torch.nn.functional.hardswish(h)
    assert all(min(p) > 0 for p in pieces), pieces
    pose6d, shape = r["reg"](torch.from_numpy(r["verts"]))
    jpose6d, jshape = r["jreg"].apply({"params": r["params"]}, jnp.asarray(r["verts"]))
    assert pose6d.shape == (3, 96) and shape.shape == (3, 10)
    _close(pose6d, jpose6d)
    _close(shape, jshape)


def test_param_regressor_gradient_matches_jax(regressor):
    """d(sum of the outputs, weighted)/d(vertices): the hard-swish
    branches and the layer order, backwards."""
    r = regressor
    w6, w10 = (np.random.default_rng(s).normal(size=(3, n)).astype(np.float32)
               for s, n in ((1, 96), (2, 10)))
    v = torch.from_numpy(r["verts"]).requires_grad_(True)
    pose6d, shape = r["reg"](v)
    ((pose6d * torch.from_numpy(w6)).sum() + (shape * torch.from_numpy(w10)).sum()).backward()

    def f(x):
        p, s = r["jreg"].apply({"params": r["params"]}, x)
        return jnp.sum(p * w6) + jnp.sum(s * w10)

    _close(v.grad, jax.grad(f)(jnp.asarray(r["verts"])))


def _poses(seed: int, n: int = 4):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 48)) * 0.6).astype(np.float32)


def test_pose_rotmat_loss_matches_jax():
    a, b = _poses(3), _poses(4)
    got = mano_loss.pose_rotmat_loss(torch.from_numpy(a), torch.from_numpy(b))
    want = jax_mano_loss.pose_rotmat_loss(jnp.asarray(a), jnp.asarray(b))
    assert abs(float(got) - float(want)) <= TOL * float(want)
    assert float(mano_loss.pose_rotmat_loss(torch.from_numpy(a), torch.from_numpy(a))) < 1e-10


def test_pose6d_rotmat_loss_matches_jax():
    pred = np.random.default_rng(5).normal(size=(4, 96)).astype(np.float32)
    gt = _poses(6)
    p = torch.from_numpy(pred).requires_grad_(True)
    got = mano_loss.pose6d_rotmat_loss(p, torch.from_numpy(gt))
    got.backward()
    loss = lambda x: jax_mano_loss.pose6d_rotmat_loss(x, jnp.asarray(gt))
    assert abs(float(got) - float(loss(jnp.asarray(pred)))) <= TOL * float(got)
    _close(p.grad, jax.grad(loss)(jnp.asarray(pred)))


def test_mano_param_losses_and_root_rel_match_jax():
    rng = np.random.default_rng(7)
    pose6d = {h: rng.normal(size=(4, 96)).astype(np.float32) for h in HANDS}
    shape = {h: rng.normal(size=(4, 10)).astype(np.float32) for h in HANDS}
    batch = {f"pose_{h}": _poses(8 + i) for i, h in enumerate(HANDS)}
    batch.update({f"shape_{h}": rng.normal(size=(4, 10)).astype(np.float32) for h in HANDS})
    out = DecoderOutput(*([None] * 6), mano_pose={h: torch.from_numpy(v) for h, v in pose6d.items()},
                        mano_shape={h: torch.from_numpy(v) for h, v in shape.items()})
    jout = JaxDecoderOutput(*([None] * 6), mano_pose={h: jnp.asarray(v) for h, v in pose6d.items()},
                            mano_shape={h: jnp.asarray(v) for h, v in shape.items()})
    got = mano_loss.mano_param_losses(out, {k: torch.from_numpy(v) for k, v in batch.items()})
    want = jax_mano_loss.mano_param_losses(jout, {k: jnp.asarray(v) for k, v in batch.items()})
    assert set(got) == set(want) == {"pose", "shape", "shape_reg"}
    for k, ref in want.items():
        assert abs(float(got[k]) - float(ref)) <= TOL * abs(float(ref)), k
    a, b = rng.normal(size=(2, 4, 3)).astype(np.float32)
    assert abs(float(mano_loss.root_rel_loss(torch.from_numpy(a), torch.from_numpy(b)))
               - float(jax_mano_loss.root_rel_loss(jnp.asarray(a), jnp.asarray(b)))) <= TOL


def test_branches_cover_hardswish(regressor):
    """`utils/branches.py` records each hard-swish's piece and replays it:
    the replay reproduces the regressor's outputs and input gradient, and a
    record of other inputs changes them."""
    from renderih_tpu_torch.utils.branches import record_branches, take_branches

    r = regressor

    def run(verts, branches):
        v = torch.from_numpy(verts).requires_grad_(True)
        with branches as taken:
            pose6d, shape = r["reg"](v)
        (pose6d.sum() + shape.square().sum()).backward()
        return pose6d.detach(), v.grad, taken

    want_out, want_grad, taken = run(r["verts"], record_branches())
    assert sum(kind == "hardswish" for kind, _ in taken) == 4
    got_out, got_grad, _ = run(r["verts"], take_branches(taken))
    torch.testing.assert_close(got_out, want_out, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got_grad, want_grad, rtol=1e-6, atol=1e-6)
    _, _, other = run(r["verts"][::-1].copy(), record_branches())
    moved, _, _ = run(r["verts"], take_branches(other))
    assert not torch.allclose(moved, want_out)
