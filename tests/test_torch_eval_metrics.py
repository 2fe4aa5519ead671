"""The port's eval metrics (`renderih_tpu_torch/eval/metrics.py`) against
`renderih_tpu/eval/metrics.py` on the CPU, on the same float32 vectors
made by numpy from fixed seeds; JAX at `highest` matmul precision
(tests/conftest.py).

Tolerances: 1e-6 m for the plain errors (MPJPE/MPVPE and their
root-relative and length-normalised forms, MRRPE, CDev, the double
errors, the nearest-neighbour distances); 1e-5 m for everything that
goes through a Procrustes alignment and for the analytic route against
the SVD route, JAX's own bar (tests/test_metrics.py:57). Covered: both
conventions, a reflection (a cross-covariance with negative determinant),
samples with and without ground-truth contact (CDev NaN)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderih_tpu.eval import metrics as jm
from renderih_tpu_torch.assets import make_synthetic_assets
from renderih_tpu_torch.eval import metrics as tm

B, V = 4, 778
PLAIN, ALIGNED = 1e-6, 1e-5


def _rot(rng, n: int) -> np.ndarray:
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    return q * np.sign(np.linalg.det(q))[:, None, None]


def _hands(seed: int, template: np.ndarray) -> dict:
    """Hand-shaped vertex sets made by numpy: the synthetic MANO template
    rotated at random, plus 5 mm noise. Ground truth in a camera frame
    (0.8 m away): samples 0-1 have the right hand a few mm from the left
    (contact), 2-3 apart (no contact). Predictions in the network frame:
    the template at another rotation, root-centred, 1 cm noise."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    hand = lambda: (np.einsum("bij,vj->bvi", _rot(rng, B), template)
                    + rng.normal(0, 0.005, (B, V, 3)))
    left = hand() + [0.0, 0.0, 0.8]
    right = hand() + [0.3, 0.0, 0.8]
    right[:2] = left[:2] + rng.normal(0, 0.0015, (2, V, 3)) + [0.002, 0.0, 0.0]
    pred = {h: f32(hand() + rng.normal(0, 0.01, (B, V, 3))) for h in ("left", "right")}
    return dict(gt={"left": f32(left), "right": f32(right)}, pred=pred)


def _pts(seed: int, reflect: bool = False) -> tuple:
    """s1, s2 (B, 21, 3): s2 a rotated, scaled, shifted s1 plus noise, or
    its mirror image (`reflect`: det K < 0)."""
    rng = np.random.default_rng(seed)
    s1 = rng.normal(0, 0.05, (B, 21, 3))
    s2 = 1.3 * np.einsum("bij,bnj->bni", _rot(rng, B), s1) + rng.normal(0, 0.1, (B, 1, 3))
    s2 += rng.normal(0, 0.003, s2.shape)
    if reflect:
        s2 = s2 * np.array([-1.0, 1.0, 1.0])
    return s1.astype(np.float32), s2.astype(np.float32)


@pytest.fixture(scope="module")
def assets():
    a = make_synthetic_assets(0)
    return dict(template=a.left.mano.v_template.numpy(),
                j_reg={h: getattr(a, h).j_reg_21.numpy() for h in ("left", "right")})


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def _j(tree):
    if isinstance(tree, dict):
        return {k: _j(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _tol(name: str) -> float:
    return ALIGNED if "pa_" in name or "align" in name else PLAIN


def _two_hand(conv):
    root_idx, lengths = {"default": (0, (0, 1)), "newmpjpe": (9, (0, 9))}[conv]
    return lambda m, h, r: m.two_hand_metrics(h["pred"], h["gt"], r, root_idx=root_idx,
                                              length_joints=lengths)


def _double(m, h, r):
    reg = tm._regress if m is tm else (lambda jr, v: jnp.einsum("jv,bvc->bjc", jr, v))
    j_pred = {k: reg(r[k], h["pred"][k]) for k in r}
    j_gt = {k: reg(r[k], h["gt"][k]) for k in r}
    return m.double_metrics(h["pred"], h["gt"], j_pred, j_gt, root_idx=9)


CASES = {
    # name: (fn(module, hands, j_reg) -> dict or array, hands seed)
    "mpjpe": (lambda m, h, r: m.mpjpe(h["pred"]["left"], h["gt"]["left"]), 1),
    "pa_mpjpe": (lambda m, h, r: m.pa_mpjpe(h["pred"]["right"], h["gt"]["right"]), 2),
    "mrrpe": (lambda m, h, r: m.compute_mrrpe(h["pred"]["left"][:, 0], h["pred"]["right"][:, 0],
                                              h["gt"]["left"][:, 0], h["gt"]["right"][:, 0]), 3),
    "nn_right_to_left": (lambda m, h, r: dict(zip(("dist", "idx"), m._nn_right_to_left(
        h["gt"]["right"], h["gt"]["left"]))), 4),
    "cdev": (lambda m, h, r: m.compute_cdev(h["pred"]["left"], h["pred"]["right"],
                                            h["gt"]["left"], h["gt"]["right"]), 5),
    "two_hand_default": (_two_hand("default"), 6),
    "two_hand_newmpjpe": (_two_hand("newmpjpe"), 7),
    "double_root9": (_double, 8),
    "nanmean": (lambda m, h, r: m.nanmean(m.compute_cdev(
        h["pred"]["left"], h["pred"]["right"], h["gt"]["left"], h["gt"]["right"])), 9),
}


def _flat(out) -> dict:
    return out if isinstance(out, dict) else {"value": out}


@pytest.mark.parametrize("case", sorted(CASES))
def test_metric_matches_jax(case, assets):
    fn, seed = CASES[case]
    hands, j_reg = _hands(seed, assets["template"]), assets["j_reg"]
    got = _flat(fn(tm, _t(hands), _t(j_reg)))
    want = _flat(fn(jm, _j(hands), _j(j_reg)))
    assert got.keys() == want.keys()
    for k, w in want.items():
        g, w = np.asarray(got[k]), np.asarray(w)
        assert g.shape == w.shape, k
        if k == "idx":
            np.testing.assert_array_equal(g, w)
            continue
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=k)
        ok = ~np.isnan(w)
        err = np.abs(g[ok] - w[ok]).max(initial=0.0)
        tol = _tol(k if case.startswith("two_hand") or case.startswith("double")
                   else case)
        assert err <= tol, f"{case}/{k}: max|Δ| {err:.3e} > {tol:g}"
    if case in ("cdev", "two_hand_default"):  # both branches of CDev are exercised
        cdev = np.asarray(got.get("cdev", got.get("value")))
        assert np.isfinite(cdev[:2]).all() and np.isnan(cdev[2:]).all()


@pytest.mark.parametrize("reflect", [False, True])
@pytest.mark.parametrize("method", ["analytic", "svd"])
def test_similarity_align_matches_jax_and_its_oracle(method, reflect):
    s1, s2 = _pts(10 + reflect, reflect)
    k = np.einsum("bni,bnj->bij", s1 - s1.mean(1, keepdims=True), s2 - s2.mean(1, keepdims=True))
    assert (np.linalg.det(k) < 0).all() == reflect
    got = tm.batch_similarity_align(torch.from_numpy(s1), torch.from_numpy(s2), method).numpy()
    want = np.asarray(jm.batch_similarity_align(jnp.asarray(s1), jnp.asarray(s2), method))
    assert np.abs(got - want).max() <= ALIGNED
    oracle = tm.batch_similarity_align(torch.from_numpy(s1), torch.from_numpy(s2), "svd").numpy()
    assert np.abs(got - oracle).max() <= ALIGNED


def test_umeyama_rotation_is_a_proper_rotation_like_jax():
    s1, s2 = _pts(12, reflect=True)
    k = np.einsum("bni,bnj->bij", s1, s2).astype(np.float32)
    r, tr = tm._umeyama_rotation(torch.from_numpy(k))
    jr, jtr = jm._umeyama_rotation(jnp.asarray(k))
    r = r.numpy()
    np.testing.assert_allclose(r, np.asarray(jr), atol=ALIGNED)  # q and -q give one R
    np.testing.assert_allclose(tr.numpy(), np.asarray(jtr), rtol=ALIGNED)
    np.testing.assert_allclose(np.linalg.det(r), 1.0, atol=1e-5)
    np.testing.assert_allclose(r @ r.transpose(0, 2, 1), np.broadcast_to(np.eye(3), r.shape),
                               atol=1e-5)


def test_unknown_align_method_raises():
    s1, s2 = (torch.from_numpy(a) for a in _pts(13))
    with pytest.raises(ValueError, match="unknown method"):
        tm.batch_similarity_align(s1, s2, "qr")
