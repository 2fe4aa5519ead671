"""The port's two-hand pose refinement against the JAX package on the CPU:
every loss term and anchor function, the refinement objective and its
gradient at the start (both contact modes), and short Adam runs of both
modes (SDF grid 16, 3 iterations per attempt).

Tolerances and why:
  * single terms and the objective: rtol 1e-4 (float32 sums over 778
    vertices, 1552 faces and the SDF trilinear weights);
  * the gradient at the start: rtol 1e-4 plus 1e-5 of its largest
    component (the near-zero components are differences of large terms);
  * short runs: loss terms within 1e-3 relative to the larger of the
    term and its value at the start (the run drives the SDF term to ~1e-6,
    where what is left is the noise of the parameters' differences).
    Parameters within 2·lr·steps absolute, with 99% of them within 1e-3:
    Adam's first steps are close to lr·sign(g), so a gradient component
    that is ~0 may take the other sign in the other framework and move by
    up to 2·lr per step more.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderih_tpu.mano.layer import mano_forward as jax_mano_forward
from renderih_tpu.mano.params import make_synthetic_mano as jax_make_mano
from renderih_tpu.ops.rotation import rodrigues as jax_rodrigues
from renderih_tpu.ops.sdf import sdf_penetration_loss as jax_sdf_loss
from renderih_tpu.optimize import anchors as jax_anchors
from renderih_tpu.optimize import geo as jax_geo
from renderih_tpu_torch.mano.params import make_synthetic_mano
from renderih_tpu_torch.optimize import anchors, geo

G = 16
LR = 1e-2
SCHEDULE = ((1.0, 1.0, 3), (0.1, 15.0, 3), (30.0, 0.1, 3), (1.0, 5.0, 3))


@pytest.fixture(autouse=True)
def _two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup():
    """Both frameworks' MANO models, anchors, prior and one interpenetrating
    start, all from numpy (the synthetic generator's sampling, seed 0)."""
    torch_assets = SimpleNamespace(left=SimpleNamespace(mano=make_synthetic_mano(0, False)),
                                   right=SimpleNamespace(mano=make_synthetic_mano(0, True)))
    jax_assets = SimpleNamespace(left=SimpleNamespace(mano=jax_make_mano(0, False)),
                                 right=SimpleNamespace(mano=jax_make_mano(0, True)))
    rng = np.random.default_rng(0)
    draw = {k: rng.normal(0, s, n).astype(np.float32) for k, s, n in (
        ("root_l", 0.8, 3), ("pose_l", 0.4, 45), ("shape_l", 0.6, 10),
        ("root_r", 0.8, 3), ("pose_r", 0.4, 45), ("shape_r", 0.6, 10),
        ("offset", 0.02, 3))}

    def j9(mano, side):
        _, j = jax_mano_forward(mano, jax_rodrigues(jnp.asarray(draw[f"root_{side}"])[None]),
                                jnp.asarray(draw[f"pose_{side}"])[None],
                                jnp.asarray(draw[f"shape_{side}"])[None],
                                center_idx=None, use_pca=False)
        return np.asarray(j[0, 9])

    start = {
        "left": dict(pose=draw["pose_l"], shape=draw["shape_l"],
                     trans=-j9(jax_assets.left.mano, "l"), root_aa=draw["root_l"]),
        "right": dict(pose=draw["pose_r"], shape=draw["shape_r"],
                      trans=-j9(jax_assets.right.mano, "r") + draw["offset"],
                      root_aa=draw["root_r"]),
    }
    prior_poses = (rng.normal(size=(256, 45)) * 0.4).astype(np.float32)
    specs = [anchors.make_synthetic_anchors(m.faces.numpy(), m.v_template.numpy())
             for m in (torch_assets.left.mano, torch_assets.right.mano)]
    jspecs = [jax_anchors.make_synthetic_anchors(np.asarray(m.faces), np.asarray(m.v_template))
              for m in (jax_assets.left.mano, jax_assets.right.mano)]
    return SimpleNamespace(assets=torch_assets, jax_assets=jax_assets, start=start,
                           prior_poses=prior_poses, specs=tuple(specs), jspecs=tuple(jspecs))


def _torch_vars(start):
    return tuple(geo.HandVars(**{k: torch.from_numpy(v.copy()) for k, v in start[s].items()})
                 for s in ("left", "right"))


def _jax_vars(start):
    return tuple(jax_geo.HandVars(**{k: jnp.asarray(v) for k, v in start[s].items()})
                 for s in ("left", "right"))


def _verts(setup):
    """Both hands' vertices at the start, as numpy."""
    out = []
    for mano, hv in zip((setup.jax_assets.left.mano, setup.jax_assets.right.mano),
                        _jax_vars(setup.start)):
        v, _ = jax_mano_forward(mano, jax_rodrigues(hv.root_aa[None]), hv.pose[None],
                                hv.shape[None], trans=hv.trans[None], center_idx=None,
                                use_pca=False)
        out.append(np.asarray(v[0]))
    return out


def test_start_interpenetrates_and_touches(setup):
    v_l, v_r = _verts(setup)
    pen = float(jax_sdf_loss(jnp.asarray(v_l)[None], jnp.asarray(v_r)[None],
                             setup.jax_assets.left.mano.faces, grid_size=G))
    _, w = jax_geo.anchor_pairs(jnp.asarray(v_l), jnp.asarray(v_r))
    assert pen > 1e-3 and float(w.sum()) > 0


def test_loss_terms_match_jax(setup):
    v_l, v_r = (v.copy() for v in _verts(setup))
    t, j = torch.from_numpy, jnp.asarray
    faces_l = setup.assets.left.mano.faces
    jfaces_l = setup.jax_assets.left.mano.faces
    idx, w = geo.anchor_pairs(t(v_l), t(v_r))
    jidx, jw = jax_geo.anchor_pairs(j(v_l), j(v_r))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_allclose(geo.contact_loss(t(v_l), t(v_r), idx, w).item(),
                               float(jax_geo.contact_loss(j(v_l), j(v_r), jidx, jw)), rtol=1e-4)
    np.testing.assert_allclose(geo._vertex_normals(t(v_l), faces_l).numpy(),
                               np.asarray(jax_geo._vertex_normals(j(v_l), jfaces_l)), atol=1e-5)
    np.testing.assert_allclose(geo.repulsion_loss(t(v_l), faces_l, t(v_r)).item(),
                               float(jax_geo.repulsion_loss(j(v_l), jfaces_l, j(v_r))), rtol=1e-4)
    ref = np.random.default_rng(1).uniform(0.0, 0.01, (faces_l.shape[0], 3)).astype(np.float32)
    np.testing.assert_allclose(geo.edge_preserve_loss(t(v_l), faces_l, t(ref)).item(),
                               float(jax_geo.edge_preserve_loss(j(v_l), jfaces_l, j(ref))),
                               rtol=1e-4)
    pose = setup.start["left"]["pose"] * 6.0  # some joints beyond pi/2
    np.testing.assert_allclose(geo.pose_angle_limit_loss(t(pose)).item(),
                               float(jax_geo.pose_angle_limit_loss(j(pose))), rtol=1e-4)
    prior = geo.make_gaussian_pose_prior(t(setup.prior_poses))
    jprior = jax_geo.make_gaussian_pose_prior(j(setup.prior_poses))
    np.testing.assert_allclose(prior(t(pose)).item(), float(jprior(j(pose))), rtol=1e-4)


def test_anchor_search_matches_jax(setup):
    v_l, v_r = (v.copy() for v in _verts(setup))
    t, j = torch.from_numpy, jnp.asarray
    (spec_l, spec_r), (jspec_l, jspec_r) = setup.specs, setup.jspecs
    for spec, jspec in zip(setup.specs, setup.jspecs):
        np.testing.assert_array_equal(spec.tri_idx.numpy(), np.asarray(jspec.tri_idx))
    args = (anchors.recover_anchors(t(v_r), spec_r), anchors.recover_anchors(t(v_l), spec_l),
            anchors.anchor_normals(t(v_r), spec_r), anchors.anchor_normals(t(v_l), spec_l, flip=True))
    jargs = (jax_anchors.recover_anchors(j(v_r), jspec_r),
             jax_anchors.recover_anchors(j(v_l), jspec_l),
             jax_anchors.anchor_normals(j(v_r), jspec_r),
             jax_anchors.anchor_normals(j(v_l), jspec_l, flip=True))
    for a, ja in zip(args, jargs):
        np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=1e-6)
    fresh = anchors.search_anchor_pairs(*args)
    jfresh = jax_anchors.search_anchor_pairs(*jargs)
    moved = tuple(a + 0.002 for a in args[:2]) + args[2:]
    jmoved = tuple(a + 0.002 for a in jargs[:2]) + jargs[2:]
    again = anchors.search_anchor_pairs(*moved, prev=fresh)
    jagain = jax_anchors.search_anchor_pairs(*jmoved, prev=jfresh)
    for m, jm in ((fresh, jfresh), (again, jagain)):
        np.testing.assert_array_equal(m.idx.numpy(), np.asarray(jm.idx))
        np.testing.assert_array_equal(m.mask.numpy(), np.asarray(jm.mask))
        np.testing.assert_allclose(m.elasti.numpy(), np.asarray(jm.elasti), atol=1e-6)
        np.testing.assert_array_equal(m.vertex_contact.numpy(), np.asarray(jm.vertex_contact))
    assert fresh.mask.sum() > 0
    np.testing.assert_allclose(
        anchors.anchor_contact_loss(t(v_r), t(v_l), spec_r, spec_l, fresh).item(),
        float(jax_anchors.anchor_contact_loss(j(v_r), j(v_l), jspec_r, jspec_l, jfresh)),
        rtol=1e-4)


def _jax_objective(setup, with_anchors):
    """The JAX package's refinement objective (`geo.py:optimize_two_hands`'s
    loss_fn, built from its public functions) at the start."""
    jl0, jr0 = _jax_vars(setup.start)
    am = setup.jax_assets
    prior = jax_geo.make_gaussian_pose_prior(jnp.asarray(setup.prior_poses))
    fl, fr = am.left.mano.faces, am.right.mano.faces

    def fwd(model, hv):
        v, _ = jax_mano_forward(model, jax_rodrigues(hv.root_aa[None]), hv.pose[None],
                                hv.shape[None], trans=hv.trans[None], center_idx=None,
                                use_pca=False)
        return v[0]

    def edge_len(v, f):
        tri = v[f]
        e = jnp.stack([tri[:, 0] - tri[:, 1], tri[:, 1] - tri[:, 2], tri[:, 2] - tri[:, 0]], 1)
        return jnp.sqrt(jnp.sum(e * e, -1) + 1e-12)

    v_l0, v_r0 = fwd(am.left.mano, jl0), fwd(am.right.mano, jr0)
    idx_lr, w_lr = jax_geo.anchor_pairs(v_l0, v_r0, thresh=0.01)
    jspec_l, jspec_r = setup.jspecs
    match = None
    if with_anchors:
        match = jax_anchors.search_anchor_pairs(
            jax_anchors.recover_anchors(v_r0, jspec_r), jax_anchors.recover_anchors(v_l0, jspec_l),
            jax_anchors.anchor_normals(v_r0, jspec_r),
            jax_anchors.anchor_normals(v_l0, jspec_l, flip=True))

    def loss(params):
        l, r = params
        v_l, v_r = fwd(am.left.mano, l), fwd(am.right.mano, r)
        contact = (jax_anchors.anchor_contact_loss(v_r, v_l, jspec_r, jspec_l, match)
                   if with_anchors else jax_geo.contact_loss(v_l, v_r, idx_lr, w_lr))
        w = jax_geo.GeoWeights()
        return (w.contact * contact
                + w.repulsion * (jax_geo.repulsion_loss(v_l, fl, v_r)
                                 + jax_geo.repulsion_loss(v_r, fr, v_l))
                + w.sdf * (jax_sdf_loss(v_l[None], v_r[None], fl, grid_size=G)
                           + jax_sdf_loss(v_r[None], v_l[None], fr, grid_size=G))
                + w.edge * (jax_geo.edge_preserve_loss(v_l, fl, edge_len(v_l0, fl))
                            + jax_geo.edge_preserve_loss(v_r, fr, edge_len(v_r0, fr)))
                + w.pose_reg * (jnp.sum((l.pose - jl0.pose) ** 2) + jnp.sum((r.pose - jr0.pose) ** 2))
                + w.shape_reg * (jnp.sum((l.shape - jl0.shape) ** 2)
                                 + jnp.sum((r.shape - jr0.shape) ** 2))
                + w.angle_limit * (jax_geo.pose_angle_limit_loss(l.pose)
                                   + jax_geo.pose_angle_limit_loss(r.pose))
                + w.prior * (prior(l.pose) + prior(r.pose)))

    return jax.value_and_grad(loss)((jl0, jr0))


@pytest.mark.parametrize("with_anchors", [False, True])
def test_objective_and_gradient_at_the_start_match_jax(setup, with_anchors):
    want, jgrad = _jax_objective(setup, with_anchors)
    left, right = _torch_vars(setup.start)
    prior = geo.make_gaussian_pose_prior(torch.from_numpy(setup.prior_poses))
    loss_fn, match_fn = geo.make_refine_loss(
        setup.assets, left, right, sdf_grid_size=G, pose_prior_fn=prior,
        anchors=setup.specs if with_anchors else None)
    leaves = [t.clone().requires_grad_() for hv in (left, right) for t in hv]
    params = (geo.HandVars(*leaves[:4]), geo.HandVars(*leaves[4:]))
    match = match_fn(params) if with_anchors else None
    total, terms = loss_fn(params, match)
    total.backward()
    assert terms["sdf"].item() > 0 and terms["contact"].item() > 0
    np.testing.assert_allclose(total.item(), float(want), rtol=1e-4)
    jleaves = [np.asarray(x) for hv in jgrad for x in hv]
    for name, leaf, jg in zip([f"{s}.{f}" for s in "lr" for f in geo.HandVars._fields],
                              leaves, jleaves):
        np.testing.assert_allclose(leaf.grad.numpy(), jg, rtol=1e-4,
                                   atol=1e-5 * np.abs(jg).max(), err_msg=name)


@pytest.mark.parametrize("with_anchors", [False, True])
def test_short_run_matches_jax(setup, with_anchors):
    kw = dict(lr=LR, sdf_grid_size=G)
    if with_anchors:
        kw.update(schedule=SCHEDULE)
    jl, jr, jterms = jax_geo.optimize_two_hands(
        setup.jax_assets, *_jax_vars(setup.start), n_iter=3,
        pose_prior_fn=jax_geo.make_gaussian_pose_prior(jnp.asarray(setup.prior_poses)),
        anchors=setup.jspecs if with_anchors else None, **kw)
    l, r, terms = geo.optimize_two_hands(
        setup.assets, *_torch_vars(setup.start), n_iter=3,
        pose_prior_fn=geo.make_gaussian_pose_prior(torch.from_numpy(setup.prior_poses)),
        anchors=setup.specs if with_anchors else None, **kw)
    assert set(terms) == set(jterms)
    left, right = _torch_vars(setup.start)
    loss_fn, match_fn = geo.make_refine_loss(
        setup.assets, left, right, sdf_grid_size=G, pose_prior_fn=geo.make_gaussian_pose_prior(
            torch.from_numpy(setup.prior_poses)), anchors=setup.specs if with_anchors else None)
    with torch.no_grad():
        _, at_start = loss_fn((left, right), match_fn((left, right)) if with_anchors else None)
    for key, want in jterms.items():
        scale = max(abs(float(want)), abs(at_start[key].item()))
        assert abs(terms[key].item() - float(want)) <= 1e-3 * scale, (key, terms[key], want)
    steps = 12 if with_anchors else 3
    got = np.concatenate([t.numpy().ravel() for hv in (l, r) for t in hv])
    want = np.concatenate([np.asarray(t).ravel() for hv in (jl, jr) for t in hv])
    err = np.abs(got - want)
    assert err.max() <= 2 * LR * steps, err.max()
    assert np.mean(err <= 1e-3) >= 0.99, np.sort(err)[-10:]
    start = np.concatenate([v.ravel() for s in ("left", "right")
                            for v in setup.start[s].values()])
    assert np.abs(got - start).max() > LR  # it moved


def test_anchor_txt_and_pose_prior_files_match_jax(tmp_path, setup):
    spec = setup.specs[0]
    np.savetxt(tmp_path / "face_vertex_idx.txt", spec.tri_idx.numpy(), fmt="%d")
    np.savetxt(tmp_path / "anchor_weight.txt", spec.weights.numpy())
    np.savetxt(tmp_path / "merged_vertex_assignment.txt", spec.classes.numpy(), fmt="%d")
    got, want = anchors.load_anchor_txt(str(tmp_path)), jax_anchors.load_anchor_txt(str(tmp_path))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    params = {"dense": {"kernel": np.arange(6, dtype=np.float32).reshape(2, 3)},
              "bias": np.ones(3, np.float32)}
    geo.save_pose_prior(params, str(tmp_path / "prior.npz"))
    loaded = geo.load_pose_prior(str(tmp_path / "prior.npz"))
    jloaded = jax_geo.load_pose_prior(str(tmp_path / "prior.npz"))
    np.testing.assert_array_equal(loaded["dense"]["kernel"], np.asarray(jloaded["dense"]["kernel"]))
    np.testing.assert_array_equal(loaded["bias"], params["bias"])
