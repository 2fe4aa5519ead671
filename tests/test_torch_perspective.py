"""The port's pinhole camera and its perspective and densepose renders
(`ops/projection.py:pinhole_project`, `render/renderer.py`) against the JAX
package on the CPU, at 64² on the synthetic two-hand mesh, and the
properties `tests/test_perspective.py` checks.

Tolerances: `pinhole_project` within 1e-5 px; renders at
`tests/test_torch_render.py`'s bar: masks agree on >= 99.9% of pixels,
RGB or attributes within 1e-4 where they agree.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderih_tpu.mano.params import make_synthetic_mano as jax_make_mano
from renderih_tpu.ops.projection import pinhole_project as jax_pinhole
from renderih_tpu.render.renderer import TwoHandRenderer as JaxRenderer
from renderih_tpu_torch.mano.layer import mano_forward
from renderih_tpu_torch.mano.params import make_synthetic_mano
from renderih_tpu_torch.ops.projection import pinhole_project
from renderih_tpu_torch.ops.rotation import rodrigues
from renderih_tpu_torch.render.renderer import TwoHandRenderer

RES = 64
B = 2


def _compare_images(rgb, mask, jrgb, jmask):
    rgb, mask, jrgb, jmask = (np.asarray(a) for a in (rgb, mask, jrgb, jmask))
    assert rgb.shape == jrgb.shape and mask.shape == jmask.shape
    agree = mask == jmask
    assert agree.mean() >= 0.999, agree.mean()
    assert 0.02 < jmask.mean() < 0.9
    np.testing.assert_allclose(rgb[agree], jrgb[agree], atol=1e-4)


def _intrinsics(f, c, fx_scale=1.0):
    return np.array([[f * fx_scale, 0.0, c], [0.0, f, c + 1.5], [0.0, 0.0, 1.0]], np.float32)


@pytest.fixture(scope="module")
def scene():
    """Two posed hands in camera space at depth ~0.5 m, per-frame
    intrinsics, cameras, albedo, lights and densepose colours."""
    assets = SimpleNamespace(left=SimpleNamespace(mano=make_synthetic_mano(0, False)),
                             right=SimpleNamespace(mano=make_synthetic_mano(0, True)))
    jax_assets = SimpleNamespace(left=SimpleNamespace(mano=jax_make_mano(0, False)),
                                 right=SimpleNamespace(mano=jax_make_mano(0, True)))
    rng = np.random.default_rng(0)
    verts = []
    for mano, dx in ((assets.left.mano, -0.06), (assets.right.mano, 0.06)):
        root = torch.from_numpy(rng.normal(0, 0.6, (B, 3)).astype(np.float32))
        pose = torch.from_numpy(rng.normal(0, 0.4, (B, 45)).astype(np.float32))
        v, _ = mano_forward(mano, rodrigues(root), pose, torch.zeros(B, 10), use_pca=False)
        verts.append(v.numpy() + np.array([dx, 0.0, 0.5], np.float32))
    light = rng.normal(size=(B, 3)).astype(np.float32)
    light[:, 2] = -np.abs(light[:, 2]) - 0.5
    light /= np.linalg.norm(light, axis=1, keepdims=True)
    return SimpleNamespace(
        assets=assets, jax_assets=jax_assets, v_l=verts[0], v_r=verts[1],
        K=np.stack([_intrinsics(70.0, RES / 2), _intrinsics(90.0, RES / 2 - 3, 1.1)]),
        scale=np.full((B,), 2.0, np.float32),
        trans_l=rng.uniform(-0.3, -0.1, (B, 2)).astype(np.float32),
        trans_r=rng.uniform(0.0, 0.2, (B, 2)).astype(np.float32),
        albedo=rng.uniform(0.2, 1.0, (B, 2 * 778, 3)).astype(np.float32),
        light=light, color=rng.uniform(0.5, 1.1, (B, 3)).astype(np.float32),
        ambient=rng.uniform(0.15, 0.45, (B, 3)).astype(np.float32),
        dense=rng.uniform(0.0, 1.0, (2 * 778, 3)).astype(np.float32))


def test_pinhole_project_matches_jax_and_numpy():
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(3, 50, 3)).astype(np.float32)
    pts[..., 2] = np.abs(pts[..., 2]) + 0.5
    K = np.stack([_intrinsics(100.0 + 20 * i, 32.0 + i, 1.1) for i in range(3)])
    uv, depth = pinhole_project(torch.from_numpy(pts), torch.from_numpy(K))
    juv, jdepth = jax_pinhole(jnp.asarray(pts), jnp.asarray(K))
    assert np.abs(uv.numpy() - np.asarray(juv)).max() <= 1e-5
    assert np.array_equal(depth.numpy(), np.asarray(jdepth)) and np.array_equal(depth.numpy(),
                                                                                  pts[..., 2])
    for i in range(3):  # the reference's `p = v @ K.T; uv = p[:, :2] / p[:, 2:]`
        p = pts[i] @ K[i].T
        np.testing.assert_allclose(uv[i].numpy(), p[:, :2] / p[:, 2:], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shading", [dict(), dict(specular=0.15, lit=True),
                                     dict(ao=0.5, soft_shadow=0.5, lit=True)],
                         ids=["default", "phong", "occlusion"])
def test_render_rgb_perspective_matches_jax(scene, shading):
    shading = dict(shading)
    lit = dict(albedo=scene.albedo, light_dir=scene.light, light_color=scene.color,
               ambient=scene.ambient) if shading.pop("lit", False) else {}
    rgb, mask = TwoHandRenderer(scene.assets, RES).render_rgb_perspective(
        torch.from_numpy(scene.K), torch.from_numpy(scene.v_l), torch.from_numpy(scene.v_r),
        **{k: torch.from_numpy(v) for k, v in lit.items()}, **shading)
    jrgb, jmask = JaxRenderer(scene.jax_assets, RES).render_rgb_perspective(
        jnp.asarray(scene.K), jnp.asarray(scene.v_l), jnp.asarray(scene.v_r),
        **{k: jnp.asarray(v) for k, v in lit.items()}, **shading)
    assert rgb.shape == (B, RES, RES, 3) and mask.dtype == torch.bool
    _compare_images(rgb.numpy(), mask.numpy(), jrgb, jmask)


def test_render_mask_perspective_matches_jax(scene):
    mask = TwoHandRenderer(scene.assets, RES).render_mask_perspective(
        torch.from_numpy(scene.K), torch.from_numpy(scene.v_l), torch.from_numpy(scene.v_r))
    jmask = np.asarray(JaxRenderer(scene.jax_assets, RES).render_mask_perspective(
        jnp.asarray(scene.K), jnp.asarray(scene.v_l), jnp.asarray(scene.v_r)))
    assert (mask.numpy() == jmask).mean() >= 0.999 and 0.02 < jmask.mean() < 0.9


def test_render_densepose_matches_jax(scene):
    cams = ({"left": scene.scale, "right": scene.scale},
            {"left": scene.trans_l, "right": scene.trans_r})
    verts = scene.v_l - [0, 0, 0.5], scene.v_r - [0, 0, 0.5]
    attr, mask = TwoHandRenderer(scene.assets, RES).render_densepose(
        *({k: torch.from_numpy(v) for k, v in c.items()} for c in cams),
        *(torch.from_numpy(v.astype(np.float32)) for v in verts), torch.from_numpy(scene.dense))
    jattr, jmask = JaxRenderer(scene.jax_assets, RES).render_densepose(
        *({k: jnp.asarray(v) for k, v in c.items()} for c in cams),
        *(jnp.asarray(v, jnp.float32) for v in verts), jnp.asarray(scene.dense))
    assert attr.shape == (B, RES, RES, 3)
    _compare_images(attr.numpy(), mask.numpy(), jattr, jmask)
    assert (attr.numpy()[~mask.numpy()] == 0).all()


def _hand_pair_at_depth(assets, z0):
    """Both template hands, side by side, centred at camera depth z0."""
    vl = assets.left.mano.v_template.numpy().copy()
    vr = assets.right.mano.v_template.numpy().copy()
    for v, dx in ((vl, -0.06), (vr, 0.06)):
        v -= v.mean(axis=0, keepdims=True)
        v[:, 0] += dx
        v[:, 2] += z0
    return torch.from_numpy(vl[None]), torch.from_numpy(vr[None])


def _orth(s):
    return ({"left": torch.full((1,), s), "right": torch.full((1,), s)},
            {"left": torch.zeros((1, 2)), "right": torch.zeros((1, 2))})


def test_perspective_mask_shrinks_with_depth(scene):
    """Twice as far, about a quarter of the pinhole footprint; the
    orthographic footprint does not change."""
    r = TwoHandRenderer(scene.assets, RES)
    K = torch.from_numpy(np.array([[[120.0, 0, RES / 2], [0, 120.0, RES / 2], [0, 0, 1]]],
                                  np.float32))
    areas, orth = {}, {}
    for name, z0 in (("near", 0.4), ("far", 0.8)):
        vl, vr = _hand_pair_at_depth(scene.assets, z0)
        areas[name] = float(r.render_mask_perspective(K, vl, vr).sum())
        orth[name] = r.render_mask(*_orth(0.5), vl, vr).numpy()
    assert areas["far"] > 0 and 2.5 < areas["near"] / areas["far"] < 6.0
    np.testing.assert_array_equal(orth["near"], orth["far"])


def test_perspective_agrees_with_orth_at_matched_scale(scene):
    """f = s * S * z0 with a centred principal point: nearly the
    orthographic footprint of scale s, but not exactly (foreshortening)."""
    r = TwoHandRenderer(scene.assets, RES)
    z0, s = 0.5, 1.5
    vl, vr = _hand_pair_at_depth(scene.assets, z0)
    f = s * RES * z0
    K = torch.tensor([[[f, 0, RES / 2], [0, f, RES / 2], [0, 0, 1.0]]])
    mp = r.render_mask_perspective(K, vl, vr)[0].numpy()
    mo = r.render_mask(*_orth(s), vl, vr)[0].numpy()
    iou = (mp & mo).sum() / max((mp | mo).sum(), 1)
    assert 0.6 < iou < 0.999, iou


def test_render_rgb_perspective_shades(scene):
    r = TwoHandRenderer(scene.assets, RES)
    vl, vr = _hand_pair_at_depth(scene.assets, 0.5)
    K = torch.tensor([[[60.0, 0, RES / 2], [0, 60.0, RES / 2], [0, 0, 1.0]]])
    rgb, mask = r.render_rgb_perspective(K, vl, vr)
    rgb, mask = rgb.numpy(), mask.numpy()
    assert rgb.shape == (1, RES, RES, 3) and mask.sum() > 0
    assert rgb.min() >= 0 and rgb.max() <= 1
    assert rgb[0][mask[0]].mean() > 0.05 and np.abs(rgb[0][~mask[0]]).max() == 0.0
