"""The port's rasteriser, renderer and procedural backgrounds against the
JAX package on the CPU, at 64² on the synthetic two-hand mesh.

Tolerances: the coverage masks agree on >= 99.9% of pixels (a pixel centre
on a shared edge may fall to either face, or to none, when the edge
functions round differently) and the colours within 1e-4 where they do;
the background and albedo transforms, fed the very draws the JAX functions
make from their keys, within 1e-5 (bilinear resizes in float32).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderih_tpu.mano.params import make_synthetic_mano as jax_make_mano
from renderih_tpu.render import backgrounds as jax_bg
from renderih_tpu.render.rasterize import pick_row_block as jax_pick_row_block
from renderih_tpu.render.rasterize import rasterize_orthographic as jax_rasterize
from renderih_tpu.render.renderer import TwoHandRenderer as JaxRenderer
from renderih_tpu_torch.mano.layer import mano_forward
from renderih_tpu_torch.mano.params import make_synthetic_mano
from renderih_tpu_torch.ops.rotation import rodrigues
from renderih_tpu_torch.render import backgrounds as bg
from renderih_tpu_torch.render.rasterize import pick_row_block, rasterize_orthographic
from renderih_tpu_torch.render.renderer import TwoHandRenderer

SIZE = 64
B = 2


@pytest.fixture(scope="module")
def scene():
    """Two posed hands, cameras, albedo and lights, all from numpy."""
    torch_assets = SimpleNamespace(left=SimpleNamespace(mano=make_synthetic_mano(0, False)),
                                   right=SimpleNamespace(mano=make_synthetic_mano(0, True)))
    jax_assets = SimpleNamespace(left=SimpleNamespace(mano=jax_make_mano(0, False)),
                                 right=SimpleNamespace(mano=jax_make_mano(0, True)))
    rng = np.random.default_rng(0)
    verts = []
    for mano in (torch_assets.left.mano, torch_assets.right.mano):
        root = torch.from_numpy(rng.normal(0, 0.8, (B, 3)).astype(np.float32))
        pose = torch.from_numpy(rng.normal(0, 0.4, (B, 45)).astype(np.float32))
        v, _ = mano_forward(mano, rodrigues(root), pose, torch.zeros(B, 10), use_pca=False)
        verts.append(v.numpy())
    verts[1] = verts[1] + np.array([0.03, 0.0, 0.01], np.float32)
    light = rng.normal(size=(B, 3)).astype(np.float32)
    light[:, 2] = -np.abs(light[:, 2]) - 0.5
    light /= np.linalg.norm(light, axis=1, keepdims=True)
    return SimpleNamespace(
        torch_assets=torch_assets, jax_assets=jax_assets, v_l=verts[0], v_r=verts[1],
        scale=np.full((B,), 4.0, np.float32),
        trans_l=rng.uniform(-0.3, -0.1, (B, 2)).astype(np.float32),
        trans_r=rng.uniform(0.0, 0.2, (B, 2)).astype(np.float32),
        albedo=rng.uniform(0.2, 1.0, (B, 2 * 778, 3)).astype(np.float32),
        light=light, color=rng.uniform(0.5, 1.1, (B, 3)).astype(np.float32),
        ambient=rng.uniform(0.15, 0.45, (B, 3)).astype(np.float32))


def _compare_images(rgb, mask, jrgb, jmask):
    rgb, mask, jrgb, jmask = (np.asarray(a) for a in (rgb, mask, jrgb, jmask))
    assert rgb.shape == jrgb.shape and mask.shape == jmask.shape
    agree = mask == jmask
    assert agree.mean() >= 0.999, agree.mean()
    assert 0.02 < jmask.mean() < 0.9
    np.testing.assert_allclose(rgb[agree], jrgb[agree], atol=1e-4)


def test_rasterize_matches_jax(scene):
    rng = np.random.default_rng(1)
    faces = scene.torch_assets.left.mano.faces
    v2d = (scene.v_l[..., :2] * 4.0 * SIZE + SIZE / 2).astype(np.float32)
    z = scene.v_l[..., 2].copy()
    attrs = rng.uniform(size=(B, 778, 4)).astype(np.float32)
    attr, mask, zbuf = rasterize_orthographic(torch.from_numpy(v2d), torch.from_numpy(z),
                                              torch.from_numpy(attrs), faces, SIZE, SIZE,
                                              row_block=8)
    jattr, jmask, jzbuf = jax.vmap(lambda a, b, c: jax_rasterize(
        a, b, c, jnp.asarray(faces.numpy(), jnp.int32), height=SIZE, width=SIZE,
        row_block=8))(jnp.asarray(v2d), jnp.asarray(z), jnp.asarray(attrs))
    _compare_images(attr.numpy(), mask.numpy(), jattr, jmask)
    both = mask.numpy() & np.asarray(jmask)
    np.testing.assert_allclose(zbuf.numpy()[both], np.asarray(jzbuf)[both], atol=1e-6)
    assert np.isinf(zbuf.numpy()[~mask.numpy()]).all()
    assert (attr.numpy()[~mask.numpy()] == 0).all()


@pytest.mark.parametrize("shading", [
    dict(specular=0.15), dict(specular=0.0, ao=0.5, soft_shadow=0.5), dict(default=True)])
def test_render_rgb_orth_matches_jax(scene, shading):
    shading = dict(shading)
    default = shading.pop("default", False)
    lit = {} if default else dict(albedo=scene.albedo, light_dir=scene.light,
                                  light_color=scene.color, ambient=scene.ambient)
    cams = ({"left": scene.scale, "right": scene.scale},
            {"left": scene.trans_l, "right": scene.trans_r})
    t = {k: torch.from_numpy(v) for k, v in lit.items()}
    rgb, mask = TwoHandRenderer(scene.torch_assets, SIZE).render_rgb_orth(
        *({k: torch.from_numpy(v) for k, v in c.items()} for c in cams),
        torch.from_numpy(scene.v_l), torch.from_numpy(scene.v_r), **t, **shading)
    jrgb, jmask = JaxRenderer(scene.jax_assets, SIZE).render_rgb_orth(
        *({k: jnp.asarray(v) for k, v in c.items()} for c in cams),
        jnp.asarray(scene.v_l), jnp.asarray(scene.v_r),
        **{k: jnp.asarray(v) for k, v in lit.items()}, **shading)
    assert rgb.shape == (B, SIZE, SIZE, 3) and mask.dtype == torch.bool
    _compare_images(rgb.numpy(), mask.numpy(), jrgb, jmask)


def test_pick_row_block_matches_jax():
    for args in ((32, 256, 256, 3104), (2, 256, 256, 3104), (1, 64, 64, 12), (64, 256, 256, 3076)):
        assert pick_row_block(*args) == jax_pick_row_block(*args)
    assert pick_row_block(32, 256, 256, 3104) == 2


def test_background_transforms_match_jax_on_its_draws():
    """Draw exactly what `random_background(key, ...)` draws from its key,
    feed the port's transforms, compare with the JAX function's output."""
    key, bs = jax.random.PRNGKey(3), 4
    k_kind, k_solid, k_grad, k_noise, k_tint = jax.random.split(key, 5)
    kind = jax.random.randint(k_kind, (bs,), 0, 4)
    solid = jax.random.uniform(k_solid, (bs, 1, 1, 3))
    g1, g2, g3 = jax.random.split(k_grad, 3)
    c0, c1 = jax.random.uniform(g1, (bs, 1, 1, 3)), jax.random.uniform(g2, (bs, 1, 1, 3))
    theta = jax.random.uniform(g3, (bs,), minval=0.0, maxval=2 * jnp.pi)
    grids = [jax.random.uniform(k, (bs, 4 * 2 ** i, 4 * 2 ** i, 3))
             for i, k in enumerate(jax.random.split(k_noise, 4))]
    tint = jax.random.uniform(k_tint, (bs, 1, 1, 3), minval=0.3, maxval=1.0)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    noise = bg.value_noise([t(g) for g in grids], SIZE)
    np.testing.assert_allclose(noise.numpy(), np.asarray(jax_bg._value_noise(k_noise, bs, SIZE)),
                               atol=1e-5)
    grad = bg.gradient(t(c0), t(c1), t(theta), SIZE)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jax_bg._gradient(k_grad, bs, SIZE)),
                               atol=1e-5)
    got = bg.background(t(kind).long(), t(solid), grad, noise, t(tint))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_bg.random_background(key, bs, SIZE)),
                               atol=1e-5)
    assert len(set(np.asarray(kind).tolist())) > 1


def test_albedo_and_lighting_transforms_match_jax_on_its_draws():
    key, bs, nv = jax.random.PRNGKey(4), 3, 778
    k_tone, k_jit, k_var = jax.random.split(key, 3)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    albedo = bg.skin_albedo(t(jax.random.uniform(k_tone, (bs, 1))),
                            t(jax.random.normal(k_jit, (bs, 3))),
                            t(jax.random.normal(k_var, (bs, 16, 3))), nv)
    np.testing.assert_allclose(albedo.numpy(), np.asarray(jax_bg.random_skin_albedo(key, bs, nv)),
                               atol=1e-5)
    k_dir, k_col, k_amb = jax.random.split(key, 3)
    light = bg.lighting(
        t(jax.random.normal(k_dir, (bs, 3))),
        t(jax.random.uniform(k_col, (bs, 1), minval=0.5, maxval=1.1)),
        t(jax.random.uniform(jax.random.fold_in(k_col, 1), (bs, 3), minval=0.9, maxval=1.0)),
        t(jax.random.uniform(k_amb, (bs, 1), minval=0.15, maxval=0.45)))
    for got, want in zip(light, jax_bg.random_lighting(key, bs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_random_draws_come_from_the_generator():
    g1, g2 = (torch.Generator().manual_seed(7) for _ in range(2))
    a = bg.random_background(g1, 2, 32)
    torch.testing.assert_close(a, bg.random_background(g2, 2, 32))
    assert a.shape == (2, 32, 32, 3) and 0 <= a.min() and a.max() <= 1
    alb = bg.random_skin_albedo(g1, 2, 778)
    assert alb.shape == (2, 1556, 3) and alb.min() >= 0.05
    d, c, amb = bg.random_lighting(g1, 2)
    torch.testing.assert_close(d.norm(dim=-1), torch.ones(2))
    assert (d[:, 2] < 0).all() and c.shape == amb.shape == (2, 3)
