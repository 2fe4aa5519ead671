"""The port's path tracer (`renderih_tpu_torch/render/pathtrace.py`)
against a NumPy oracle and the JAX package on the CPU.

`render_scene` is fed the very uniforms the JAX tracer draws from its keys
(`_jax_draws` rebuilds its key tree). Tolerances: `intersect`'s nearest
triangle equal and t, u, v within 1e-5; a render's hit mask equal, and its
RGB within 1e-4 on at least 99.5% of pixels: a secondary ray that grazes
a triangle edge may hit on one side of the rounding and miss on the other,
and then its pixel's path differs (the share that differs is printed).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderih_tpu.mano.params import make_synthetic_mano as jax_make_mano
from renderih_tpu.render import pathtrace as jax_pt
from renderih_tpu_torch.mano.params import make_synthetic_mano
from renderih_tpu_torch.render import pathtrace as pt
from renderih_tpu_torch.render.renderer import TwoHandRenderer

IMG = 64


def _np_intersect(o, d, v0, e1, e2, eps_det=1e-9, t_min=1e-3):
    """Oracle: the nearest Moller-Trumbore hit of each ray, NumPy loops."""
    best_t = np.full(o.shape[0], np.inf)
    best = np.zeros(o.shape[0], np.int64)
    for i in range(o.shape[0]):
        for j in range(v0.shape[0]):
            h = np.cross(d[i], e2[j])
            a = e1[j] @ h
            if abs(a) <= eps_det:
                continue
            f = 1.0 / a
            s = o[i] - v0[j]
            u = f * (s @ h)
            q = np.cross(s, e1[j])
            v = f * (d[i] @ q)
            t = f * (e2[j] @ q)
            if u >= 0 and v >= 0 and u + v <= 1 and t > t_min and t < best_t[i]:
                best_t[i], best[i] = t, j
    return best_t, best


def test_intersect_matches_numpy_oracle_and_jax():
    """Random triangles and rays (half of them aimed inside a random
    triangle), two scenes batched, chunks of 16 rays with the last one
    padded (R = 70)."""
    rng = np.random.default_rng(0)
    n_tri, n_rays = 40, 70
    scenes = []
    for b in range(2):
        v0, e1, e2 = (rng.normal(size=(n_tri, 3)).astype(np.float32) for _ in range(3))
        o = rng.normal(size=(n_rays, 3)).astype(np.float32) * 3.0
        d = rng.normal(size=(n_rays, 3)).astype(np.float32)
        aim = rng.integers(0, n_tri, n_rays // 2)
        d[:n_rays // 2] = v0[aim] + 0.3 * e1[aim] + 0.3 * e2[aim] - o[:n_rays // 2]
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        scenes.append((v0, e1, e2, o, d))
    stack = [np.stack(x) for x in zip(*scenes)]
    zeros = torch.zeros((2, n_tri, 3, 3))
    scene = pt.Scene(*(torch.from_numpy(a) for a in stack[:3]), zeros, zeros)
    t, tri, u, v = (x.numpy() for x in pt.intersect(torch.from_numpy(stack[3]),
                                                    torch.from_numpy(stack[4]), scene, chunk=16))
    for b, (v0, e1, e2, o, d) in enumerate(scenes):
        t_ref, tri_ref = _np_intersect(o, d, v0, e1, e2)
        hit = np.isfinite(t_ref)
        assert np.array_equal(np.isfinite(t[b]), hit) and hit.mean() > 0.4
        np.testing.assert_allclose(t[b][hit], t_ref[hit], rtol=2e-4, atol=2e-4)
        assert np.array_equal(tri[b][hit], tri_ref[hit])
        jscene = jax_pt.Scene(jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2),
                              jnp.zeros((n_tri, 3, 3)), jnp.zeros((n_tri, 3, 3)))
        jt, jtri, ju, jv = (np.asarray(x) for x in jax_pt.intersect(
            jnp.asarray(o), jnp.asarray(d), jscene, chunk=16))
        assert np.array_equal(tri[b], jtri) and np.array_equal(np.isfinite(t[b]), np.isfinite(jt))
        for got, want in ((t[b], jt), (u[b], ju), (v[b], jv)):  # at hits: on a miss u, v
            np.testing.assert_allclose(got[hit], want[hit], atol=1e-5)  # extrapolate triangle 0


def _manos():
    return (SimpleNamespace(left=SimpleNamespace(mano=make_synthetic_mano(0, False)),
                            right=SimpleNamespace(mano=make_synthetic_mano(0, True))),
            SimpleNamespace(left=SimpleNamespace(mano=jax_make_mano(0, False)),
                            right=SimpleNamespace(mano=jax_make_mano(0, True))))


@pytest.fixture(scope="module")
def setup():
    """The JAX tests' two template hands side by side, and a second scene
    with the right hand turned and in front (B = 2), at scale 2 (a quarter
    of the frame covered; the property tests take the JAX tests' 0.8)."""
    assets, jax_assets = _manos()
    vl = assets.left.mano.v_template.numpy()
    vr = assets.right.mano.v_template.numpy() + np.array([0.12, 0.0, 0.0], np.float32)
    vr2 = vr[:, [2, 1, 0]] * np.array([1.0, 1.0, -1.0], np.float32) + np.array(
        [-0.05, 0.02, -0.03], np.float32)
    rng = np.random.default_rng(1)
    return SimpleNamespace(
        assets=assets, jax_assets=jax_assets,
        vl=np.stack([vl, vl]), vr=np.stack([vr, vr2]).astype(np.float32),
        scale={"left": np.full((2,), 2.0, np.float32), "right": np.full((2,), 2.0, np.float32)},
        trans2d={"left": np.array([[-0.15, 0.0], [-0.1, 0.05]], np.float32),
                 "right": np.array([[0.15, 0.0], [0.05, 0.0]], np.float32)},
        albedo=rng.uniform(0.3, 0.9, (2, 2 * 778, 3)).astype(np.float32),
        light=np.array([[0.4, -0.3, -0.85], [-1.0, 0.2, -0.35]], np.float32))


def _t(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _jax_draws(key, bs, spp, n_bounces, n_rays) -> pt.PathDraws:
    """The uniforms JAX's `TwoHandPathTracer.render(..., key)` draws: a key
    a scene (split), folded with the sample index, split into 2 * bounces
    + 2 (NEE at vertex 0 from key 0, bounce b from 2b + 1, NEE after it
    from 2b + 2), each split in two inside `_disk_sample` / `_cosine_sample`."""
    out = {k: np.zeros((bs, spp, e, n_rays), np.float32) for k, e in (
        ("disk_r", n_bounces + 1), ("disk_phi", n_bounces + 1), ("cos_r1", n_bounces),
        ("cos_r2", n_bounces))}
    for b, kb in enumerate(jax.random.split(key, bs)):
        for i in range(spp):
            ks = jax.random.split(jax.random.fold_in(kb, i), 2 * n_bounces + 2)
            for e, k in enumerate([ks[0]] + [ks[2 * j + 2] for j in range(n_bounces)]):
                k1, k2 = jax.random.split(k)
                out["disk_r"][b, i, e] = jax.random.uniform(k1, (n_rays,))
                out["disk_phi"][b, i, e] = jax.random.uniform(k2, (n_rays,))
            for j in range(n_bounces):
                k1, k2 = jax.random.split(ks[2 * j + 1])
                out["cos_r1"][b, i, j] = jax.random.uniform(k1, (n_rays,))
                out["cos_r2"][b, i, j] = jax.random.uniform(k2, (n_rays,))
    return pt.PathDraws(**{k: torch.from_numpy(v) for k, v in out.items()})


@pytest.mark.parametrize("size,spp,bounces,tonemap",
                         [(32, 2, 1, True), (48, 2, 2, False)])
def test_render_matches_jax_on_its_draws(setup, size, spp, bounces, tonemap):
    key = jax.random.PRNGKey(7)
    draws = _jax_draws(key, 2, spp, bounces, size * size)
    rgb, mask = pt.TwoHandPathTracer(setup.assets, size).render(
        _t(setup.scale), _t(setup.trans2d), torch.from_numpy(setup.vl),
        torch.from_numpy(setup.vr), torch.from_numpy(setup.albedo), draws=draws,
        light_dir=torch.from_numpy(setup.light), spp=spp, n_bounces=bounces, tonemap=tonemap)
    jrgb, jmask = jax_pt.TwoHandPathTracer(setup.jax_assets, size).render(
        _j(setup.scale), _j(setup.trans2d), jnp.asarray(setup.vl), jnp.asarray(setup.vr),
        jnp.asarray(setup.albedo), key, light_dir=jnp.asarray(setup.light), spp=spp,
        n_bounces=bounces, tonemap=tonemap)
    rgb, mask, jrgb, jmask = rgb.numpy(), mask.numpy(), np.asarray(jrgb), np.asarray(jmask)
    assert rgb.shape == (2, size, size, 3) and mask.dtype == np.float32
    assert np.array_equal(mask, jmask) and 0.05 < mask.mean() < 0.9
    close = np.abs(rgb - jrgb).max(-1) <= 1e-4
    print(f"path tracer {size}² spp {spp} bounces {bounces}: {100 * (1 - close.mean()):.3f}% "
          f"of pixels beyond 1e-4 of JAX (max |Δ| {np.abs(rgb - jrgb).max():.3e})")
    assert close.mean() >= 0.995
    assert np.isfinite(rgb).all() and rgb[mask > 0.5].mean() > 0.01


def _tracer_inputs(setup):
    """Scene 0 as the JAX property tests place it (scale 0.8)."""
    return ({"left": torch.full((1,), 0.8), "right": torch.full((1,), 0.8)},
            {k: torch.from_numpy(v[:1]) for k, v in setup.trans2d.items()},
            torch.from_numpy(setup.vl[:1]), torch.from_numpy(setup.vr[:1]))


def test_mask_matches_rasterizer(setup):
    """Same camera and geometry: the primary hits are the rasteriser's
    coverage but for edge pixels (the JAX test's bar, IoU > 0.93)."""
    scale, trans2d, vl, vr = _tracer_inputs(setup)
    _, mask_pt = pt.TwoHandPathTracer(setup.assets, IMG).render(
        scale, trans2d, vl, vr, torch.full((1, 2 * 778, 3), 0.7),
        torch.Generator().manual_seed(0), spp=1, n_bounces=0)
    mask_ra = TwoHandRenderer(setup.assets, IMG).render_mask(scale, trans2d, vl, vr)
    a, b = mask_pt[0].numpy() > 0.5, mask_ra[0].numpy()
    assert (a & b).sum() / max((a | b).sum(), 1) > 0.93


def _render(setup, seed, vr=None, **kw):
    scale, trans2d, vl, vr0 = _tracer_inputs(setup)
    return pt.TwoHandPathTracer(setup.assets, IMG).render(
        scale, trans2d, vl, vr0 if vr is None else vr, torch.full((1, 2 * 778, 3), 0.7),
        torch.Generator().manual_seed(seed), **kw)


def test_render_finite_and_lit(setup):
    rgb, mask = _render(setup, 1, spp=2, n_bounces=1)
    rgb, mask = rgb[0].numpy(), mask[0].numpy()
    assert np.isfinite(rgb).all() and rgb.min() >= 0.0 and rgb.max() <= 1.0
    assert rgb[mask > 0.5].mean() > 0.05
    assert np.abs(rgb[mask < 0.5]).max() == 0.0


def test_shadowing_darkens_occluded_side(setup):
    """Light from +x: the left hand loses direct light where the right
    hand occludes it, against the right hand moved out of every path."""
    light = torch.tensor([[-1.0, 0.0, -0.35]])
    kw = dict(light_dir=light, spp=4, n_bounces=0, tonemap=False)
    rgb_pair, mask_pair = _render(setup, 2, **kw)
    vr_far = torch.from_numpy(setup.vr[:1]) + torch.tensor([0.0, 0.0, 50.0])
    rgb_solo, mask_solo = _render(setup, 2, vr=vr_far, **kw)
    m = (mask_pair[0].numpy() > 0.5) & (mask_solo[0].numpy() > 0.5)
    m[:, IMG // 2:] = False
    assert m.sum() > 50
    assert rgb_pair[0].numpy()[m].mean() < rgb_solo[0].numpy()[m].mean() * 0.98


def test_bounces_add_interreflection(setup):
    """With no environment light, bounces add only interreflection:
    non-negative and more energy in all."""
    kw = dict(env_radiance=(0.0, 0.0, 0.0), tonemap=False, spp=4)
    rgb0, _ = _render(setup, 3, n_bounces=0, **kw)
    rgb2, _ = _render(setup, 3, n_bounces=2, **kw)
    assert rgb2.min() >= 0.0 and rgb2.mean() > rgb0.mean() * 1.01


def test_synth_gen_pathtrace_on_the_cpu(tmp_path, monkeypatch):
    """`synth_gen --renderer pathtrace --device cpu`, one sample at 64² (a
    256² sample takes ~20 s a pass on the CPU), 2 samples a pixel, one
    bounce: the packed image shows a rendered scene, the labels are finite,
    and the tracer rendered with the CLI's spp and bounces."""
    from renderih_tpu_torch.tools import synth_gen

    calls = []
    real = pt.TwoHandPathTracer.render

    def spy(self, *args, **kwargs):
        calls.append((self.img_size, kwargs["spp"], kwargs["n_bounces"]))
        return real(self, *args, **kwargs)

    monkeypatch.setattr(pt.TwoHandPathTracer, "render", spy)
    monkeypatch.setattr(synth_gen, "IMG_SIZE", IMG)
    result = synth_gen.main(["--out", str(tmp_path), "--n", "1", "--batch", "1",
                             "--renderer", "pathtrace", "--spp", "2", "--bounces", "1",
                             "--device", "cpu"])
    assert calls == [(IMG, 2, 1)]
    img = np.memmap(tmp_path / "train_images.u8", np.uint8, "r", shape=(1, IMG, IMG, 3))
    labels = dict(np.load(tmp_path / "train_labels.npz"))
    assert img.std() > 5 and all(np.isfinite(v).all() for v in labels.values())
    assert result["n"] == 1 and result["images_per_s"] > 0
