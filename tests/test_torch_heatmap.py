"""`renderih_tpu_torch/ops/heatmap.py` against `renderih_tpu/ops/heatmap.py`
on the CPU: the same seeded joints and maps through both, max|Δ| ≤ 1e-6.
The DARK decoder's peaks, up to 64 px, are held within the larger of 1e-6
and one float32 step of JAX's (3.8e-6 between 32 and 64 px, below which
1e-6 cannot be resolved)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderih_tpu.ops import heatmap as jax_heatmap
from renderih_tpu_torch.ops import heatmap

TOL = 1e-6


def _joints(size: int, seed: int) -> np.ndarray:
    """(3, 21, 2) joints over [-size/4, 5/4 size): some outside the frame,
    some near its border."""
    rng = np.random.default_rng(seed)
    j = rng.uniform(-size / 4, 1.25 * size, (3, 21, 2)).astype(np.float32)
    j[0, :4] = [[-0.5, 10.0], [size - 0.5, 3.0], [0.0, size - 1.0], [2.5, -1e-3]]
    return j


def _close(got: torch.Tensor, want, tol: float = TOL):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= tol


def test_heatmap_constants_match_jax():
    assert (heatmap.HEATMAP_SIZE, heatmap.HEATMAP_SIGMA) == (
        jax_heatmap.HEATMAP_SIZE, jax_heatmap.HEATMAP_SIGMA)


@pytest.mark.parametrize("size,sigma", [(64, 2.0), (32, 1.0), (16, 1.0)])
def test_gaussian_heatmaps_match_jax(size, sigma):
    j = _joints(size, size)
    got = heatmap.gaussian_heatmaps(torch.from_numpy(j), size=size, sigma=sigma)
    _close(got, jax_heatmap.gaussian_heatmaps(jnp.asarray(j), size=size, sigma=sigma))
    outside = (j < 0).any(-1) | (j >= size).any(-1)
    assert outside.any() and (~outside).any()
    assert not got[torch.from_numpy(outside)].any()  # out-of-frame joints: all-zero maps
    assert float(got.max()) <= 1.0


def _maps(seed: int) -> np.ndarray:
    """Gaussians at sub-pixel joints plus noise, a flat map (every pixel a
    tie), and peaks on and next to the border."""
    rng = np.random.default_rng(seed)
    j = rng.uniform(-4, 68, (2, 21, 2)).astype(np.float32)
    j[0, :3] = [[0.3, 30.0], [62.7, 1.2], [31.4, 63.0]]
    hm = np.asarray(jax_heatmap.gaussian_heatmaps(jnp.asarray(j), size=64))
    hm = hm + rng.uniform(0, 0.02, hm.shape).astype(np.float32)
    hm[1, 5] = 0.0
    return hm.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_heatmap_argmax_matches_jax(seed):
    hm = _maps(seed)
    xy, vals = heatmap.heatmap_argmax(torch.from_numpy(hm))
    jxy, jvals = jax_heatmap.heatmap_argmax(jnp.asarray(hm))
    _close(xy, jxy, 0.0)
    _close(vals, jvals, 0.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_heatmaps_dark_matches_jax(seed):
    hm = _maps(seed)
    got = heatmap.decode_heatmaps_dark(torch.from_numpy(hm))
    want = np.asarray(jax_heatmap.decode_heatmaps_dark(jnp.asarray(hm)))
    assert got.shape == want.shape
    assert np.all(np.abs(got.numpy() - want) <= np.maximum(TOL, np.spacing(np.abs(want))))
    xy, _ = heatmap.heatmap_argmax(torch.from_numpy(hm))
    moved = (got - xy).abs().amax(-1) > 0
    assert moved.any() and (~moved).any()  # refined peaks and integer fall-backs
