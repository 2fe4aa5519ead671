"""The GAN pose prior of the port on the CPU: `make_gan_pose_prior`'s
energy and gradient on the shipped discriminator against the JAX
package's, the port's own copy of that artifact, and
`tools/train_pose_prior.py` at a small size (its artifact read back by
the JAX package)."""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderih_tpu.optimize import geo as jax_geo
from renderih_tpu_torch.optimize import geo
from renderih_tpu_torch.tools import train_pose_prior

JAX_ARTIFACT = os.path.join(os.path.dirname(jax_geo.__file__), "..", "assets_data",
                            "pose_prior.npz")


def _poses(n: int, seed: int) -> np.ndarray:
    """Seeded axis-angle poses, plausible (scale 0.3) to implausible (1.5)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 45)) * np.linspace(0.3, 1.5, n)[:, None]).astype(np.float32)


def test_the_port_reads_its_own_copy_of_the_artifact():
    assert os.path.dirname(geo.POSE_PRIOR_PATH) == os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(geo.__file__))), "assets_data")
    assert filecmp.cmp(geo.POSE_PRIOR_PATH, JAX_ARTIFACT, shallow=False)


def test_gan_prior_energy_and_gradient_match_jax():
    jprior = jax.jit(jax.value_and_grad(
        jax_geo.make_gan_pose_prior(jax_geo.load_pose_prior(JAX_ARTIFACT))))
    prior = geo.make_gan_pose_prior(geo.load_pose_prior(geo.POSE_PRIOR_PATH))
    energies = []
    for pose in _poses(6, 0):
        want, jgrad = jprior(jnp.asarray(pose))
        x = torch.from_numpy(pose).requires_grad_(True)
        got = prior(x)
        got.backward()
        energies.append(float(got.detach()))
        assert got.shape == () and abs(energies[-1] - float(want)) <= 1e-5 * max(1.0, abs(float(want)))
        g = np.asarray(jgrad)
        assert np.abs(x.grad.numpy() - g).max() <= 1e-5 * max(1.0, np.abs(g).max())
    # the trained discriminator scores the implausible end higher
    assert energies[-1] > energies[0]


def test_train_pose_prior_on_the_cpu(tmp_path):
    out = tmp_path / "prior.npz"
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        result = train_pose_prior.main(["--out", str(out), "--steps", "120", "--batch", "64",
                                        "--device", "cpu"])
    finally:
        torch.set_num_threads(prev)
    losses = result["losses"]
    assert losses.shape == (120,) and np.isfinite(losses).all()
    assert losses[-20:].mean() < 0.5 * losses[:5].mean()
    assert result["real_logit"] > result["fake_logit"] and result["device"] == "cpu"
    # the artifact is the JAX layout: JAX's prior on it equals the port's
    jparams = jax_geo.load_pose_prior(str(out))
    shipped = jax_geo.load_pose_prior(JAX_ARTIFACT)
    assert jax.tree_util.tree_structure(jparams) == jax.tree_util.tree_structure(shipped)
    for a, b in zip(jax.tree_util.tree_leaves(jparams), jax.tree_util.tree_leaves(shipped)):
        assert a.shape == b.shape
    jprior = jax_geo.make_gan_pose_prior(jparams)
    prior = geo.make_gan_pose_prior(geo.load_pose_prior(str(out)))
    for pose in _poses(3, 1):
        with torch.no_grad():
            got = float(prior(torch.from_numpy(pose)))
        assert abs(got - float(jprior(jnp.asarray(pose)))) <= 1e-5 * max(1.0, abs(got))


@pytest.mark.parametrize("n", [6, 300])
def test_fake_sampler_mixes_three_families(n):
    gen = torch.Generator().manual_seed(0)
    fake = train_pose_prior.sample_fake(gen, n)
    real = train_pose_prior.sample_real(gen, n)
    assert fake.shape == real.shape == (n, 45)
    if n == 300:  # the fakes are further from the rest pose on average
        assert float(fake.abs().mean()) > 2 * float(real.abs().mean())
