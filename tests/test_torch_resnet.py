"""The port's ResNet trunks + ResNetMid against the JAX package, eval mode,
f32, same weights (carried with `utils/weights.py`) and random BN
statistics, on the CPU (plain conv path)."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from renderih_tpu.models.resnet import ResNet as JaxResNet
from renderih_tpu.models.resnet import ResNetMid as JaxResNetMid
from renderih_tpu_torch.models.resnet import ResNet, ResNetMid
from renderih_tpu_torch.utils import weights


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class _JaxEncMid(nn.Module):
    model_type: str

    @nn.compact
    def __call__(self, x):
        pyramid = JaxResNet(self.model_type, name="encoder")(x)
        return pyramid, JaxResNetMid(name="mid")(pyramid)


def _random_stats(stats, rng):
    """BN statistics away from (0, 1), so a BN mapping error shows."""
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 1.5, a.shape) if path[-1].key == "var"
                         else rng.normal(0.0, 0.1, a.shape)).astype(np.float32),
        stats)


@pytest.mark.parametrize("model_type", ["resnet50", "resnet18"])
def test_resnet_and_mid_match_jax(model_type):
    rng = np.random.default_rng(0)
    img = rng.normal(size=(1, 64, 64, 3)).astype(np.float32)
    jm = _JaxEncMid(model_type)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(img))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = _random_stats(variables["batch_stats"], rng)
    pyramid_j, (gf_j, fmaps_j) = jax.jit(jm.apply)(
        {"params": params, "batch_stats": stats}, jnp.asarray(img))

    resnet = ResNet(model_type)
    mid = ResNetMid(resnet.pyramid_dims)
    sd_enc, sd_mid = {}, {}
    weights._resnet(params["encoder"], stats["encoder"], "m", sd_enc)
    weights._mid(params["mid"], stats["mid"], "m", sd_mid)
    resnet.load_state_dict({k[2:]: v for k, v in sd_enc.items()})
    mid.load_state_dict({k[2:]: v for k, v in sd_mid.items()})
    resnet.eval()
    mid.eval()
    with torch.no_grad():
        x = torch.from_numpy(img).permute(0, 3, 1, 2)  # channels_last view
        pyramid = resnet(x)
        gf, fmaps = mid(pyramid)

    for got, want in zip(pyramid + fmaps, list(pyramid_j) + list(fmaps_j)):
        want = np.asarray(want)
        got = got.permute(0, 2, 3, 1).numpy()
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=1e-4)
    np.testing.assert_allclose(gf.numpy(), np.asarray(gf_j), rtol=1e-4,
                               atol=1e-5 * np.abs(np.asarray(gf_j)).max())
