"""The port's CUDA kernels and main path on the card (marker `gpu`).

Every test takes the `cuda` fixture, which skips where there is no card;
elsewhere these tests are collected and skipped. This file imports no JAX,
so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py

The kernels build from `renderih_tpu_torch/csrc/` at first use (nvcc).
Float32 references run with TF32 off in cuDNN and cuBLAS.
"""

import numpy as np
import pytest
import torch

from renderih_tpu_torch.assets import make_synthetic_assets
from renderih_tpu_torch.config import load_config
from renderih_tpu_torch.kernels import conv3x3, fused_attention
from renderih_tpu_torch.serve import InferenceEngine

pytestmark = pytest.mark.gpu

# bf16: 2 units in the last place of the output; f32: summation order only
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1.6e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    torch.backends.cuda.matmul.allow_tf32 = matmul_tf32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 7, 7, 24, 40), (3, 13, 21, 64, 72),
                                   (2, 8, 8, 512, 512), (2, 64, 64, 64, 64)])
def test_conv3x3_kernel_matches_plain(cuda, shape, dtype):
    b, h, w, cin, cout = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(b, h, w, cin, device=cuda, generator=g).to(dtype)
    k = (torch.randn(3, 3, cin, cout, device=cuda, generator=g)
         / (9 * cin) ** 0.5).to(dtype)
    n = conv3x3.launches.value
    got = conv3x3.conv3x3_same(x, k)
    torch.cuda.synchronize()
    assert conv3x3.launches.value == n + 1
    assert got.shape == (b, h, w, cout) and got.dtype == dtype
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), conv3x3.conv3x3_reference(x, k).float(),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("cout", [36, 64])
def test_conv3x3_bf16_off_the_tensor_core_layout(cuda, cout):
    """A bf16 input that is contiguous but not 16-byte aligned, or a Cout
    that is no multiple of 8, runs on the CUDA-core kernel: same answer."""
    g = torch.Generator(device=cuda).manual_seed(2)
    n = 2 * 9 * 11 * 32
    x = torch.randn(n + 1, device=cuda, generator=g).bfloat16()[1:].view(2, 9, 11, 32)
    k = (torch.randn(3, 3, 32, cout, device=cuda, generator=g) / 17.0).bfloat16()
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    got = conv3x3.conv3x3_same(x, k)
    torch.testing.assert_close(got.float(), conv3x3.conv3x3_reference(x, k).float(),
                               atol=TOL[torch.bfloat16][0], rtol=TOL[torch.bfloat16][1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,m,d", [(61, 61, 64), (63, 127, 32), (308, 308, 16),
                                   (1, 5, 16), (64, 64, 64)])
def test_fused_mha_kernel_matches_plain(cuda, n, m, d, dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(3, n, 4, d, device=cuda, generator=g).to(dtype)
    k = torch.randn(3, m, 4, d, device=cuda, generator=g).to(dtype)
    v = torch.randn(3, m, 4, d, device=cuda, generator=g).to(dtype)
    got = fused_attention.fused_mha(q, k, v)
    torch.cuda.synchronize()
    assert got.shape == (3, n, 4 * d) and got.dtype == dtype
    want = fused_attention.mha_reference(q.float(), k.float(), v.float())
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)


def test_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.randn(1, 8, 8, 16, device=cuda)
    w = torch.randn(3, 3, 16, 16, device=cuda)
    with pytest.raises(TypeError):
        conv3x3.conv3x3_same(x.half(), w.half())
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3.conv3x3_same(x.transpose(1, 2), w)
    with pytest.raises(RuntimeError, match="backward"):
        conv3x3.conv3x3_same(x, w.requires_grad_())
    q = torch.randn(1, 5, 4, 8, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fused_attention.fused_mha(q, q, q)


def test_engine_on_card_matches_cpu_and_launches_the_kernels(cuda):
    """A small resnet18 config whose head dims (64, 32, 16) the attention
    kernel takes: f32 card (kernels) vs CPU (plain versions), and 13 conv
    + 24 attention launches per forward."""
    cfg = load_config(overrides={
        "model": {"encoder": "resnet18", "img_size": 128, "grid_size": 4,
                  "graph_layer_num": 2},
        "train": {"precision": "f32"}})
    assets = make_synthetic_assets(0)
    imgs = np.random.default_rng(0).integers(0, 256, (3, 128, 128, 3),
                                             dtype=np.uint8)
    card = InferenceEngine(cfg, assets=assets, buckets=(4,), device=cuda)
    n_conv, n_mha = conv3x3.launches.value, fused_attention.launches.value
    got = card.predict(imgs)
    assert conv3x3.launches.value - n_conv == 13
    assert fused_attention.launches.value - n_mha == 24
    want = InferenceEngine(cfg, assets=assets, buckets=(4,), device="cpu").predict(imgs)
    for key, ref in want.items():
        assert got[key].shape == ref.shape
        err = np.abs(got[key] - ref).max() / max(np.abs(ref).max(), 1e-6)
        assert err <= 1e-4, f"{key}: rel max|Δ| {err:.3e}"
