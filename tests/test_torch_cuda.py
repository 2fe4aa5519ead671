"""The port's CUDA kernels and main path on the card (marker `gpu`).

Every test takes the `cuda` fixture or the module's `staged_engine`, each
of which skips where there is no card; elsewhere these tests are collected
and skipped. This file imports no JAX,
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
from renderih_tpu_torch.kernels import conv3x3, fused_attention, sdf
from renderih_tpu_torch.mano.layer import mano_forward
from renderih_tpu_torch.mano.params import make_synthetic_mano
from renderih_tpu_torch.ops.rotation import rodrigues
from renderih_tpu_torch.serve import InferenceEngine, ungraph
from renderih_tpu_torch.tools import synth_gen
from renderih_tpu_torch.utils import trace

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


def _routes():
    return {name: c.value for name, c in conv3x3.routes.items()}


def _graph_counts():
    names = ("graph_captures", "graph_replays", "eager_forwards")
    return np.array([trace.counters()[f"engine.{n}"] for n in names])


def _graphed_then_eager(engine, imgs, b2, b1):
    """`engine.predict(imgs)` (one chunk) replayed from the graphs the
    engine captured as it was built, then with its eager parts put back
    (`ungraph`): each call launches B2 `b2` and B1 `b1` times, the first
    replays its parts (three; four with a ViT's pyramid head) and runs none
    eagerly, and the answers are equal bit for bit. The replayed answers."""
    parts = 4 if engine.model.vit else 3
    runs = []
    for graphed in (True, False):
        counts = _graph_counts()
        launches = (conv3x3.launches.value, fused_attention.launches.value)
        runs.append(engine.predict(imgs))
        assert conv3x3.launches.value - launches[0] == b2
        assert fused_attention.launches.value - launches[1] == b1
        assert (_graph_counts() - counts).tolist() == ([0, parts, 0] if graphed else [0, 0, 0])
        if graphed:
            ungraph(engine)
    for key, want in runs[1].items():
        assert np.array_equal(runs[0][key], want), key
    return runs[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 7, 7, 24, 40), (3, 13, 21, 64, 72), (2, 8, 8, 512, 512), (2, 64, 64, 64, 64),
    # Cin no multiple of a 32/64 chunk; Cout no multiple of the N tile
    (2, 9, 11, 16, 64), (2, 10, 12, 48, 32), (2, 11, 9, 32, 136),
    # small maps: images folded into M, a ragged last group of images
    (1, 5, 7, 32, 64), (3, 5, 7, 32, 64), (1, 8, 8, 64, 128), (3, 8, 8, 64, 128),
    # Cin or Cout no multiple of 8 (HRNet-W18's 18 and 36 channels): simt in
    # both dtypes; Cin 8, 24 (one and three f32 chunks): tf32x3, simt in bf16
    (2, 9, 11, 18, 36), (2, 12, 10, 36, 72), (2, 10, 9, 24, 20), (2, 10, 9, 24, 40),
    (2, 17, 19, 8, 16)])
def test_conv3x3_kernel_matches_plain(cuda, shape, dtype):
    b, h, w, cin, cout = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(b, h, w, cin, device=cuda, generator=g).to(dtype)
    k = (torch.randn(3, 3, cin, cout, device=cuda, generator=g)
         / (9 * cin) ** 0.5).to(dtype)
    n, routes = conv3x3.launches.value, _routes()
    got = conv3x3.conv3x3_same(x, k)
    torch.cuda.synchronize()
    assert conv3x3.launches.value == n + 1
    routes[conv3x3.route(dtype, cin, cout)] += 1
    assert _routes() == routes
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
    simt = conv3x3.routes["simt"].value
    got = conv3x3.conv3x3_same(x, k)
    assert conv3x3.routes["simt"].value == simt + 1
    torch.testing.assert_close(got.float(), conv3x3.conv3x3_reference(x, k).float(),
                               atol=TOL[torch.bfloat16][0], rtol=TOL[torch.bfloat16][1])


def test_conv3x3_f32_off_the_tensor_core_layout(cuda):
    """A float32 input that is contiguous but not 16-byte aligned runs on
    the CUDA-core kernel: same answer, and no `tf32x3` launch."""
    g = torch.Generator(device=cuda).manual_seed(3)
    n = 2 * 9 * 11 * 32
    x = torch.randn(n + 1, device=cuda, generator=g)[1:].view(2, 9, 11, 32)
    k = torch.randn(3, 3, 32, 64, device=cuda, generator=g) / 17.0
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    routes = _routes()
    got = conv3x3.conv3x3_same(x, k)
    routes["simt"] += 1
    assert _routes() == routes
    torch.testing.assert_close(got, conv3x3.conv3x3_reference(x, k),
                               atol=TOL[torch.float32][0], rtol=TOL[torch.float32][1])


@pytest.mark.parametrize("side,c", [(64, 64), (32, 128), (16, 256), (8, 512)])
def test_conv3x3_f32_dx_through_tf32x3_matches_cudnn(cuda, side, c):
    """The four ResNet-50 training shapes at batch 4 in float32: dx through
    the `tf32x3` route (the flipped, channel-swapped weight split anew)
    against cuDNN's `conv2d_input` with TF32 off."""
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(4, side, side, c, device=cuda, generator=g)
    w = torch.randn(3, 3, c, c, device=cuda, generator=g) / (9 * c) ** 0.5
    gy = torch.randn(4, c, side, side, device=cuda, generator=g).permute(0, 2, 3, 1)
    xk = x.clone().requires_grad_()
    routes = _routes()
    conv3x3.conv3x3_same(xk, w).backward(gy)
    torch.cuda.synchronize()
    routes["tf32x3"] += 2  # forward and dx
    assert _routes() == routes
    want = torch.nn.grad.conv2d_input(x.permute(0, 3, 1, 2).shape, w.permute(3, 2, 0, 1),
                                      gy.permute(0, 3, 1, 2), padding=1)
    torch.testing.assert_close(xk.grad, want.permute(0, 2, 3, 1), atol=TOL[torch.float32][0],
                               rtol=TOL[torch.float32][1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,m,d,q_scale", [
    (3, 61, 61, 64, 1), (3, 63, 127, 32, 1), (3, 308, 308, 16, 1), (3, 1, 5, 16, 1),
    (3, 64, 64, 64, 1),
    # real MANO's streams (63/126/252 nodes + grid)
    (3, 127, 127, 64, 1), (3, 190, 190, 32, 1), (3, 316, 316, 16, 1), (3, 252, 252, 16, 1),
    # N != M, ragged on both sides; one query row and one key
    (3, 17, 300, 64, 1), (3, 1, 1, 32, 1),
    # M far beyond the kernel's ring of 64-key chunks
    (2, 8, 1000, 16, 1), (2, 8, 1000, 64, 1),
    # batch 1
    (1, 61, 61, 64, 1), (1, 122, 122, 32, 1),
    # q x 8: logits reach +-50, the softmax is nearly one-hot, so the output
    # is the V row of each row's top key (every V row differs: a wrong key
    # order between P and V shows), and the running max and the 3xTF32
    # split of large logits are tested where they matter most
    (3, 125, 125, 64, 8), (3, 244, 244, 16, 8)])
def test_fused_mha_kernel_matches_plain(cuda, b, n, m, d, q_scale, dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    q = (q_scale * torch.randn(b, n, 4, d, device=cuda, generator=g)).to(dtype)
    k = torch.randn(b, m, 4, d, device=cuda, generator=g).to(dtype)
    v = torch.randn(b, m, 4, d, device=cuda, generator=g).to(dtype)
    count = fused_attention.launches.value
    got = fused_attention.fused_mha(q, k, v)
    torch.cuda.synchronize()
    assert fused_attention.launches.value == count + 1
    assert got.shape == (b, n, 4 * d) and got.dtype == dtype
    want = fused_attention.mha_reference(q.float(), k.float(), v.float())
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,m,h,d,q_scale", [
    # the ViT's attention cores: ViT-B/L blocks (D = 64, N = M = 256) and
    # the pooled-KV block (8 heads of 768 or 1024: D = 96, 128)
    (2, 256, 256, 12, 64, 1), (2, 64, 256, 8, 96, 1), (2, 64, 256, 8, 128, 1),
    # ragged N and M, one key, long M, large logits at the new head dims
    (3, 17, 300, 4, 96, 1), (3, 70, 130, 4, 128, 1), (2, 1, 1, 2, 96, 1),
    (2, 8, 1000, 2, 128, 1), (2, 125, 125, 4, 96, 8), (2, 125, 125, 4, 128, 8)])
def test_fused_mha_kernel_matches_plain_at_vit_shapes(cuda, b, n, m, h, d, q_scale, dtype):
    g = torch.Generator(device=cuda).manual_seed(4)
    q = (q_scale * torch.randn(b, n, h, d, device=cuda, generator=g)).to(dtype)
    k, v = (torch.randn(b, m, h, d, device=cuda, generator=g).to(dtype) for _ in range(2))
    count = fused_attention.launches.value
    got = fused_attention.fused_mha(q, k, v)
    torch.cuda.synchronize()
    assert fused_attention.launches.value == count + 1
    assert got.shape == (b, n, h * d) and got.dtype == dtype
    want = fused_attention.mha_reference(q.float(), k.float(), v.float())
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,m,h,q_scale", [
    # InterPoint's self-attention at the decoder's widths: 8 heads of 64 on
    # the synthetic and the MANO vertex counts of the three stages
    (3, 244, 244, 8, 1), (3, 252, 252, 8, 1), (4, 61, 61, 8, 1), (2, 122, 122, 8, 1),
    # ragged N and M, one key, long M, large logits
    (3, 17, 300, 4, 1), (2, 1, 1, 2, 1), (2, 8, 1000, 2, 1), (2, 125, 125, 4, 8)])
def test_fused_mha_kernel_matches_plain_at_head_dim_8(cuda, b, n, m, h, q_scale, dtype):
    g = torch.Generator(device=cuda).manual_seed(5)
    q = (q_scale * torch.randn(b, n, h, 8, device=cuda, generator=g)).to(dtype)
    k, v = (torch.randn(b, m, h, 8, device=cuda, generator=g).to(dtype) for _ in range(2))
    count = fused_attention.launches.value
    got = fused_attention.fused_mha(q, k, v)
    torch.cuda.synchronize()
    assert fused_attention.launches.value == count + 1
    assert got.shape == (b, n, h * 8) and got.dtype == dtype
    want = fused_attention.mha_reference(q.float(), k.float(), v.float())
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)


def test_fused_mha_off_the_16_byte_grid(cuda):
    """Contiguous views that start off the kernel's 16-byte copy grid give
    the same answer as aligned ones."""
    g = torch.Generator(device=cuda).manual_seed(3)
    shape = (2, 61, 4, 32)
    n = np.prod(shape)
    q, k, v = (torch.randn(n + 1, device=cuda, generator=g)[1:].view(shape) for _ in range(3))
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    got = fused_attention.fused_mha(q, k, v)
    torch.testing.assert_close(got, fused_attention.fused_mha(q.clone(), k.clone(), v.clone()),
                               atol=0, rtol=0)
    torch.testing.assert_close(got, fused_attention.mha_reference(q, k, v),
                               atol=TOL[torch.float32][0], rtol=TOL[torch.float32][1])


def test_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.randn(1, 8, 8, 16, device=cuda)
    w = torch.randn(3, 3, 16, 16, device=cuda)
    with pytest.raises(TypeError):
        conv3x3.conv3x3_same(x.half(), w.half())
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3.conv3x3_same(x.transpose(1, 2), w)
    q = torch.randn(1, 5, 4, 12, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fused_attention.fused_mha(q, q, q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("side,c", [(64, 64), (32, 128), (16, 256), (8, 512)])
def test_conv3x3_backward_matches_plain_autograd(cuda, side, c, dtype):
    """The training shapes of B2 (batch 2 here): dx through the kernel (its
    `wgmma` route in bf16, `tf32x3` in float32), dw by cuDNN, against the
    plain version's autograd; the output gradient arrives as the NHWC view
    of an NCHW tensor, as the ResNet gives it."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(2, side, side, c, device=cuda, generator=g).to(dtype)
    w = (torch.randn(3, 3, c, c, device=cuda, generator=g) / (9 * c) ** 0.5).to(dtype)
    gy = torch.randn(2, c, side, side, device=cuda, generator=g).to(dtype).permute(0, 2, 3, 1)
    xk, wk = x.clone().requires_grad_(), w.clone().requires_grad_()
    n, routes = conv3x3.launches.value, _routes()
    conv3x3.conv3x3_same(xk, wk).backward(gy)
    torch.cuda.synchronize()
    assert conv3x3.launches.value == n + 2  # forward and dx
    routes[conv3x3.route(dtype, c, c)] += 2
    assert _routes() == routes
    xp, wp = x.clone().requires_grad_(), w.clone().requires_grad_()
    conv3x3.conv3x3_reference(xp, wp).backward(gy)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(xk.grad.float(), xp.grad.float(), atol=atol, rtol=rtol)
    # dw sums B·H·W products: hold it relative to its largest element
    err = (wk.grad.float() - wp.grad.float()).abs().max() / wp.grad.float().abs().max()
    assert err <= (1e-5 if dtype == torch.float32 else 1e-2), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("side,c", [(64, 32), (32, 64), (16, 128), (8, 256), (64, 64)])
def test_conv3x3_forward_and_dx_at_hrnet_shapes(cuda, side, c, dtype):
    """HRNet-W32's B2 shapes (its branches at 32-256 channels; layer1 and
    the first incre block at 64): forward and dx through the kernel (on
    `wgmma` in bf16, Cout = 32 filling half of its 64-channel tile)
    against the plain version's autograd (cuDNN on the card); `tf32x3` in
    float32."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(3, side, side, c, device=cuda, generator=g).to(dtype)
    w = (torch.randn(3, 3, c, c, device=cuda, generator=g) / (9 * c) ** 0.5).to(dtype)
    gy = torch.randn(3, c, side, side, device=cuda, generator=g).to(dtype).permute(0, 2, 3, 1)
    xk, wk = x.clone().requires_grad_(), w.clone().requires_grad_()
    routes = _routes()
    y = conv3x3.conv3x3_same(xk, wk)
    y.backward(gy)
    torch.cuda.synchronize()
    routes[conv3x3.route(dtype, c, c)] += 2
    assert _routes() == routes
    xp = x.clone().requires_grad_()
    yp = conv3x3.conv3x3_reference(xp, w)
    yp.backward(gy)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(y.float(), yp.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(xk.grad.float(), xp.grad.float(), atol=atol, rtol=rtol)


def _sgd_step_card_vs_cpu(cuda, init_seed: int, batch_seed: int, **model):
    """One SGD step of the small config (with `model` overrides) on the
    card and on the CPU, the CPU on the card's branches, checked as
    `test_sgd_step_on_card_matches_cpu` says; returns the card's terms."""
    from renderih_tpu_torch.data.synthetic import synthetic_batch
    from renderih_tpu_torch.models import init_model
    from renderih_tpu_torch.train.state import create_train_state
    from renderih_tpu_torch.train.trainer import make_train_step
    from renderih_tpu_torch.utils.branches import gradient_gaps, record_branches, take_branches

    cfg = load_config(overrides={
        "model": {"encoder": "resnet18", "img_size": 128, "grid_size": 4,
                  "graph_layer_num": 2, "dropout": 0.0, **model},
        "train": {"precision": "f32", "optimizer": "sgd", "lr": 1.0, "warmup_epochs": 0}})
    assets = make_synthetic_assets(0)
    batch = synthetic_batch(assets, torch.Generator().manual_seed(batch_seed), 4, 128)
    rng = np.random.default_rng(batch_seed)
    for h in ("left", "right"):  # MANO labels, read by the mano decoder's loss
        batch[f"pose_{h}"] = torch.from_numpy((rng.normal(size=(4, 48)) * 0.3).astype(np.float32))
        batch[f"shape_{h}"] = torch.from_numpy(rng.normal(size=(4, 10)).astype(np.float32))
    out, taken = {}, None
    for dev in (cuda, "cpu"):
        model = init_model(cfg, assets, torch.Generator().manual_seed(init_seed)).to(dev)
        state = create_train_state(cfg, model, 10)
        n = conv3x3.launches.value
        with record_branches() if taken is None else take_branches(taken) as rec:
            terms = make_train_step(cfg, assets, 10, dev)(
                state, {k: v.to(dev) for k, v in batch.items()})
        taken = rec if taken is None else taken
        out[str(dev)] = dict(
            launches=conv3x3.launches.value - n,
            terms={k: float(v) for k, v in terms.items()},
            grads={k: p.grad.cpu() for k, p in model.named_parameters() if p.grad is not None},
            bn={k: v.cpu() for k, v in model.state_dict().items()
                if k.endswith(("running_mean", "running_var"))})
    card, cpu = out[str(cuda)], out["cpu"]
    assert card["launches"] == 26 and cpu["launches"] == 0
    for k, ref in cpu["terms"].items():
        assert abs(card["terms"][k] - ref) <= 1e-4 * abs(ref) + 1e-7, (k, card["terms"][k], ref)
    assert card["grads"].keys() == cpu["grads"].keys()
    gaps = gradient_gaps(card["grads"], cpu["grads"])
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= 2e-2, (worst, gaps[worst])  # 0 on both where no loss term reaches
    assert np.mean([e <= 3e-3 for e in gaps.values()]) >= 0.95
    for k, ref in cpu["bn"].items():
        assert (card["bn"][k] - ref).abs().max() <= 1e-5 * ref.abs().max(), k
    return card["terms"]


@pytest.mark.parametrize("init_seed,batch_seed", [(0, 0), (2, 5), (7, 1)])
def test_sgd_step_on_card_matches_cpu(cuda, init_seed, batch_seed):
    """One SGD step of the small config, f32, TF32 off, dropout 0, batch 4,
    from `init_model`'s weights and one batch, the CPU taking the card's
    branches at every ReLU and max-pool (`utils/branches.py`): loss terms
    within 1e-4 relative, BatchNorm statistics within 1e-5 of each
    buffer's largest value, every gradient within 2e-2 of its tensor's
    scale and 95% of the tensors within 3e-3 (`gradient_gaps`), the limits
    of chip_smoke.py's phase 9, which says where they come from; 26 B2
    launches (13 forward, 13 dx). Three (init, batch) draws: with the
    branches shared the check does not depend on the draw."""
    _sgd_step_card_vs_cpu(cuda, init_seed, batch_seed)


@pytest.mark.parametrize("init_seed,batch_seed", [(0, 0), (7, 1)])
def test_recipe_sgd_step_on_card_matches_cpu(cuda, init_seed, batch_seed):
    """The same with the aux heads and the MANO decoder (the heads' convs
    are stock convolutions: still 26 B2 launches; the hard-swish branches
    shared too)."""
    terms = _sgd_step_card_vs_cpu(cuda, init_seed, batch_seed, with_aux_heads=True,
                                  decoder="mano")
    assert terms["aux_hms"] > 0 and terms["mano_pose"] > 0


@pytest.mark.parametrize("out_dim", [42, 7])
def test_aux_head_on_card_matches_cpu(cuda, out_dim):
    """`AuxDecoderHead` in train mode on resnet18's C5 at 128² (4, 512,
    4, 4), f32: outputs within 1e-4 of their largest |value| and the
    gradients of its parameters and input under phase 9's limits, the CPU
    on the card's ReLU branches; no B2 launch (stock convolutions)."""
    from renderih_tpu_torch.models.resnet import AuxDecoderHead
    from renderih_tpu_torch.utils.branches import gradient_gaps, record_branches, take_branches

    torch.manual_seed(out_dim)
    head = AuxDecoderHead(512, out_dim).train()
    x = torch.randn(4, 512, 4, 4).abs()  # a post-ReLU map
    w = torch.randn(4, out_dim, 32, 32)
    out, taken = {}, None
    for dev in (cuda, "cpu"):
        h = AuxDecoderHead(512, out_dim).train().to(dev)
        h.load_state_dict(head.state_dict())
        xi = x.to(dev).requires_grad_(True)
        n = conv3x3.launches.value
        with record_branches() if taken is None else take_branches(taken) as rec:
            y = h(xi)
        (y * w.to(dev)).sum().backward()
        taken = rec if taken is None else taken
        out[str(dev)] = (y.detach().cpu(), dict(
            {k: p.grad.cpu() for k, p in h.named_parameters()}, input=xi.grad.cpu()),
            conv3x3.launches.value - n)
    (y_card, g_card, n_card), (y_cpu, g_cpu, _) = out[str(cuda)], out["cpu"]
    assert y_card.shape == (4, out_dim, 32, 32) and n_card == 0
    assert (y_card - y_cpu).abs().max() <= 1e-4 * y_cpu.abs().max()
    gaps = gradient_gaps(g_card, g_cpu)
    assert max(gaps.values()) <= 2e-2 and np.mean([e <= 3e-3 for e in gaps.values()]) >= 0.95


def test_param_regressor_on_card_matches_cpu(cuda):
    """`ParamRegressor` forward and input gradient, f32, within 1e-4 of
    their largest |value|, the CPU on the card's hard-swish pieces."""
    from renderih_tpu_torch.models.decoder import ParamRegressor
    from renderih_tpu_torch.utils.branches import record_branches, take_branches

    torch.manual_seed(0)
    reg = ParamRegressor()
    verts = torch.randn(8, 778, 3) * 3.0  # hard-swish inputs on all three pieces
    out, taken = {}, None
    for dev in (cuda, "cpu"):
        r = ParamRegressor().to(dev)
        r.load_state_dict(reg.state_dict())
        v = verts.to(dev).requires_grad_(True)
        with record_branches() if taken is None else take_branches(taken) as rec:
            pose6d, shape = r(v)
        (pose6d.square().sum() + shape.sum()).backward()
        taken = rec if taken is None else taken
        out[str(dev)] = [t.detach().cpu() for t in (pose6d, shape, v.grad)]
    for got, want in zip(out[str(cuda)], out["cpu"]):
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()


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
    got = _graphed_then_eager(card, imgs, 13, 24)
    want = InferenceEngine(cfg, assets=assets, buckets=(4,), device="cpu").predict(imgs)
    for key, ref in want.items():
        assert got[key].shape == ref.shape
        err = np.abs(got[key] - ref).max() / max(np.abs(ref).max(), 1e-6)
        assert err <= 1e-4, f"{key}: rel max|Δ| {err:.3e}"


def test_bf16_decoder_engine_runs_on_the_card(cuda):
    """`InferenceEngine(decoder_bf16=True)` on the card (a bf16 decoder
    trunk: its LayerNorms get bf16 inputs, which torch's CUDA kernel takes
    only with bf16 parameters): finite outputs, 13 conv and 24 attention
    launches a forward, equal to an engine on `decoder_f32=False`."""
    cfg = load_config(overrides={
        "model": {"encoder": "resnet18", "img_size": 128, "grid_size": 4,
                  "graph_layer_num": 2}})
    assets = make_synthetic_assets(0)
    imgs = np.random.default_rng(1).integers(0, 256, (4, 128, 128, 3), dtype=np.uint8)
    got = _graphed_then_eager(InferenceEngine(cfg, assets=assets, buckets=(4,), device=cuda,
                                              decoder_bf16=True), imgs, 13, 24)
    cfg.model.decoder_f32 = False
    ref = InferenceEngine(cfg, assets=assets, buckets=(4,), device=cuda).predict(imgs)
    for key, want in ref.items():
        assert np.isfinite(got[key]).all() and np.array_equal(got[key], want), key


@pytest.mark.parametrize("encoder,size,b2,b1", [
    ("hrnet_w18", 128, 216, 24), ("vit_tiny_card_test", 256, 0, 2 + 1 + 24)])
def test_hrnet_and_vit_engines_on_card_match_cpu(cuda, monkeypatch, encoder, size, b2, b1):
    """HRNet-W18 and a 2-block ViT (the ViT-B block layout at 128 wide) with
    a small decoder: f32 card (kernels) vs CPU (plain versions), and the
    launches a forward: B2 at every BasicBlock/Bottleneck 3x3 (216), B1 in
    every ViT block, the pooled-KV block and the decoder."""
    from renderih_tpu_torch.models import vit

    monkeypatch.setitem(vit._VIT_CONFIGS, "vit_tiny_card_test",
                        dict(embed_dim=128, depth=2, num_heads=4))
    cfg = load_config(overrides={
        "model": {"encoder": encoder, "img_size": size, "grid_size": 4, "graph_layer_num": 2},
        "train": {"precision": "f32"}})
    assets = make_synthetic_assets(0)
    imgs = np.random.default_rng(1).integers(0, 256, (3, size, size, 3), dtype=np.uint8)
    card = InferenceEngine(cfg, assets=assets, buckets=(4,), device=cuda)
    got = _graphed_then_eager(card, imgs, b2, b1)
    want = InferenceEngine(cfg, assets=assets, buckets=(4,), device="cpu").predict(imgs)
    for key, ref in want.items():
        err = np.abs(got[key] - ref).max() / max(np.abs(ref).max(), 1e-6)
        assert err <= 1e-4, f"{key}: rel max|Δ| {err:.3e}"


def test_vit_large_engine_replays_every_part_at_every_bucket(cuda):
    """ViT-L (24 blocks, 1024 wide; bf16 encoder, f32 decoder, as the
    benchmark's `vit_l_graph`) on the served buckets (1, 8, 32, 128): built,
    the engine has captured four parts a bucket (the trunk, the pyramid
    head, the mid model, the decoder), each run once eagerly first; then a
    `predict` at each bucket replays its four graphs and runs no part
    eagerly, with 49 B1 launches a forward (24 in the trunk, 1 in the pooled
    block, 24 in the decoder) and no B2; the eager parts put back
    (`ungraph`), every bucket's answers are the same bit for bit."""
    cfg = load_config(overrides={"model": {"encoder": "vit_large"},
                                 "train": {"precision": "bf16"}})
    counts = _graph_counts()
    engine = InferenceEngine(cfg, assets=make_synthetic_assets(0), device=cuda)
    assert engine.buckets == (1, 8, 32, 128)
    assert (_graph_counts() - counts).tolist() == [16, 0, 16]
    rng = np.random.default_rng(8)
    imgs = {b: rng.integers(0, 256, (b, 256, 256, 3), dtype=np.uint8) for b in engine.buckets}
    graphed = {}
    for b, x in imgs.items():
        counts = _graph_counts()
        launches = (conv3x3.launches.value, fused_attention.launches.value)
        graphed[b] = engine.predict(x)
        assert (_graph_counts() - counts).tolist() == [0, 4, 0], b
        assert (conv3x3.launches.value - launches[0],
                fused_attention.launches.value - launches[1]) == (0, 49), b
    ungraph(engine)
    for b, x in imgs.items():
        counts = _graph_counts()
        want = engine.predict(x)
        assert (_graph_counts() - counts).tolist() == [0, 0, 0]
        for key, ref in want.items():
            assert np.isfinite(ref).all() and np.array_equal(graphed[b][key], ref), (b, key)


def _graph_engine(cuda, encoder, **kw):
    cfg = load_config(overrides={
        "model": {"encoder": encoder, "img_size": 128, "grid_size": 4, "graph_layer_num": 2},
        "train": {"precision": "f32"}})
    return InferenceEngine(cfg, assets=make_synthetic_assets(0), buckets=(2, 4), device=cuda, **kw)


@pytest.mark.parametrize("encoder,b2,b1", [("resnet18", 13, 24), ("hrnet_w18", 216, 24)])
def test_engine_graphs_replay_the_eager_answers(cuda, encoder, b2, b1):
    """An engine on buckets (2, 4) captures both buckets' graphs as it is
    built (each part run once eagerly, then captured). Two `predict`s
    of 10 images (chunks 4, 4, 2) replay every part; a third, the eager
    parts put back (`ungraph`), runs them eagerly. Answers equal bit for
    bit (chunk i+1 queued before chunk i's copy back: the copy out of the
    static outputs), B1 and B2 launches a forward unchanged, and the
    graphs' counters (captures, replays, eager part-calls)."""
    counts = _graph_counts()
    engine = _graph_engine(cuda, encoder)
    assert (_graph_counts() - counts).tolist() == [6, 0, 6]
    imgs = np.random.default_rng(3).integers(0, 256, (10, 128, 128, 3), dtype=np.uint8)
    runs = []
    for graphed in (True, True, False):
        if not graphed:
            ungraph(engine)
        counts = _graph_counts()
        before = (conv3x3.launches.value, sum(_routes().values()), fused_attention.launches.value)
        runs.append(engine.predict(imgs))
        after = (conv3x3.launches.value, sum(_routes().values()), fused_attention.launches.value)
        assert np.subtract(after, before).tolist() == [3 * b2, 3 * b2, 3 * b1]
        assert (_graph_counts() - counts).tolist() == ([0, 9, 0] if graphed else [0, 0, 0])
    for run in runs[:-1]:
        for key, want in runs[-1].items():
            assert np.isfinite(want).all() and np.array_equal(run[key], want), key
    v = runs[0]["verts3d_left"]
    assert not np.array_equal(v[:2], v[4:6]) and not np.array_equal(v[4:6], v[8:])


def test_engine_graph_hooks_fire_with_the_live_tensors(cuda):
    """Hooks registered after the capture (a forward pre-hook on the model,
    pre and post on its decoder) fire once a forward, with the arguments and
    results of that forward; the forwards replay, none runs eagerly."""
    engine = _graph_engine(cuda, "resnet18")
    imgs = np.random.default_rng(4).integers(0, 256, (10, 128, 128, 3), dtype=np.uint8)
    seen = {"model": [], "pre": [], "post": []}
    hooks = [
        engine.model.register_forward_pre_hook(lambda m, a: seen["model"].append(a[0].shape[0])),
        engine.model.decoder.register_forward_pre_hook(
            lambda m, a: seen["pre"].append(a[0].clone())),
        engine.model.decoder.register_forward_hook(
            lambda m, a, out: seen["post"].append(out.verts3d["left"].clone()))]
    counts = _graph_counts()
    got = engine.predict(imgs)
    for h in hooks:
        h.remove()
    assert (_graph_counts() - counts).tolist() == [0, 9, 0]
    assert seen["model"] == [4, 4, 2] and [t.shape[0] for t in seen["pre"]] == [4, 4, 2]
    assert all(torch.isfinite(t).all() for t in seen["pre"])
    assert not torch.equal(seen["pre"][0], seen["pre"][1])
    post = torch.cat([t[:n] for t, n in zip(seen["post"], (4, 4, 2))]).cpu().numpy()
    assert np.array_equal(post, got["verts3d_left"])


def test_engine_graphs_serve_threads_their_own_answers(cuda):
    """Eight threads (more than the cores a card test runs on) sharing one
    graphed engine, no `warmup()` called, the interpreter switching every
    10 µs, while a second engine is built on the card and captures its
    graphs: each `predict` gets the answers a lone call gives its images,
    bit for bit (the lock holds a forward's replays and its copy out
    together; the capture, thread-local, lets the serving threads
    allocate), and the second engine's replays equal its eager answers."""
    import sys
    import threading

    engine = _graph_engine(cuda, "resnet18")
    rng = np.random.default_rng(6)
    sets = [rng.integers(0, 256, (n, 128, 128, 3), dtype=np.uint8) for n in (2, 4, 6, 10)]
    want = [engine.predict(imgs) for imgs in sets]
    bad, done, stop = [], [], threading.Event()

    def serve(t):
        i = 0
        while i < 6 or not stop.is_set():
            k = (t + i) % len(sets)
            got = engine.predict(sets[k])
            if not all(np.array_equal(got[key], want[k][key]) for key in got):
                bad.append((t, i))
            i += 1
        done.append(t)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=serve, args=(t,)) for t in range(8)]
    try:
        for th in threads:
            th.start()
        other = _graph_engine(cuda, "resnet18", seed=7)
        mine = other.predict(sets[2])
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=300)
        sys.setswitchinterval(switch)
    assert not any(th.is_alive() for th in threads)
    assert sorted(done) == list(range(8)) and not bad, bad
    ungraph(other)
    for key, ref in other.predict(sets[2]).items():
        assert np.array_equal(mine[key], ref), key


def test_engine_captures_with_the_cyclic_collector_off(cuda):
    """An engine built while a dropped engine's graphed model waits for the
    cyclic collector (a graphed part and its method form a cycle): the
    collector is off through every capture, so no collection frees the old
    graphs inside one (that invalidates the capture), on again after, and
    the new engine's replays equal its eager answers."""
    import gc

    old = _graph_engine(cuda, "resnet18")
    old.predict(np.zeros((4, 128, 128, 3), np.uint8))
    del old
    on, seen = gc.isenabled(), []

    def record(module, args):
        if torch.cuda.is_current_stream_capturing():
            seen.append(gc.isenabled())

    hook = torch.nn.modules.module.register_module_forward_pre_hook(record)
    try:
        engine = _graph_engine(cuda, "resnet18", seed=3)
    finally:
        hook.remove()
    assert seen and not any(seen)
    assert gc.isenabled() == on
    imgs = np.random.default_rng(8).integers(0, 256, (4, 128, 128, 3), dtype=np.uint8)
    _graphed_then_eager(engine, imgs, 13, 24)


@pytest.fixture(scope="module")
def staged_engine():
    """A graphed resnet18 engine on the default buckets (1, 8, 32, 128)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = load_config(overrides={
        "model": {"encoder": "resnet18", "img_size": 128, "grid_size": 4, "graph_layer_num": 2},
        "train": {"precision": "f32"}})
    return InferenceEngine(cfg, assets=make_synthetic_assets(0), device="cuda")


def _chunked_forward(engine, imgs):
    """What `predict` returns, chunk by chunk from `_forward` with blocking
    copies and no staging of outputs: the chunks of `predict` (the largest
    bucket at a time, the rest at its bucket), concatenated."""
    outs, start = [], 0
    while start < len(imgs):
        take = min(len(imgs) - start, engine.buckets[-1])
        with engine._transfer_lock:
            out = engine._forward(imgs[start:start + take])
            outs.append({k: v[:take].cpu().numpy() for k, v in out.items()})
        start += take
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


@pytest.mark.parametrize("n", [1, 5, 127, 128, 129, 256, 300])
def test_engine_staged_predict_equals_its_forwards(staged_engine, n):
    """`predict` of n images through the staging slots (pinned, double
    buffered, uploads and copies back on their own streams) equals, bit for
    bit, the same engine's chunk-by-chunk `_forward` copied back with
    `.cpu()`; one staged chunk a chunk, no more overlapped than staged; the
    arrays it returns are unchanged by two further calls (no slot aliased)."""
    engine = staged_engine
    rng = np.random.default_rng(n)
    imgs = rng.integers(0, 256, (n, 128, 128, 3), dtype=np.uint8)
    staged, overlapped = trace.counter("engine.staged_chunks"), trace.counter(
        "engine.overlapped_uploads")
    before = (staged.value, overlapped.value)
    got = engine.predict(imgs)
    chunks = -(-n // engine.buckets[-1])
    assert staged.value - before[0] == chunks
    assert 0 <= overlapped.value - before[1] <= chunks - 1
    kept = {k: v.copy() for k, v in got.items()}
    want = _chunked_forward(engine, imgs)
    for _ in range(2):
        engine.predict(rng.integers(0, 256, (n, 128, 128, 3), dtype=np.uint8))
    for key, ref in want.items():
        assert got[key].shape == (n, *ref.shape[1:]) and got[key].dtype == ref.dtype, key
        assert np.array_equal(got[key], ref), key
        assert np.array_equal(got[key], kept[key]), key


def test_engine_staging_serves_two_threads_their_own_answers(staged_engine):
    """Two threads predicting multi-chunk requests (129, 256 and 300
    images) on one engine, the interpreter switching every 10 µs: each call
    gets the answers a lone call gives its images, bit for bit, and keeps
    them (the per-call transfer lock: two calls never share a slot)."""
    import sys
    import threading

    engine = staged_engine
    rng = np.random.default_rng(11)
    sets = [rng.integers(0, 256, (n, 128, 128, 3), dtype=np.uint8) for n in (129, 256, 300)]
    want = [engine.predict(imgs) for imgs in sets]
    bad, done, kept = [], [], []

    def serve(t):
        for i in range(6):
            k = (t + i) % len(sets)
            got = engine.predict(sets[k])
            kept.append((k, got))
            if not all(np.array_equal(got[key], want[k][key]) for key in got):
                bad.append((t, i))
        done.append(t)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=serve, args=(t,)) for t in range(2)]
    try:
        for th in threads:
            th.start()
    finally:
        for th in threads:
            th.join(timeout=300)
        sys.setswitchinterval(switch)
    assert not any(th.is_alive() for th in threads)
    assert sorted(done) == [0, 1] and not bad, bad
    for k, got in kept:
        assert all(np.array_equal(got[key], want[k][key]) for key in got), k


def test_engine_graphs_follow_weights_loaded_in_place(cuda):
    """`engine.model.load_state_dict(other)` after the capture: the replays
    read the new weights, equal bit for bit to an engine built on them."""
    engine = _graph_engine(cuda, "resnet18")
    imgs = np.random.default_rng(5).integers(0, 256, (4, 128, 128, 3), dtype=np.uint8)
    old = engine.predict(imgs)
    other = _graph_engine(cuda, "resnet18", seed=5)
    want = other.predict(imgs)
    counts = _graph_counts()
    engine.model.load_state_dict(other.model.state_dict())
    got = engine.predict(imgs)
    assert (_graph_counts() - counts).tolist() == [0, 3, 0]
    for key, ref in want.items():
        assert np.array_equal(got[key], ref) and not np.array_equal(got[key], old[key]), key


def _mesh(name, device):
    if name == "cube":
        v = torch.tensor([[x, y, z] for z in (-.5, .5) for y in (-.5, .5) for x in (-.5, .5)])
        f = torch.tensor([[0, 3, 1], [0, 2, 3], [4, 5, 7], [4, 7, 6], [0, 1, 5], [0, 5, 4],
                          [3, 2, 6], [3, 6, 7], [1, 3, 7], [1, 7, 5], [0, 4, 6], [0, 6, 2]])
        return v.to(device), f.to(device)
    model = make_synthetic_mano(0, is_right=False)
    rng = np.random.default_rng(0)
    pose = torch.from_numpy(rng.normal(0, 0.4, (1, 45)).astype(np.float32))
    root = torch.from_numpy(rng.normal(0, 0.8, (1, 3)).astype(np.float32))
    v, _ = mano_forward(model, rodrigues(root), pose, torch.zeros(1, 10), center_idx=None,
                        use_pca=False)
    return v[0].to(device), model.faces.to(device)


@pytest.mark.parametrize("mesh", ["cube", "hand"])
@pytest.mark.parametrize("g", [1, 7, 16, 17, 24, 32, 33])
def test_sdf_kernel_matches_plain(cuda, mesh, g):
    """Same float32 arithmetic in the same order (sdf.cu built with
    -fmad=false) and exact, order-free reductions across the lanes: phi
    bit for bit the plain version's. The cube has fewer faces (12) than a
    warp has lanes; G = 1, 7, 17, 33 leave the last block ragged."""
    verts, faces = _mesh(mesh, cuda)
    n = sdf.launches.value
    phi, bmin, scale = sdf.sdf_grid(verts, faces, g)
    torch.cuda.synchronize()
    assert sdf.launches.value == n + 1
    ref, ref_bmin, ref_scale = sdf.sdf_grid_reference(verts, faces, g)
    assert phi.shape == (g, g, g) and phi.dtype == torch.float32
    assert torch.equal(phi, ref)
    assert torch.equal(bmin, ref_bmin) and torch.equal(scale, ref_scale)
    i32 = sdf.sdf_grid(verts, faces.int(), g)[0]
    assert torch.equal(i32, phi)


def test_sdf_kernel_refuses_what_it_does_not_take(cuda):
    verts, faces = _mesh("cube", cuda)
    with pytest.raises(ValueError, match="faces on"):
        sdf.sdf_grid(verts, faces.cpu(), 8)
    with pytest.raises(TypeError):
        sdf.sdf_grid(verts.double(), faces, 8)
    with pytest.raises(TypeError):
        sdf.sdf_grid(verts, faces.float(), 8)
    with pytest.raises(ValueError, match="shapes"):
        sdf.sdf_grid(verts[:, :2], faces, 8)
    with pytest.raises(RuntimeError, match="no backward"):
        sdf.sdf_grid(verts.clone().requires_grad_(), faces, 8)


def test_synth_gen_on_the_card_launches_b3_per_refinement_step(cuda, tmp_path):
    """60 iterations = 4 attempts of 15 Adam steps; each loss evaluation
    builds 2 fields, and each attempt ends with one more evaluation:
    4 * (2 * 15 + 2) = 128 launches per refined sample."""
    n = sdf.launches.value
    result = synth_gen.main(["--out", str(tmp_path), "--n", "2", "--batch", "2",
                             "--optimize", "--opt_iters", "60"])
    assert sdf.launches.value - n == 2 * 128
    assert result["device"].startswith("cuda")
    labels = np.load(tmp_path / "train_labels.npz")
    assert all(np.isfinite(labels[k]).all() for k in labels.files)


@pytest.mark.parametrize("override,b1", [
    ({"use_cheby": True}, 24), ({"paired_lr": True}, 24),
    ({"paired_lr": True, "use_cheby": True}, 24)])
def test_decoder_variants_on_card_match_cpu(cuda, override, b1):
    """The Chebyshev and paired models on a small resnet18 config: f32 card
    (kernels) vs CPU (plain versions), the launches a forward (`paired_lr`
    builds the unpaired trunk), and a paired model against the unpaired one
    from its upstream state_dict."""
    base = {"encoder": "resnet18", "img_size": 128, "grid_size": 4, "graph_layer_num": 2}
    cfg = load_config(overrides={"model": {**base, **override}, "train": {"precision": "f32"}})
    assets = make_synthetic_assets(0)
    imgs = np.random.default_rng(2).integers(0, 256, (3, 128, 128, 3), dtype=np.uint8)
    card = InferenceEngine(cfg, assets=assets, buckets=(4,), device=cuda)
    got = _graphed_then_eager(card, imgs, 13, b1)
    wants = [InferenceEngine(cfg, assets=assets, buckets=(4,), device="cpu").predict(imgs)]
    if "paired_lr" in override:
        unpaired = load_config(overrides={
            "model": {**base, **override, "paired_lr": False}, "train": {"precision": "f32"}})
        sd = InferenceEngine(unpaired, assets=assets, buckets=(4,), device="cpu",
                             seed=3).model.state_dict()
        got = InferenceEngine(cfg, assets=assets, buckets=(4,), device=cuda,
                              state_dict=sd).predict(imgs)
        wants = [InferenceEngine(unpaired, assets=assets, buckets=(4,), device=cuda,
                                 state_dict=sd).predict(imgs)]
    for want in wants:
        for key, ref in want.items():
            err = np.abs(got[key] - ref).max() / max(np.abs(ref).max(), 1e-6)
            assert err <= 1e-4, f"{key}: rel max|Δ| {err:.3e}"


@pytest.mark.parametrize("width,verts", [(256, 61), (128, 122), (64, 244)])
def test_inter_point_on_card_matches_cpu(cuda, width, verts):
    """InterPoint's 8 heads: B1 at D = 32, 16 and 8, two launches a call."""
    from renderih_tpu_torch.models.experimental_attn import InterPoint

    torch.manual_seed(0)
    mod = InterPoint(width, verts).eval()
    g = torch.Generator().manual_seed(1)
    lf, rf = (torch.randn(3, verts, width, generator=g) for _ in range(2))
    with torch.no_grad():
        want = mod(lf, rf)
        n = fused_attention.launches.value
        got = mod.to(cuda)(lf.to(cuda), rf.to(cuda))
    assert fused_attention.launches.value - n == 2
    for a, b in zip(got, want):
        assert (a.cpu() - b).abs().max() <= 1e-4 * b.abs().max()


def test_gan_prior_on_card_matches_cpu_and_refines(cuda, tmp_path):
    """The shipped discriminator's energy and gradient on the card against
    the CPU, then `synth_gen --prior gan` on the card: 128 B3 launches a
    refined sample."""
    from renderih_tpu_torch.optimize.geo import (
        POSE_PRIOR_PATH,
        load_pose_prior,
        make_gan_pose_prior,
    )

    params = load_pose_prior(POSE_PRIOR_PATH)
    pose = torch.from_numpy(np.random.default_rng(3).normal(0, 0.8, 45).astype(np.float32))
    res = {}
    for dev in ("cpu", cuda):
        x = pose.to(dev).clone().requires_grad_(True)
        e = make_gan_pose_prior(params, dev)(x)
        e.backward()
        res[str(dev)] = (e.detach().cpu(), x.grad.cpu())
    for a, b in zip(res[str(cuda)], res["cpu"]):
        assert (a - b).abs().max() <= 1e-5 * max(1.0, float(b.abs().max()))
    n = sdf.launches.value
    synth_gen.main(["--out", str(tmp_path), "--n", "1", "--batch", "1", "--optimize",
                    "--opt_iters", "60", "--prior", "gan"])
    assert sdf.launches.value - n == 128


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batchnorm_in_a_world1_nccl_group_is_the_one_device_path(cuda, tmp_path, dtype):
    """`models/layers.py:BatchNorm2d` in an NCCL group of one rank (a
    `file://` store) against the same module with no group: output, dx,
    dγ, dβ and the running statistics equal bit for bit (a group of one
    takes the one-device path); the train step's gradient all-reduce and
    term averaging at world 1 leave the gradients bit for bit too."""
    import torch.distributed as tdist

    from renderih_tpu_torch.models.layers import BatchNorm2d
    from renderih_tpu_torch.parallel import dist

    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(4, 64, 16, 16, device=cuda, generator=gen).to(dtype)
    x = (3.0 * x + 1.0).contiguous(memory_format=torch.channels_last)
    w = torch.randn(x.shape, device=cuda, generator=gen).to(dtype)

    def run():
        mod = BatchNorm2d(64).to(cuda).train()
        with torch.no_grad():
            mod.weight.uniform_(0.5, 1.5, generator=gen)
            mod.bias.uniform_(-0.5, 0.5, generator=gen)
        xi = x.clone().requires_grad_(True)
        y = mod(xi)
        (y.float() * w.float()).sum().backward()
        params = [mod.weight, mod.bias]
        dist.average_gradients(params)
        return [y, xi.grad, mod.weight.grad, mod.bias.grad, mod.running_mean, mod.running_var]

    gen.manual_seed(5)
    alone = run()
    dist.init(cuda, init_method=f"file://{tmp_path}/store", rank=0, world_size=1)
    try:
        assert tdist.get_backend() == "nccl" and dist.world() == 1
        gen.manual_seed(5)
        grouped = run()
    finally:
        tdist.destroy_process_group()
    for a, b in zip(alone, grouped):
        assert torch.equal(a, b)
