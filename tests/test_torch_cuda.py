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
from renderih_tpu_torch.kernels import conv3x3, fused_attention, sdf
from renderih_tpu_torch.mano.layer import mano_forward
from renderih_tpu_torch.mano.params import make_synthetic_mano
from renderih_tpu_torch.ops.rotation import rodrigues
from renderih_tpu_torch.serve import InferenceEngine
from renderih_tpu_torch.tools import synth_gen

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


def _conv_route(dtype, cin, cout):
    """The kernel the launcher must pick for a 16-byte aligned input."""
    return "wgmma" if dtype == torch.bfloat16 and cin % 16 == 0 and cout % 8 == 0 else "simt"


def _routes():
    return {name: c.value for name, c in conv3x3.routes.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 7, 7, 24, 40), (3, 13, 21, 64, 72), (2, 8, 8, 512, 512), (2, 64, 64, 64, 64),
    # Cin no multiple of a 32/64 chunk; Cout no multiple of the N tile
    (2, 9, 11, 16, 64), (2, 10, 12, 48, 32), (2, 11, 9, 32, 136),
    # small maps: images folded into M, a ragged last group of images
    (1, 5, 7, 32, 64), (3, 5, 7, 32, 64), (1, 8, 8, 64, 128), (3, 8, 8, 64, 128)])
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
    routes[_conv_route(dtype, cin, cout)] += 1
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
    q = torch.randn(1, 5, 4, 8, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fused_attention.fused_mha(q, q, q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("side,c", [(64, 64), (32, 128), (16, 256), (8, 512)])
def test_conv3x3_backward_matches_plain_autograd(cuda, side, c, dtype):
    """The training shapes of B2 (batch 2 here): dx through the kernel (its
    `wgmma` route in bf16), dw by cuDNN, against the plain version's
    autograd; the output gradient arrives as the NHWC view of an NCHW
    tensor, as the ResNet gives it."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(2, side, side, c, device=cuda, generator=g).to(dtype)
    w = (torch.randn(3, 3, c, c, device=cuda, generator=g) / (9 * c) ** 0.5).to(dtype)
    gy = torch.randn(2, c, side, side, device=cuda, generator=g).to(dtype).permute(0, 2, 3, 1)
    xk, wk = x.clone().requires_grad_(), w.clone().requires_grad_()
    n, routes = conv3x3.launches.value, _routes()
    conv3x3.conv3x3_same(xk, wk).backward(gy)
    torch.cuda.synchronize()
    assert conv3x3.launches.value == n + 2  # forward and dx
    routes[_conv_route(dtype, c, c)] += 2
    assert _routes() == routes
    xp, wp = x.clone().requires_grad_(), w.clone().requires_grad_()
    conv3x3.conv3x3_reference(xp, wp).backward(gy)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(xk.grad.float(), xp.grad.float(), atol=atol, rtol=rtol)
    # dw sums B·H·W products: hold it relative to its largest element
    err = (wk.grad.float() - wp.grad.float()).abs().max() / wp.grad.float().abs().max()
    assert err <= (1e-5 if dtype == torch.float32 else 1e-2), err


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
    n_conv, n_mha = conv3x3.launches.value, fused_attention.launches.value
    got = card.predict(imgs)
    assert conv3x3.launches.value - n_conv == 13
    assert fused_attention.launches.value - n_mha == 24
    want = InferenceEngine(cfg, assets=assets, buckets=(4,), device="cpu").predict(imgs)
    for key, ref in want.items():
        assert got[key].shape == ref.shape
        err = np.abs(got[key] - ref).max() / max(np.abs(ref).max(), 1e-6)
        assert err <= 1e-4, f"{key}: rel max|Δ| {err:.3e}"


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
