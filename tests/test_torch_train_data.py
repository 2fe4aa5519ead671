"""The training slice's modules against the JAX package on the CPU, one
module at a time: the graph loss, the schedules and optimizers (against
optax), the augmentation transform fed JAX's own random draws, the
synthetic batch from JAX's draws, the sampler's order, flax's BatchNorm in
training, and B2's backward against `jax.vjp` of the JAX conv."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from renderih_tpu.assets import make_synthetic_assets as jax_assets
from renderih_tpu.data import pipeline as jax_pipeline
from renderih_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from renderih_tpu.kernels.conv_pallas import _xla_conv3x3
from renderih_tpu.losses import graph_loss as jax_loss
from renderih_tpu.models.decoder import DecoderOutput as JaxDecoderOutput
from renderih_tpu.ops import image as jax_image
from renderih_tpu.train import schedule as jax_schedule
from renderih_tpu_torch.assets import make_synthetic_assets
from renderih_tpu_torch.config import load_config
from renderih_tpu_torch.data import pipeline
from renderih_tpu_torch.data.synthetic import synthetic_from_draws
from renderih_tpu_torch.kernels import conv3x3
from renderih_tpu_torch.losses import graph_loss
from renderih_tpu_torch.models.decoder import DecoderOutput
from renderih_tpu_torch.models.layers import BatchNorm2d
from renderih_tpu_torch.ops import image
from renderih_tpu_torch.train import schedule
from renderih_tpu_torch.train.state import make_optimizer


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def assets():
    return make_synthetic_assets(0), jax_assets(0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got: dict, want: dict, rtol: float, atol: float = 0.0):
    assert set(got) >= set(want), set(want) - set(got)
    for k, ref in want.items():
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(ref), rtol=rtol,
                                   atol=atol, err_msg=k)


# --- the loss ---------------------------------------------------------------

@pytest.mark.parametrize("epoch,camera,normal_epoch", [(0, 0.0, 0), (60, 2.0, 0), (3, 1.0, 5)])
def test_graph_loss_matches_jax(assets, epoch, camera, normal_epoch):
    """Every term on the same outputs and labels, rtol 1e-5: the edge gate
    closed (epoch 0 < norm_epoch 50) and open (60), the camera term off and
    weighted, the normal gate closed (3 < 5)."""
    ours, theirs = assets
    rng = np.random.default_rng(epoch)
    b, v_out = 3, ours.left.verts_nums[-1]
    out = {}
    for key, shape in (("verts3d", (b, 778, 3)), ("verts2d", (b, 778, 2)), ("scale", (b,)),
                       ("trans2d", (b, 2)), ("c3", (b, v_out, 3)), ("c2", (b, v_out, 2))):
        out[key] = {h: (rng.normal(size=shape) * (100 if "2" in key and key != "trans2d"
                                                  else 0.1)).astype(np.float32)
                    for h in ("left", "right")}
    labels = _np(jax_synthetic_batch(theirs, jax.random.PRNGKey(epoch), batch_size=b,
                                     img_size=256, with_img=False))
    up = (np.asarray(theirs.left.upsample_init)
          + rng.normal(size=theirs.left.upsample_init.shape) * 0.01).astype(np.float32)
    w = dict(camera=camera, normal_epoch=normal_epoch)
    total_j, terms_j = jax_loss.two_hand_graph_loss(
        JaxDecoderOutput(out["verts3d"], out["verts2d"], out["scale"], out["trans2d"],
                         {h: [v] for h, v in out["c3"].items()},
                         {h: [v] for h, v in out["c2"].items()}, None, None),
        labels, theirs, epoch, jax_loss.GraphLossWeights(**w), upsample_weight=up)
    t = lambda d: {h: torch.from_numpy(v) for h, v in d.items()}
    total, terms = graph_loss.two_hand_graph_loss(
        DecoderOutput(t(out["verts3d"]), t(out["verts2d"]), t(out["scale"]),
                      t(out["trans2d"]), {h: [torch.from_numpy(v)] for h, v in out["c3"].items()},
                      {h: [torch.from_numpy(v)] for h, v in out["c2"].items()}),
        {k: torch.tensor(v) for k, v in labels.items()}, ours, epoch,
        graph_loss.GraphLossWeights(**w), upsample_weight=torch.from_numpy(up))
    assert set(terms) == set(terms_j)
    _close({k: float(v) for k, v in terms.items()}, {k: float(v) for k, v in terms_j.items()},
           rtol=1e-5, atol=1e-7)
    assert float(terms["camera"]) > 0 if camera else float(terms["camera"]) == 0


def test_safe_norm_has_a_finite_gradient_at_zero():
    x = torch.zeros(4, 3, requires_grad=True)
    graph_loss._safe_norm(x).sum().backward()
    assert torch.isfinite(x.grad).all()


def test_fit_orthographic_cam_recovers_the_camera(assets):
    ours, _ = assets
    v3d = torch.randn(2, 778, 3, generator=torch.Generator().manual_seed(0)) * 0.05
    scale, trans = torch.tensor([0.9, 1.3]), torch.tensor([[0.1, -0.2], [0.0, 0.3]])
    from renderih_tpu_torch.ops.projection import orthographic_project
    s, t = graph_loss.fit_orthographic_cam(v3d, orthographic_project(scale, trans, v3d, 256.0),
                                           256.0)
    torch.testing.assert_close(s, scale, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(t, trans, rtol=1e-4, atol=1e-5)


# --- schedules and optimizers ------------------------------------------------

@pytest.mark.parametrize("name,args", [
    ("warmup_step_decay_schedule", (3e-4, 10)),
    ("warmup_step_decay_schedule", (1e-3, 4, 0, 2, 0.5, 0.01)),
    ("sgdr_schedule", (1e-3, 10, 3, 2, 1e-5, 1)),
    ("sgdr_schedule", (1e-2, 5, 1, 3, 1e-4, 0))])
def test_schedules_match_optax(name, args):
    ours, theirs = getattr(schedule, name)(*args), getattr(jax_schedule, name)(*args)
    steps = list(range(0, 700, 3))
    np.testing.assert_allclose([ours(s) for s in steps], [float(theirs(s)) for s in steps],
                               rtol=1e-5, atol=1e-12)  # optax evaluates in float32


@pytest.mark.parametrize("name", ["adamw", "sgd", "rmsprop"])
def test_optimizer_updates_match_optax(name):
    """Five steps on random tensors with random gradients; the learning
    rate changes every step, as the train step sets it."""
    cfg = load_config(overrides={"train": {"optimizer": name, "lr": 1e-2,
                                           "weight_decay": 1e-2}})
    rng = np.random.default_rng(0)
    p0 = {"a": rng.normal(size=(4, 3)).astype(np.float32),
          "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * 10.0 ** rng.integers(-6, 1)).astype(np.float32)
              for k, v in p0.items()} for _ in range(5)]
    lrs = [1e-2, 5e-3, 2e-2, 1e-3, 1e-2]
    sched = lambda count: jnp.asarray(lrs)[count]
    tx = {"adamw": lambda: optax.adamw(sched, weight_decay=1e-2),
          "sgd": lambda: optax.sgd(sched), "rmsprop": lambda: optax.rmsprop(sched)}[name]()
    params = dict(p0)
    st = tx.init(params)
    ours = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    opt = make_optimizer(cfg, list(ours.values()))
    for g, lr in zip(grads, lrs):
        upd, st = tx.update(g, st, params)
        params = optax.apply_updates(params, upd)
        for k, p in ours.items():
            p.grad = torch.from_numpy(g[k])
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
    for k, p in ours.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


# --- augmentation ------------------------------------------------------------

def _jax_draws(key, b, c, size, ranges, noise):
    """The draws `renderih_tpu/data/pipeline.py:device_augment` makes, in
    the port's `augment_draws` layout."""
    theta_r, scale_r, uv_r = ranges
    k_theta, k_scale, k_u, k_v, k_flip, k_noise = jax.random.split(key, 6)
    k1, k2, k3 = jax.random.split(k_noise, 3)
    d = {"theta": jax.random.uniform(k_theta, (b,), minval=theta_r[0], maxval=theta_r[1]),
         "scale": jax.random.uniform(k_scale, (b,), minval=scale_r[0], maxval=scale_r[1]),
         "u": jax.random.uniform(k_u, (b,), minval=uv_r[0], maxval=uv_r[1]),
         "v": jax.random.uniform(k_v, (b,), minval=uv_r[0], maxval=uv_r[1]),
         "flip": jax.random.uniform(k_flip, (b,)) > 0.5,
         "noise": {"gain": jax.random.uniform(k1, (b, 1, 1, c), minval=0.7, maxval=1.3),
                   "offset": 0.05 * (2.0 * jax.random.uniform(k2, (b, 1, 1, 1)) - 1.0),
                   "gauss": jax.random.normal(k3, (b, size, size, c)) if noise else None}}
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), d)


def _raw_batch(theirs, b, size, seed):
    rng = np.random.default_rng(seed)
    batch = _np(jax_synthetic_batch(theirs, jax.random.PRNGKey(seed), batch_size=b,
                                    img_size=size, with_img=False))
    batch.pop("root_rel")
    batch["img_u8"] = rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8)
    for h in ("left", "right"):
        batch[f"pose_{h}"] = (rng.normal(size=(b, 48)) * 0.3).astype(np.float32)
        batch[f"shape_{h}"] = rng.normal(size=(b, 10)).astype(np.float32)
    return batch


@pytest.mark.parametrize("train", [True, False])
def test_augment_transform_on_jax_draws_matches_jax(assets, train):
    _, theirs = assets
    b, size, noise = 6, 64, 0.1
    ranges = ((-90.0, 90.0), (0.9, 1.1), (-5.0, 5.0))
    batch = _raw_batch(theirs, b, size, 3)
    key = jax.random.PRNGKey(7)
    want = _np(jax_pipeline.device_augment(
        {k: jnp.asarray(v) for k, v in batch.items()}, key, img_size=size,
        theta_range=ranges[0], scale_range=ranges[1], uv_range=ranges[2], noise=noise,
        train=train))
    draws = _jax_draws(key, b, 3, size, ranges, noise) if train else None
    if train:
        assert draws["flip"].any() and not draws["flip"].all()
    got = pipeline.augment_transform({k: torch.tensor(v) for k, v in batch.items()},
                                     draws, img_size=size, noise=noise)
    got = {k: v.numpy() for k, v in got.items()}
    assert set(got) == set(want)
    # images are normalized 0..255 / 255 values; a sample position within
    # rounding of a pixel edge may take the other neighbour's weight
    np.testing.assert_allclose(got["img"], want["img"], atol=2e-3)
    _close({k: v for k, v in got.items() if k != "img"},
           {k: v for k, v in want.items() if k != "img"}, rtol=1e-4, atol=1e-5)


def test_uint8_warp_equals_float_warp():
    g = torch.Generator().manual_seed(0)
    img = torch.randint(0, 256, (3, 40, 40, 3), dtype=torch.uint8, generator=g)
    mat = image.affine_mat(torch.tensor([-70.0, 13.0, 90.0]), torch.tensor([0.9, 1.1, 1.0]),
                           torch.tensor([0.0, 4.0, -9.0]), torch.tensor([3.0, 0.0, 2.5]), 40.0)
    u8 = image.warp_affine_bilinear(img, mat, 40)
    assert u8.dtype == torch.float32
    torch.testing.assert_close(u8, image.warp_affine_bilinear(img.float(), mat, 40),
                               rtol=0, atol=0)


def test_image_ops_match_jax():
    rng = np.random.default_rng(1)
    theta, scale, u, v = (rng.uniform(lo, hi, 4).astype(np.float32) for lo, hi in
                          ((-90, 90), (0.9, 1.1), (-3, 3), (-3, 3)))
    mat = image.affine_mat(*(torch.from_numpy(a) for a in (theta, scale, u, v)), 32.0)
    np.testing.assert_allclose(mat.numpy(), np.asarray(jax_image.affine_mat(
        theta, scale, u, v, 32.0)), rtol=1e-5, atol=1e-5)
    pts = rng.normal(size=(4, 7, 2)).astype(np.float32) * 10
    np.testing.assert_allclose(
        image.transform_points2d(torch.from_numpy(pts), mat).numpy(),
        np.asarray(jax_image.transform_points2d(jnp.asarray(pts), jnp.asarray(mat.numpy()))),
        rtol=1e-5, atol=1e-4)
    img = rng.uniform(0, 255, (4, 32, 32, 3)).astype(np.float32)
    np.testing.assert_allclose(
        image.warp_affine_bilinear(torch.from_numpy(img), mat).numpy(),
        np.asarray(jax_image.warp_affine_bilinear(jnp.asarray(img), jnp.asarray(mat.numpy()))),
        atol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_normalize_imagenet_builds_its_constants_once(dtype):
    """Bit for bit the formula that builds the constants at every call, and
    a second call on the same dtype and device reuses the tensors of the
    first, built outside inference mode even when the first call is in it."""
    img = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (2, 8, 8, 3))).to(dtype)
    want = ((img - torch.tensor(image.IMAGENET_MEAN, dtype=dtype))
            / torch.tensor(image.IMAGENET_STD, dtype=dtype))
    image._IMAGENET.pop((dtype, img.device), None)
    with torch.inference_mode():
        first = image.normalize_imagenet(img)
    consts = image._IMAGENET[(dtype, img.device)]
    second = image.normalize_imagenet(img)
    assert all(a is b for a, b in zip(image._IMAGENET[(dtype, img.device)], consts))
    assert not any(c.is_inference() for c in consts)
    assert torch.equal(first, want) and torch.equal(second, want)


def test_host_sampler_order_matches_jax():
    for n, bs, hosts, host in ((37, 5, 1, 0), (100, 8, 3, 1)):
        ours = pipeline.HostSampler(n, bs, host, hosts, seed=4)
        theirs = jax_pipeline.HostSampler(n, bs, host, hosts, seed=4)
        for _ in range(3 * max(theirs.batches_per_epoch, 1) + 2):
            np.testing.assert_array_equal(ours.next_indices(), theirs.next_indices())
        assert ours.batches_per_epoch == theirs.batches_per_epoch


@pytest.mark.parametrize("skipped", [0, 1, 6, 7, 8, 15])
def test_host_sampler_skip_equals_that_many_draws(skipped):
    a, b = pipeline.HostSampler(61, 8, seed=2), pipeline.HostSampler(61, 8, seed=2)
    for _ in range(skipped):
        a.next_indices()
    b.skip(skipped)
    for _ in range(10):
        np.testing.assert_array_equal(a.next_indices(), b.next_indices())


# --- synthetic batches -------------------------------------------------------

@pytest.mark.parametrize("scene", [False, True])
def test_synthetic_batch_from_jax_draws_matches_jax(assets, scene):
    ours, theirs = assets
    b, size = 5, 128
    key = jax.random.PRNGKey(11)
    want = _np(jax_synthetic_batch(theirs, key, batch_size=b, img_size=size, with_cam=True,
                                   with_img=True, scene=scene))
    keys = jax.random.split(key, 16)
    d = {}
    for side, ks in (("left", keys[0:5]), ("right", keys[5:10])):
        d[f"root_{side}"] = jax.random.normal(ks[0], (b, 3)) * 0.5
        d[f"pose_{side}"] = jax.random.normal(ks[1], (b, 45)) * 0.3
        d[f"shape_{side}"] = jax.random.normal(ks[2], (b, 10)) * 0.5
        d[f"scale_{side}"] = jax.random.uniform(ks[3], (b,), minval=0.8, maxval=1.5)
        d[f"trans_{side}"] = jax.random.uniform(ks[4], (b, 2), minval=-0.3, maxval=0.3)
    d["root_rel"] = jax.random.normal(keys[10], (b, 3)) * 0.05
    if scene:
        d["phi"] = jax.random.uniform(keys[12], (b,), maxval=2 * jnp.pi)
        d["rad"] = jax.random.uniform(keys[13], (b,), minval=0.07, maxval=0.18)
        d["z"] = jax.random.normal(keys[14], (b,))
        d["fill"] = jax.random.uniform(keys[15], (b,), minval=0.60, maxval=0.90)
        d["jitter"] = jax.random.uniform(keys[11], (b, 2), minval=-0.05, maxval=0.05)
    d["img"] = jax.random.normal(keys[11], (b, size, size, 3))
    got = synthetic_from_draws(ours, {k: torch.from_numpy(np.array(v)) for k, v in d.items()},
                               img_size=size, with_cam=True, scene=scene)
    assert set(got) == set(want)
    _close({k: v.numpy() for k, v in got.items()}, want, rtol=1e-4, atol=1e-5)


# --- BatchNorm in training, B2's backward --------------------------------------

def test_batchnorm_training_matches_flax():
    """Output and running statistics after two training forwards, against
    flax `nn.BatchNorm(momentum=0.9)`; torch's stock module blends the
    unbiased variance instead."""
    import flax.linen as nn

    rng = np.random.default_rng(0)
    xs = [(rng.normal(size=(2, 3, 3, 8)) * 2 + 1).astype(np.float32) for _ in range(2)]
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    stats = variables["batch_stats"]
    ours, stock = BatchNorm2d(8), torch.nn.BatchNorm2d(8)
    for x in xs:
        y_j, mutated = bn.apply({"params": variables["params"], "batch_stats": stats},
                                jnp.asarray(x), mutable=["batch_stats"])
        stats = mutated["batch_stats"]
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        y = ours(xt)
        stock(xt)
        np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y_j),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours.running_mean.numpy(), np.asarray(stats["mean"]), rtol=1e-6)
    np.testing.assert_allclose(ours.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-6)
    assert np.abs(stock.running_var.numpy() - np.asarray(stats["var"])).max() > 1e-2
    assert int(ours.num_batches_tracked) == 0


def test_conv3x3_backward_matches_jax_vjp():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 7, 16)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 16, 24)) / 12).astype(np.float32)
    g = rng.normal(size=(2, 9, 7, 24)).astype(np.float32)
    _, vjp = jax.vjp(_xla_conv3x3, jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    conv3x3._Conv3x3Fn.apply(xt, wt).backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw_j), rtol=1e-5, atol=1e-5)


def test_conv3x3_backward_formula_gradcheck():
    """The autograd Function's transpose pair (dx through the forward with
    the flipped, channel-swapped kernel; dw from `conv2d_weight`), in
    float64, on a permuted (non-contiguous) output gradient as the ResNet
    gives it."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 6, 3, dtype=torch.float64, generator=g, requires_grad=True)
    w = torch.randn(3, 3, 3, 4, dtype=torch.float64, generator=g, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda x, w: conv3x3._Conv3x3Fn.apply(x, w).permute(0, 3, 1, 2).sin(), (x, w))
