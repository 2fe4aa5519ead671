"""One train step of the port against `renderih_tpu.train.trainer.
make_train_step(mesh=None)` on the CPU: the small config (resnet18, img
128, grid 4), batch 4, f32, dropout 0, the same weights (carried with
`utils/weights.py`) and batch, every loss term on (edge gate open, camera
term weighted). JAX runs at `highest` matmul precision (tests/conftest.py).

Checked:
  * SGD at lr 1e3, so that (p0 − p1)/lr recovers JAX's gradient: the loss
    terms within 1e-4 relative; BatchNorm running mean and var within 1e-5
    of each buffer's largest value (torch's own update, with the unbiased
    variance, misses by more than 1e-4 at the C5 map); step 1; the frozen
    upsample unchanged; every gradient within 1.5e-3·max|g_ref| + 1e-7 of
    its tensor and 80% of the tensors within 1e-4·max|g_ref| + 1e-7.
  * AdamW, from the gradient tests' init and batch: the moments within
    1.5e-3 (first: 0.1·g) and 3e-3 (second: 0.001·g², twice g's relative
    error) of each tensor's largest value; 99.9% of the parameters within
    0.05·lr of JAX's, all within 2·lr.
  * grad_accum=2 with SGD against JAX's grad_accum=2.
  * A NaN batch: both skip; nothing in the port's state changes.

Why the gradient tolerance is not 1e-4 for every tensor. Two float32
implementations (XLA's, torch's) of this network part at a random init in
two ways:
  * a branch taken one way in one and the other way in the other: a ReLU
    input or a max-pool runner-up within rounding (~1e-6) of its kink. One
    decoder ReLU element at -1.1e-6 on one side and +2.1e-7 on the other
    moved 25% of the tensors by more than 1e-3 (worst 6.0e-3). Against the
    port run in float64, torch at one thread was within 2.1e-4 on every
    tensor and JAX 6.0e-3 away: the branch, not a formula. The gradient
    tests therefore run from the same weights with the encoder's
    BatchNorm biases raised by 3 (`BN_BIAS`: no ReLU after a BatchNorm
    near 0), on images whose every ReLU input is at least 8e-6 from 0 and
    every max-pool window's top two at least 2e-6 apart in the forwards
    they make (`GRAD_IMG_SEED`, picked by scanning seeds; the premise is
    itself a test below);
  * rounding amplified by the BatchNorms' batch-mean subtraction (batch 4,
    a 4x4 C5 map: 64 values a channel): from those batches the worst
    tensor measured 6.3e-4 (grad_accum 2: 5.8e-4), with 87% (85%) of the
    tensors within 1e-4; one thread against all threads, 96% within 1e-4.
The limits sit between that and planted faults of the port at one
thread: the camera term dropped (worst 2.9e-3, 5% of tensors within
1e-4), the normal term dropped (2.1e-3, 37%), the camera weight 10% off
(6.7e-4, 76%), the edge term dropped (3.9e-2), half the batch (3.9), and
a wrong 1/accum (every tensor off by a factor of 2). Two of them are
tests below. The statistics and loss checks run from the weights as
initialised, on the batch `init` makes.

The JAX steps compile once per optimizer, in fixtures; a second init goes
through the same compiled step.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from renderih_tpu.assets import make_synthetic_assets as jax_assets
from renderih_tpu.config import load_config as jax_load_config
from renderih_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from renderih_tpu.models import init_model as jax_init_model
from renderih_tpu.train.state import create_train_state as jax_create_train_state
from renderih_tpu.train.trainer import make_train_step as jax_make_train_step
from renderih_tpu_torch.assets import make_synthetic_assets
from renderih_tpu_torch.config import load_config
from renderih_tpu_torch.models import build_model, model_call_kwargs
from renderih_tpu_torch.train.state import create_train_state
from renderih_tpu_torch.train.trainer import make_train_step
from renderih_tpu_torch.utils.weights import state_dict_from_jax

B, SPE = 4, 10
BASE = {
    "model": {"encoder": "resnet18", "img_size": 128, "grid_size": 4,
              "gcn_in_dims": [64, 32, 16], "gcn_out_dims": [32, 16, 8],
              "img_dims": [32, 16, 8], "deconv_dims": [32, 32, 32, 32],
              "graph_layer_num": 2, "dropout": 0.0},
    "train": {"precision": "f32", "batch_size": B, "warmup_epochs": 0},
    "loss": {"norm_epoch": 0, "camera": 1.0},
}
BN_BUFFERS = (".running_mean", ".running_var")
BN_BIAS = 3.0
# numpy seeds of the gradient tests' images, by grad_accum: from the
# shifted init, every ReLU input is >= 8e-6 from 0 and every max-pool
# window's top two >= 2e-6 apart, in the full batch (1) and in each half (2)
GRAD_IMG_SEED = {1: 52, 2: 155}
RELU_MARGIN, POOL_MARGIN = 8e-6, 2e-6


def _shift_bn_bias(tree: dict, shift: float) -> dict:
    """The encoder's BatchNorm biases raised by `shift`, so that no ReLU
    input after a BatchNorm lies within rounding of 0 (see the module
    docstring)."""
    return {k: (dict(v, bias=v["bias"] + shift) if k.startswith(("bn", "downsample_bn"))
                else _shift_bn_bias(v, shift) if isinstance(v, dict) else v)
            for k, v in tree.items()}


def _cfg(**train):
    return {**BASE, "train": {**BASE["train"], **train}}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def init():
    """JAX init at the small config with random BatchNorm statistics, and
    one batch (JAX synthetic labels, numpy image)."""
    jcfg = jax_load_config(overrides=_cfg())
    jassets = jax_assets(0)
    jmodel, variables = jax_init_model(jcfg, jassets, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 1.5, a.shape) if path[-1].key == "var"
                         else rng.normal(0.0, 0.1, a.shape)).astype(np.float32),
        variables["batch_stats"])
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    batch = {k: np.asarray(v) for k, v in jax_synthetic_batch(
        jassets, jax.random.PRNGKey(1), batch_size=B, img_size=128).items()}
    batch["img"] = np.random.default_rng(0).normal(size=(B, 128, 128, 3)).astype(np.float32)
    shifted = dict(params, encoder=_shift_bn_bias(params["encoder"], BN_BIAS))
    grad_batch = {accum: dict(batch, img=np.random.default_rng(seed).normal(
        size=(B, 128, 128, 3)).astype(np.float32)) for accum, seed in GRAD_IMG_SEED.items()}
    return dict(jmodel=jmodel, jassets=jassets, params=params, shifted=shifted,
                stats=stats, batch=batch, grad_batch=grad_batch,
                assets=make_synthetic_assets(0))


def _jax_step(init, overrides, params=None, batch=None):
    """JAX's make_train_step on the init (or on `params`) and its batch (or
    `batch`); (state before, state after, terms, the jitted step)."""
    jcfg = jax_load_config(overrides=overrides)
    params = init["params"] if params is None else params
    state0 = jax_create_train_state(jcfg, {"params": params, "batch_stats": init["stats"]}, SPE)
    step, _ = jax_make_train_step(jcfg, init["jmodel"], init["jassets"], SPE,
                                  params_template=init["params"])
    state1, terms = _run(step, state0, init["batch"] if batch is None else batch)
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return host(state0), host(state1), terms, step


def _jax_again(init, overrides, step, params, batch):
    """The compiled `step` again, from `params` on `batch`; (state before,
    after)."""
    jcfg = jax_load_config(overrides=overrides)
    state0 = jax_create_train_state(jcfg, {"params": params, "batch_stats": init["stats"]}, SPE)
    state1, _ = _run(step, state0, batch)
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return host(state0), host(state1)


def _run(step, state0, batch):
    state1, terms = step(jax.tree_util.tree_map(jnp.array, state0),
                         {k: jnp.asarray(v) for k, v in batch.items()},
                         jax.random.PRNGKey(2))
    return state1, {k: float(v) for k, v in terms.items()}


def _port_step(init, overrides, params=None, batch=None):
    """The port's step on the same init (or `params`) and batch; (state,
    terms)."""
    cfg = load_config(overrides=overrides)
    model = build_model(cfg, init["assets"])
    params = init["params"] if params is None else params
    model.load_state_dict(state_dict_from_jax(params, init["stats"]))
    state = create_train_state(cfg, model, SPE)
    step = make_train_step(cfg, init["assets"], SPE, "cpu")
    batch = init["batch"] if batch is None else batch
    terms = step(state, {k: torch.tensor(v) for k, v in batch.items()})
    return state, {k: float(v) for k, v in terms.items()}


def _as_port(init, tree) -> dict:
    """A JAX params-shaped tree (frozen leaves MaskedNode -> 0) in the
    port's names."""
    def fill(p, x):
        if isinstance(p, dict):
            return {k: fill(p[k], x[k]) for k in p}
        return np.zeros_like(p) if isinstance(x, optax.MaskedNode) else np.asarray(x)
    return state_dict_from_jax(fill(init["params"], tree), init["stats"])


def _sd(params, bstats) -> dict:
    return {k: v.numpy() for k, v in state_dict_from_jax(params, bstats).items()}


def _check_terms(got: dict, want: dict, rtol: float = 1e-4):
    assert set(got) == set(want)
    for k, ref in want.items():
        assert abs(got[k] - ref) <= rtol * abs(ref) + 1e-7, (k, got[k], ref)


def _check_bn(state, jstate1):
    want = _sd(jstate1.params, jstate1.batch_stats)
    got = state.model.state_dict()
    worst = 0.0
    for k, ref in want.items():
        if k.endswith(BN_BUFFERS):
            err = np.abs(got[k].numpy() - ref).max() / np.abs(ref).max()
            worst = max(worst, err)
            assert err <= 1e-5, (k, err)
    return worst


def _check_grads(state, jstate0, jstate1, lr: float):
    """Port .grad against JAX's (p0 − p1)/lr, tensor by tensor: every
    tensor within 1.5e-3·max|g_ref| + 1e-7 and 80% of them within
    1e-4·max|g_ref| + 1e-7 (the module docstring says why). The key
    projections' biases, whose gradient is 0 in exact arithmetic (a
    per-query constant added to every logit), are rounding noise on both
    sides: held against the larger of their own and their weight's
    gradient."""
    p0 = _sd(jstate0.params, jstate0.batch_stats)
    p1 = _sd(jstate1.params, jstate1.batch_stats)
    rel = {}
    for name, p in state.model.named_parameters():
        g_ref = (p0[name] - p1[name]) / lr
        if not p.requires_grad:
            assert name == "decoder.unsample_layer.weight"
            assert not g_ref.any()  # frozen in JAX too
            continue
        err = np.abs(p.grad.numpy() - g_ref).max()
        scale = np.abs(g_ref).max()
        if name.endswith("w_ks.bias"):
            w = name[:-len("bias")] + "weight"
            scale = max(scale, np.abs((p0[w] - p1[w]) / lr).max())
        assert err <= 1.5e-3 * scale + 1e-7, (name, err, scale)
        rel[name] = err <= 1e-4 * scale + 1e-7
    tight = np.mean(list(rel.values()))
    assert tight >= 0.8, tight


@pytest.fixture(scope="module")
def sgd(init):
    """One SGD step on the init (loss terms, BatchNorm statistics, NaN
    guard) and one on the init with shifted BatchNorm biases and the
    gradient batch (gradients), through one compiled JAX step."""
    over = _cfg(optimizer="sgd", lr=1e3)
    j0, j1, jterms, jstep = _jax_step(init, over)
    state, terms = _port_step(init, over)
    js0, js1 = _jax_again(init, over, jstep, init["shifted"], init["grad_batch"][1])
    shifted, _ = _port_step(init, over, init["shifted"], init["grad_batch"][1])
    return dict(over=over, j0=j0, j1=j1, jterms=jterms, jstep=jstep, state=state,
                terms=terms, js0=js0, js1=js1, shifted=shifted)


def test_sgd_step_loss_terms_match_jax(sgd):
    assert sgd["jterms"]["skipped_nonfinite"] == 0.0
    assert sgd["terms"]["camera"] > 0 and sgd["terms"]["edge"] > 0
    _check_terms(sgd["terms"], sgd["jterms"])


def test_sgd_step_gradients_match_jax(sgd):
    _check_grads(sgd["shifted"], sgd["js0"], sgd["js1"], lr=1e3)


@pytest.mark.parametrize("term", ["camera", "normal"])
def test_gradient_check_fails_on_a_dropped_loss_term(sgd, init, term):
    """The gradient limits are tight enough to see a loss term of the
    port's dropped, one whose gradient is small beside the others'."""
    over = sgd["over"]
    fault = {**over, "loss": {**over["loss"], term: 0.0}}
    state, _ = _port_step(init, fault, init["shifted"], init["grad_batch"][1])
    with pytest.raises(AssertionError):
        _check_grads(state, sgd["js0"], sgd["js1"], lr=1e3)


@pytest.mark.parametrize("accum", sorted(GRAD_IMG_SEED))
def test_gradient_batches_keep_every_branch_off_its_kink(init, accum, monkeypatch):
    """The premise of the gradient tests (module docstring): in the port's
    forwards of the gradient batch from the shifted init, every ReLU input
    is at least RELU_MARGIN from 0 and every max-pool window's top two at
    least POOL_MARGIN apart (windows that are all 0 after a ReLU aside)."""
    import torch.nn.functional as F

    relu_gap, pool_gap = [], []
    relu, max_pool2d = F.relu, F.max_pool2d

    def traced_relu(x, inplace=False):
        relu_gap.append(float(x.detach().abs().min()))
        return relu(x, inplace=inplace)

    def traced_pool(x, kernel_size, stride=None, padding=0, *args, **kwargs):
        xp = F.pad(x.detach(), (padding,) * 4, value=float("-inf"))
        cols = F.unfold(xp.flatten(0, 1)[:, None], kernel_size, stride=stride)
        top = cols.topk(2, dim=1).values
        live = top[:, 0] > 0
        pool_gap.append(float((top[:, 0] - top[:, 1])[live].min()))
        return max_pool2d(x, kernel_size, stride, padding, *args, **kwargs)

    monkeypatch.setattr(F, "relu", traced_relu)
    monkeypatch.setattr(F, "max_pool2d", traced_pool)
    cfg = load_config(overrides=_cfg(grad_accum=accum))
    model = build_model(cfg, init["assets"]).train()
    model.load_state_dict(state_dict_from_jax(init["shifted"], init["stats"]))
    img = torch.from_numpy(init["grad_batch"][accum]["img"])
    call_kwargs = model_call_kwargs(init["assets"], "cpu")
    with torch.no_grad():
        for part in img.split(B // accum):
            model(part, **call_kwargs)
    assert relu_gap and pool_gap
    assert min(relu_gap) >= RELU_MARGIN and min(pool_gap) >= POOL_MARGIN, (
        min(relu_gap), min(pool_gap))


def test_sgd_step_bn_stats_step_and_frozen_upsample_match_jax(sgd):
    state, j1 = sgd["state"], sgd["j1"]
    assert state.step == int(j1.step) == 1
    _check_bn(state, j1)
    w0 = _sd(sgd["j0"].params, sgd["j0"].batch_stats)["decoder.unsample_layer.weight"]
    np.testing.assert_array_equal(
        state.model.decoder.unsample_layer.weight.detach().numpy(), w0)


def test_stock_batchnorm_update_would_miss(sgd, init):
    """torch's own running-var update (unbiased variance) is outside the
    tolerance the port's BatchNorm2d meets: the check can tell."""
    j1 = sgd["j1"]
    want = _sd(j1.params, j1.batch_stats)
    key = "encoder.resnet.layer4.1.bn2.running_var"  # the C5 map: 4x4xB values
    v0 = init["stats"]["encoder"]["layer4_1"]["bn2"]["var"]
    got = sgd["state"].model.state_dict()[key].numpy()
    n = B * 4 * 4
    stock = 0.9 * v0 + (got - 0.9 * v0) * n / (n - 1)
    assert np.abs(got - want[key]).max() / np.abs(want[key]).max() <= 1e-5
    assert np.abs(stock - want[key]).max() / np.abs(want[key]).max() > 1e-4


def test_nan_batch_is_skipped_like_jax(sgd, init):
    bad = dict(init["batch"], img=np.full_like(init["batch"]["img"], np.nan))
    _, jterms = _run(sgd["jstep"], sgd["j0"], bad)
    assert jterms["skipped_nonfinite"] == 1.0
    state = sgd["state"]
    before = copy.deepcopy(state.model.state_dict())
    opt_before = copy.deepcopy(state.optimizer.state_dict())
    step = make_train_step(load_config(overrides=sgd["over"]), init["assets"], SPE, "cpu")
    terms = step(state, {k: torch.tensor(v) for k, v in bad.items()})
    assert float(terms["skipped_nonfinite"]) == 1.0 and state.step == 1
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0, msg=k)
    assert state.optimizer.state_dict()["state"].keys() == opt_before["state"].keys()


def test_adamw_step_matches_jax(init):
    lr = 1e-3
    over = _cfg(optimizer="adamw", lr=lr)
    j0, j1, jterms, _ = _jax_step(init, over, init["shifted"], init["grad_batch"][1])
    state, terms = _port_step(init, over, init["shifted"], init["grad_batch"][1])
    _check_terms(terms, jterms)
    assert state.step == int(j1.step) == 1
    adam = [s for s in jax.tree_util.tree_leaves(
        j1.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(adam) == 1
    mu, nu = (_as_port(init, m) for m in (adam[0].mu, adam[0].nu))
    want = _sd(j1.params, j1.batch_stats)
    worst_p, n_close, n_all = 0.0, 0, 0
    for name, p in state.model.named_parameters():
        got_p = p.detach().numpy()
        diff = np.abs(got_p - want[name])
        worst_p = max(worst_p, diff.max())
        n_close += int((diff <= 0.05 * lr).sum())
        n_all += diff.size
        if not p.requires_grad:
            np.testing.assert_array_equal(got_p, want[name])
            continue
        if name.endswith("w_ks.bias"):  # gradient 0 but for rounding (see _check_grads)
            continue
        s = state.optimizer.state[p]
        for key, ref, rel in (("exp_avg", mu[name].numpy(), 1.5e-3),
                              ("exp_avg_sq", nu[name].numpy(), 3e-3)):
            err = np.abs(s[key].numpy() - ref).max()
            assert err <= rel * np.abs(ref).max() + 1e-12, (name, key, err)
    # Adam's first step moves an element by ~lr·sign(g): an element whose
    # |g| is below the gradients' rounding differences may move the other way
    assert worst_p <= 2.01 * lr, worst_p
    assert n_close / n_all >= 0.999, n_close / n_all


def test_grad_accum_2_matches_jax(init):
    over = _cfg(optimizer="sgd", lr=1e3, grad_accum=2)
    j0, j1, jterms, jstep = _jax_step(init, over)
    state, terms = _port_step(init, over)
    _check_terms(terms, jterms)
    _check_bn(state, j1)
    assert state.step == int(j1.step) == 1
    js0, js1 = _jax_again(init, over, jstep, init["shifted"], init["grad_batch"][2])
    shifted, _ = _port_step(init, over, init["shifted"], init["grad_batch"][2])
    _check_grads(shifted, js0, js1, lr=1e3)
