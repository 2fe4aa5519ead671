"""The port's data-parallel training on the CPU: world 2 over gloo against
JAX's `data = 2` mesh and against the port's own world 1.

`tests/test_torch_train.py`'s small config (resnet18, 128², grid 4,
batch 4, f32, dropout 0) and its inputs: JAX's init with random BatchNorm
statistics carried to the port by `state_dict_from_jax`, its batch, and
for the gradients the init with the encoder's BatchNorm biases raised by
3 and `GRAD_IMG_SEED`'s images, clear of every ReLU and max-pool kink
(that file's docstring says why). JAX's parameters come from a jitted
init, which parts from that file's eager one by at most 7.5e-9 in 9
position-embedding tensors, far inside the images' 8e-6 margins; the
labels from a jitted `synthetic_batch` (the eager one's within 1e-5 px;
labels enter no ReLU or max-pool).

One world of two spawned ranks (`tests/_torch_dist_worker.py`, a module
fixture) runs every world-2 scenario and one more process the port's
world-1 references, while this process compiles JAX's sharded step
(`make_train_step(mesh=make_mesh(data=2, devices=jax.devices()[:2]))`). Each rank
holds rows `parallel.dist.rank_rows` of the global batch of 4. Checked:
  (a) the BatchNorm alone: two ranks each constant per channel (1 and 3)
      normalise to ∓1 with global statistics and to 0 with the stock
      per-replica module; running mean and variance as flax's global rule
      within 1e-6; on random inputs the forward, dx and the rank-summed
      dγ, dβ as one device on the concatenated batch (1e-5 of each
      tensor's largest value);
  (b) one SGD step (lr 1e3: (p0 − p1)/lr is the gradient) against JAX's
      sharded step at grad_accum 2, at the limits
      `test_torch_train.py` holds the one-device step to: the terms within
      1e-4 relative, the BatchNorm statistics within 1e-5, every
      gradient within 1.5e-3·max|g_ref| + 1e-7 and 80% of the tensors
      within 1e-4. Accum 2 is the case where each rank holds two
      interleaved micro-batches; accum 1 is held by (c) against world 1,
      which `test_torch_train.py` holds against JAX's one-device step;
  (c) world 2 against world 1 at the same global batch: the terms within
      1e-4 relative, the statistics within 1e-5 of each buffer's largest
      value, the gradients at (b)'s limits, and the two ranks' states
      equal bit for bit. The gradients cannot be held to 1e-5: the same
      world-1 step at one and at four threads parts by as much (median
      tensor 3.7e-6, worst 2.6e-4; world 2 against world 1: 4.5e-6 and
      2.1e-4), so the test also holds world 2's median gap to at most
      three times that thread-count gap. Planted faults fall outside, and
      the test says by how much: the per-replica BatchNorm (statistics
      8.1e-2 away, 4% of the gradients within 1e-4) and contiguous per-rank
      rows under grad_accum 2 (6.8e-2, 4%);
  (d) ZeRO-1 on against off, AdamW, two steps: equal within 1e-6 (bit
      for bit). The sharded run's checkpoint after step 1 loads at world 1
      equal bit for bit to its state, and its step 2 resumed at world 1
      matches the uninterrupted world-2 step 2: the terms within 1e-4,
      the moments and statistics within `RESUME_TOL` of each tensor's
      largest value. The parameters: AdamW moves an element by about lr
      whatever the size of its gradient, so an element whose gradient is
      within rounding of 0 may move either way; all within 2.01·lr and
      99.9% within `RESUME_TOL`·lr;
  (e) a NaN image on rank 1 alone: both ranks skip, their states equal to
      the states before the step;
  (f) an exception on rank 1 in `apps.train --multihost`: both processes
      end with a non-zero exit within the test's timeout;
and `apps.train --multihost` at world 2: SIGTERM on one rank stops both
after the same step with a `preempt` checkpoint; the in-training eval
and the metrics are rank 0's alone. The SIGTERM run and then (f)'s run
go through one world of two more spawned ranks, beside the module world.
"""

import functools
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_worker as worker
from renderih_tpu.config import load_config as jax_load_config
from renderih_tpu.models.model import build_model as jax_build_model
from renderih_tpu.models.model import model_call_kwargs as jax_call_kwargs
from renderih_tpu.parallel.mesh import make_mesh as jax_make_mesh
from renderih_tpu.parallel.mesh import shard_batch
from renderih_tpu.assets import make_synthetic_assets as jax_assets
from renderih_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from renderih_tpu.train.state import create_train_state as jax_create_train_state
from renderih_tpu.train.trainer import make_train_step as jax_make_train_step
from renderih_tpu.train.trainer import shard_train_state
from renderih_tpu_torch.config import dump_config, load_config
from renderih_tpu_torch.parallel import dist
from renderih_tpu_torch.parallel.mesh import make_mesh
from renderih_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_train import BASE, BN_BIAS, GRAD_IMG_SEED, SPE, _cfg, _shift_bn_bias

B = BASE["train"]["batch_size"]
LR = 1e-3  # AdamW in (d)
RESUME_TOL = 1e-3
WORLD_TIMEOUT = 300  # seconds for the module world and the references; ~35 s
APP_TIMEOUT = 120  # the app world: seconds for both ranks to end after the fixture
BN_BUFFERS = (".running_mean", ".running_var")


@pytest.fixture(scope="module")
def world():
    """The inputs, the world-2 runs (two ranks), JAX's sharded step, the
    port's world-1 references (one more process) and the (d) resume; the
    app world, joined by the first test that reads it. Every process is
    started first and imports while this one prepares the inputs."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = tempfile.TemporaryDirectory(prefix="renderih_dist_")
    ready = worker.ready_event()
    procs = []
    try:
        procs += _start_app_world(tmp.name)
        procs += worker.start_world(worker.module_world, tmp.name, ready=ready)
        procs += worker.start_world(worker.world1_refs, tmp.name, world=1, ready=ready,
                                    group=False)
        yield dict(_world(tmp.name, ready, procs[2:]), app=procs[:2], app_codes=[])
    finally:
        worker.join_world(procs, 0)  # kills any process a test left running
        torch.set_num_threads(prev)
        tmp.cleanup()


def _start_app_world(tmp: str) -> list:
    """The world of `apps.train --multihost` at batch 1 a rank
    (`worker.app_world`): the SIGTERM run (256², an eval every epoch),
    then (f)'s, the loss raising on rank 1 at its second step; its
    processes, started."""
    over = _cfg(batch_size=1)
    for name, model, train in (
            ("sigterm", {"img_size": 256},
             {"eval_every": 1, "save_gap": 1, "vis_every_eval": False}),
            ("failing", {}, {})):
        os.makedirs(f"{tmp}/app/{name}")
        dump_config(load_config(overrides={
            **over, "model": {**over["model"], **model},
            "train": {**over["train"], "checkpoint_dir": f"{tmp}/app/{name}/ck",
                      "log_every": 1, **train}}), f"{tmp}/app/{name}/app.yaml")
    return worker.start_world(worker.app_world, f"{tmp}/app")


def _app_codes(world: dict) -> list:
    """The app world's exit codes, waited for once (None: killed at the
    timeout)."""
    if not world["app_codes"]:
        world["app_codes"] += worker.join_world(world["app"], APP_TIMEOUT)
    return world["app_codes"]


def _world(workdir: str, ready, procs: list) -> dict:
    jcfg = jax_load_config(overrides=_cfg())
    jassets = jax_assets(0)
    jmodel = jax_build_model(jcfg, jassets)
    kwargs = jax_call_kwargs(jcfg, jassets)
    variables = jax.jit(lambda key: jmodel.init(
        {"params": key, "dropout": jax.random.fold_in(key, 1)},
        jnp.zeros((1, 128, 128, 3)), train=False, **kwargs))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 1.5, a.shape) if path[-1].key == "var"
                         else rng.normal(0.0, 0.1, a.shape)).astype(np.float32),
        variables["batch_stats"])
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    shifted = dict(params, encoder=_shift_bn_bias(params["encoder"], BN_BIAS))
    batch = {k: np.asarray(v) for k, v in jax.jit(functools.partial(
        jax_synthetic_batch, jassets, batch_size=B, img_size=128))(jax.random.PRNGKey(1)).items()}
    batch["img"] = np.random.default_rng(0).normal(size=(B, 128, 128, 3)).astype(np.float32)
    grad_batch = {a: dict(batch, img=np.random.default_rng(seed).normal(
        size=(B, 128, 128, 3)).astype(np.float32)) for a, seed in GRAD_IMG_SEED.items()}
    sgd = {a: _cfg(optimizer="sgd", lr=1e3, grad_accum=a) for a in (1, 2)}
    adamw = {z: _cfg(optimizer="adamw", lr=LR, zero1=z) for z in (True, False)}
    tensors = lambda b: {k: torch.from_numpy(v) for k, v in b.items()}
    inputs = dict(plain=state_dict_from_jax(params, stats),
                  shifted=state_dict_from_jax(shifted, stats),
                  batch=tensors(batch), grad_batch={a: tensors(b) for a, b in grad_batch.items()},
                  global_batch=B, sgd=sgd, adamw=adamw)
    torch.save(inputs, f"{workdir}/inputs.pt")
    ready.set()

    # meanwhile: JAX's sharded step at grad_accum 2 (one compile), from the
    # plain init on the batch and from the shifted init on the gradient batch
    mesh = jax_make_mesh(data=2, model=1, devices=jax.devices()[:2])
    jcfg2 = jax_load_config(overrides=sgd[2])
    step, _ = jax_make_train_step(jcfg2, jmodel, jassets, SPE, mesh=mesh,
                                  params_template=params)
    jax_runs = {}
    for name, p, b in (("plain", params, batch), ("shifted", shifted, grad_batch[2])):
        state0 = jax_create_train_state(jcfg2, {"params": p, "batch_stats": stats}, SPE)
        host0 = jax.tree_util.tree_map(np.asarray, state0)
        state1, terms = step(shard_train_state(state0, mesh, jcfg2),
                             shard_batch({k: jnp.asarray(v) for k, v in b.items()}, mesh),
                             jax.random.PRNGKey(2))
        jax_runs[name] = dict(
            p0=state_dict_from_jax(host0.params, host0.batch_stats),
            p1=state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state1.params),
                                   jax.tree_util.tree_map(np.asarray, state1.batch_stats)),
            terms={k: float(v) for k, v in terms.items()})

    codes = worker.join_world(procs, WORLD_TIMEOUT)
    outs = [torch.load(f"{workdir}/out_r{r}.pt", weights_only=False) for r in range(2)
            if os.path.exists(f"{workdir}/out_r{r}.pt")]
    for r, out in enumerate(outs):
        assert "error" not in out, f"rank {r}:\n{out['error']}"
    assert codes == [0, 0, 0], f"world, refs exit codes {codes} (None: killed at the timeout)"
    refs = torch.load(f"{workdir}/refs.pt", weights_only=False)
    return dict(inputs=inputs, jax=jax_runs, refs=refs, outs=outs, loaded=refs.pop("loaded"),
                resumed=refs.pop("resumed"), resumed_terms=refs.pop("resumed_terms"),
                workdir=workdir)


def _rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    return err / scale if scale > 0 else (0.0 if err == 0 else float("inf"))


def _check_terms(got: dict, want: dict, rtol: float = 1e-4):
    assert set(got) == set(want)
    for k, ref in want.items():
        assert abs(got[k] - ref) <= rtol * abs(ref) + 1e-7, (k, got[k], ref)


def _bn_gap(model: dict, ref: dict) -> float:
    return max(_rel(model[k], torch.as_tensor(ref[k])) for k in ref if k.endswith(BN_BUFFERS))


def _gap(name: str, got: dict, ref: dict, atol: float = 0.0) -> float:
    """(max|got − ref| − atol) / max|ref| for tensor `name`; the key
    projections' biases, whose gradient is 0 but for rounding (a per-query
    constant added to every logit), over the larger of their own and
    their weight's scale, as `test_torch_train._check_grads` holds them."""
    r = ref[name]
    scale = float(r.abs().max())
    if name.endswith("w_ks.bias"):
        scale = max(scale, float(ref[name[:-4] + "weight"].abs().max()))
    err = float((got[name] - r).abs().max()) - atol
    return err / scale if scale > 0 else (0.0 if err <= 0 else float("inf"))


def _grad_gaps(grads: dict, ref: dict) -> dict:
    """Each gradient's gap to `ref` (1e-7 absolute allowed)."""
    return {name: _gap(name, grads, ref, 1e-7) for name in grads}


def _check_grads(grads: dict, ref: dict) -> dict:
    gaps = _grad_gaps(grads, ref)
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= 1.5e-3, (worst, gaps[worst])
    tight = np.mean([v <= 1e-4 for v in gaps.values()])
    assert tight >= 0.8, tight
    return gaps


def _jax_grads(run: dict) -> dict:
    return {k: (run["p0"][k] - run["p1"][k]) / 1e3
            for k in run["p0"] if not k.endswith(BN_BUFFERS)}


def test_rank_rows_interleave_the_micro_batches():
    """Rank r's micro-batch i is global rows [(i·W + r)·m, (i·W + r + 1)·m)."""
    np.testing.assert_array_equal(dist.rank_rows(8, 2, 0, 1), [0, 1, 2, 3])
    np.testing.assert_array_equal(dist.rank_rows(8, 2, 1, 2), [2, 3, 6, 7])
    np.testing.assert_array_equal(dist.rank_rows(12, 3, 2, 2), [4, 5, 10, 11])
    covered = np.sort(np.concatenate([dist.rank_rows(16, 4, r, 2) for r in range(4)]))
    np.testing.assert_array_equal(covered, np.arange(16))
    with pytest.raises(ValueError, match="divisible"):
        dist.rank_rows(6, 2, 0, 2)
    assert dist.rank() == 0 and dist.world() == 1 and not dist.active()


def test_make_mesh_lays_the_data_axis_over_the_devices_given():
    mesh = make_mesh(2, devices=["cpu", "cpu"])
    assert mesh.devices == (torch.device("cpu"),) * 2 and mesh.n_data == 2
    assert make_mesh(devices=["cpu"] * 3).n_data == 3
    with pytest.raises(ValueError, match="devices"):
        make_mesh(2, devices=["cpu"])
    with pytest.raises(NotImplementedError, match="Do not port"):
        make_mesh(1, model=2, devices=["cpu", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


def test_global_batchnorm_normalises_over_both_ranks(world):
    """(a) Global statistics: mean 2, biased variance 1, so the halves go to
    ∓1/sqrt(1 + eps); the stock per-replica module sees variance 0 and
    returns 0. Running statistics as flax's rule over the whole batch:
    0.9·0.5 + 0.1·2 and 0.9·2 + 0.1·1."""
    for rank, out in enumerate(world["outs"]):
        g, stock = out["bn"]["global"], out["bn"]["stock"]
        want = (2.0 * rank - 1.0) / np.sqrt(1.0 + 1e-5)
        np.testing.assert_allclose(g["y"].numpy(), want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(stock["y"].numpy(), 0.0, rtol=0, atol=1e-4)
        np.testing.assert_allclose(g["mean"].numpy(), 0.65, rtol=0, atol=1e-6)
        np.testing.assert_allclose(g["var"].numpy(), 1.9, rtol=0, atol=1e-6)


def test_global_batchnorm_matches_one_device_on_the_whole_batch(world):
    """(a) On random inputs: each rank's output and dx are one device's on
    the concatenated batch at that rank's rows; dγ and dβ summed over the
    ranks are one device's; the running statistics are one device's."""
    from renderih_tpu_torch.models.layers import BatchNorm2d

    gen = torch.Generator().manual_seed(5)
    x = (torch.randn(6, 3, 5, 4, generator=gen) * 2.0 + 1.0).requires_grad_(True)
    w = torch.randn(6, 3, 5, 4, generator=gen)
    mod = BatchNorm2d(3)
    with torch.no_grad():
        mod.weight.copy_(torch.tensor([0.5, 1.5, -1.0]))
        mod.bias.copy_(torch.tensor([0.1, -0.2, 0.3]))
    y = mod.train()(x)
    (y * w).sum().backward()
    got = [out["bn"]["random"] for out in world["outs"]]
    close = lambda a, b: _rel(a, b) <= 1e-5
    for r, g in enumerate(got):
        assert close(g["y"], y.detach()[3 * r:3 * r + 3]), r
        assert close(g["dx"], x.grad[3 * r:3 * r + 3]), r
        assert close(g["mean"], mod.running_mean) and close(g["var"], mod.running_var), r
    assert close(got[0]["dweight"] + got[1]["dweight"], mod.weight.grad)
    assert close(got[0]["dbias"] + got[1]["dbias"], mod.bias.grad)


def test_world2_step_matches_jax_sharded_step(world):
    """(b) Port world 2 against JAX's step on the `data = 2` mesh at
    grad_accum 2: each rank's two micro-batches interleaved, with global
    statistics each."""
    out, plain, shifted = world["outs"][0], world["jax"]["plain"], world["jax"]["shifted"]
    assert plain["terms"]["skipped_nonfinite"] == 0.0
    _check_terms(out["plain_2"]["terms"], plain["terms"])
    assert _bn_gap(out["plain_2"]["bn"], plain["p1"]) <= 1e-5
    assert out["plain_2"]["step"] == 1
    _check_grads(out["shifted_2"]["grads"], _jax_grads(shifted))


@pytest.mark.parametrize("accum", [1, 2])
def test_world2_matches_world1_at_the_same_global_batch(world, accum):
    """(c) Port world 2 against port world 1, and the ranks against each
    other."""
    outs, refs = world["outs"], world["refs"]
    for name in ("plain", "shifted"):
        got, ref = outs[0][f"{name}_{accum}"], refs[f"{name}_{accum}"]
        _check_terms(got["terms"], ref["terms"])
        assert _bn_gap(got["bn"], ref["bn"]) <= 1e-5, name
        assert got["digest"] == outs[1][f"{name}_{accum}"]["digest"], name
    gaps = _check_grads(outs[0][f"shifted_{accum}"]["grads"], refs[f"shifted_{accum}"]["grads"])
    if accum == 1:  # no more than the same step's gap at four threads
        floor = _grad_gaps(refs["shifted_1_threads4"]["grads"], refs["shifted_1"]["grads"])
        assert np.median(list(gaps.values())) <= 3 * max(np.median(list(floor.values())), 1e-6)


@pytest.mark.parametrize("fault,accum", [("fault_per_replica_bn", 1),
                                         ("fault_contiguous_rows", 2)])
def test_planted_faults_fall_outside_the_world1_limits(world, fault, accum):
    """(c) The checks above see a per-replica BatchNorm and contiguous
    per-rank rows under grad_accum 2: the statistics land far outside 1e-5
    and the gradients outside (b)'s limits."""
    got, ref = world["outs"][0][fault], world["refs"][f"plain_{accum}"]
    bn = _bn_gap(got["bn"], ref["bn"])
    assert bn > 100 * 1e-5, f"{fault}: statistics {bn:.3e} of their scale, limit 1e-5"
    gaps = _grad_gaps(got["grads"], ref["grads"])
    assert max(gaps.values()) > 1.5e-3 and np.mean([v <= 1e-4 for v in gaps.values()]) < 0.8


def test_zero1_equals_the_unsharded_optimizer(world):
    """(d) AdamW under ZeRO-1 and unsharded, world 2, two steps: the
    parameters and statistics, and each rank's moments, equal (the largest
    gap over each tensor's largest value, computed on the ranks); the two
    shards split the parameters."""
    zero = [out["zero1"] for out in world["outs"]]
    for z in zero:
        assert z["model_gap"] <= 1e-6 and z["moments_gap"] <= 1e-6, z
        assert z["shard"] and set(z["shard"]) < set(z["unsharded"])
    assert not set(zero[0]["shard"]) & set(zero[1]["shard"])
    assert set(zero[0]["shard"]) | set(zero[1]["shard"]) == set(zero[0]["unsharded"])


def test_checkpoint_at_world2_resumes_at_world1(world):
    """(d) The sharded run's step-1 checkpoint, written by rank 0 in the
    one-device format, loads at world 1 into an unsharded optimizer as the
    state it was; step 2 from it matches the uninterrupted world-2 step 2
    (the module docstring gives the limits)."""
    loaded, resumed = world["loaded"], world["resumed"]
    uninterrupted = world["outs"][0]["adamw_unsharded"]
    assert loaded["step"] == 1 and resumed["step"] == 2 == uninterrupted["step"]
    assert resumed["steps_taken"] == uninterrupted["steps_taken"] == 2
    _check_terms(world["resumed_terms"], uninterrupted["terms"])
    # loaded: the step-1 state, its moments the two shards' gathered
    assert set(loaded["digest"]["moments"]) == set(uninterrupted["moments"])
    for out in world["outs"]:
        step1 = out["adamw_step1"]["digest"]
        assert loaded["digest"]["model"] == step1["model"]
        assert step1["moments"] and all(loaded["digest"]["moments"][n] == d
                                        for n, d in step1["moments"].items())
    for key in ("exp_avg", "exp_avg_sq"):
        got = {n: m[key] for n, m in resumed["moments"].items()}
        ref = {n: m[key] for n, m in uninterrupted["moments"].items()}
        for name in got:
            assert _gap(name, got, ref) <= RESUME_TOL, (name, key, _gap(name, got, ref))
    for name, m in resumed["moments"].items():
        assert float(m["step"]) == float(uninterrupted["moments"][name]["step"]) == 2
    assert _bn_gap(resumed["bn"], uninterrupted["bn"]) <= RESUME_TOL
    diffs = torch.cat([(resumed["model"][k] - uninterrupted["model"][k]).abs().flatten()
                       for k in uninterrupted["moments"]])
    assert float(diffs.max()) <= 2.01 * LR
    assert float((diffs <= RESUME_TOL * LR).float().mean()) >= 0.999


def test_checkpoint_written_at_world2_holds_the_world1_format(world):
    """(d) What rank 0 wrote is what a one-device run writes: the same keys,
    the moments of every trainable parameter under the unsharded indices,
    the unsharded optimizer's param group."""
    blob = torch.load(f"{world['workdir']}/ck_step1/state.pt", weights_only=True)
    cfg, _, state = worker._state(world["inputs"]["shifted"], world["inputs"]["adamw"][False])
    plain = state.optimizer.state_dict()
    assert set(blob) == {"step", "steps_taken", "model", "optimizer", "ema"}
    assert blob["step"] == blob["steps_taken"] == 1
    groups = blob["optimizer"]["param_groups"]
    assert len(groups) == 1 and groups[0].keys() == plain["param_groups"][0].keys()
    assert groups[0]["params"] == plain["param_groups"][0]["params"]
    assert sorted(blob["optimizer"]["state"]) == groups[0]["params"]
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    for i, p in enumerate(params):
        assert blob["optimizer"]["state"][i]["exp_avg"].shape == p.shape


def test_nan_on_one_rank_skips_the_step_on_both(world):
    """(e) Rank 1's images NaN: both ranks report the skip and keep their
    parameters, statistics, moments and step counter (bit for bit, by
    digest); steps taken +1. The state before is the step-1 checkpoint
    restored at world 2, equal to the state that wrote it."""
    for out in world["outs"]:
        nan = out["nan"]
        assert nan["skipped"] == 1.0 and nan["loaded_equal_step1"]
        before, after = nan["before"], nan["after"]
        assert before["digest"] == after["digest"] and before["digest"]["moments"]
        assert after["step"] == before["step"] == 1
        assert after["steps_taken"] == before["steps_taken"] + 1


def test_app_at_world2_agrees_on_sigterm_and_writes_on_rank0(world):
    """`apps.train --multihost` at world 2 (batch 1 a rank, 4 synthetic
    samples: 2 steps an epoch at the global batch of 2), SIGTERM to rank 1
    alone in step 3: both ranks save `preempt` after step 3 and stop; the
    epoch-1 eval ran on rank 0 alone; rank 0 alone wrote the metrics, one
    record a step; the checkpoints are the one-device format."""
    import json

    codes = _app_codes(world)
    assert None not in codes, f"a rank still ran {APP_TIMEOUT} s after the fixture: {codes}"
    app = f"{world['workdir']}/app"
    ck = f"{app}/sigterm/ck"
    apps = [torch.load(f"{app}/app_r{r}.pt") for r in range(2)]
    for run in apps:
        assert run["final_step"] == run["steps_taken"] == 3, run
        assert run["checkpoint"].endswith("preempt") and run["logged"] == [1, 2, 3]
    assert [run["evals"] for run in apps] == [1, 0]
    assert os.path.exists(f"{ck}/preempt/state.pt") and os.path.exists(f"{ck}/epoch_1/state.pt")
    assert not os.path.exists(f"{ck}/final")
    with open(f"{ck}/metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records if "train/total" in r] == [1, 2, 3]
    assert [r["step"] for r in records if "eval/mpjpe_mm" in r] == [2]
    blob = torch.load(f"{ck}/preempt/state.pt", weights_only=True)
    assert blob["step"] == 3 and len(blob["optimizer"]["param_groups"]) == 1


def test_a_failing_rank_ends_every_rank(world):
    """(f) `apps.train --multihost` at world 2 with the loss raising on
    rank 1 at its second step (after the SIGTERM run, in the same world):
    both processes end, with non-zero exits, within the timeout, rank 1 on
    the planted error and rank 0 in the collective rank 1 left (a per-rank
    retry or a crash checkpoint would leave rank 0 inside it)."""
    codes = _app_codes(world)
    assert None not in codes, f"a rank still ran {APP_TIMEOUT} s after the fixture: {codes}"
    assert all(c != 0 for c in codes), codes
    app = f"{world['workdir']}/app"
    errors = []
    for r in range(2):
        with open(f"{app}/failing_r{r}.txt") as f:
            errors.append(f.read())
    assert "planted failure on rank 1" in errors[1]
    assert "planted failure" not in errors[0]
    assert not os.path.exists(f"{app}/failing/ck/crash")


def test_a_step_of_a_rank_among_several_is_not_retried():
    """What `apps.train` asks of `run_step_guarded` at world > 1
    (`retries=0, crash_checkpoint=False`): a transient failure re-raises at
    once, with no wait and no checkpoint; the defaults retry it and save."""
    from renderih_tpu_torch.train import resilience

    calls, saved, slept = [], [], []

    def oom():
        calls.append(1)
        raise torch.cuda.OutOfMemoryError("planted")

    with pytest.raises(torch.cuda.OutOfMemoryError):
        resilience.run_step_guarded(oom, "S", "/nonexistent", retries=0,
                                    crash_checkpoint=False, save_fn=lambda *a: saved.append(a),
                                    sleep=slept.append)
    assert (calls, saved, slept) == ([1], [], [])
    with pytest.raises(torch.cuda.OutOfMemoryError):
        resilience.run_step_guarded(oom, "S", "/nonexistent", retries=1,
                                    save_fn=lambda *a: saved.append(a), sleep=slept.append)
    assert len(calls) == 3 and len(slept) == 1 and len(saved) == 1
