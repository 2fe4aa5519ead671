"""One train step of the from-scratch recipe's variants against
`renderih_tpu.train.trainer.make_train_step(mesh=None)` on the CPU: a
config with both the aux heads (`with_aux_heads`) and the MANO-parameter
decoder (`decoder="mano"`), resnet18 at 128², grid 4, f32, dropout 0,
batch 4, SGD at lr 1e3 (so that (p0 − p1)/lr recovers JAX's gradient),
every graph-loss term on. Two batch layouts, one compiled JAX step each:
  * "device_hms": no stored aux targets, so both steps make the heatmap
    target from the augmented 2-D joints on the device (term aux_hms);
  * "stored_aux": `synthetic_batch(with_aux=True)`'s rendered targets
    (aux_hms, aux_mask, aux_dense, the dense term gated per hand).
Both carry MANO pose and shape labels (terms mano_pose, mano_shape,
mano_shape_reg).

Held: the loss terms within 1e-4 relative, the aux heads' BatchNorm
statistics within 1e-5 of each buffer's largest value, and the gradients under the
limits of tests/test_torch_train.py (every tensor within
1.5e-3·max|g_ref| + 1e-7, 80% of the tensors within 1e-4·max|g_ref| +
1e-7), which a dropped aux_hms term breaks.

The gradients are compared where the two float32 implementations take the
same branches (tests/test_torch_train.py says why they part otherwise):
  * the trunk and decoder, as there: the encoder's BatchNorm biases raised
    by 3, on an image whose every ReLU input there is >= 8e-6 from 0 and
    every max-pool top two >= 2e-6 apart (a test below checks it, and that
    the MANO head's hard-swish inputs are far from ±3);
  * the aux heads have 2.8M ReLU inputs, conv outputs with no bias before
    them; no image keeps them all clear of rounding from 0. So JAX's step
    takes the port's branches there: each ReLU in a
    JAX `AuxDecoderHead` multiplies by the mask the port's step recorded
    while the same head ran (`utils/branches.py`; forward hooks on the
    port's heads mark their spans), through a stand-in for `flax.linen` in the
    JAX module's namespace for the test's trace; the JAX package is
    unchanged. (The heads' backward on their own branches, unshared, is
    held in float64 by tests/test_torch_aux_heads.py);
  * the raised biases lift the heads' input (the C5 map) to a mean of
    about 4. Each head's first 1x1 conv then gives channels far from 0,
    many nearly dead after its ReLU, and the BatchNorm after it amplifies
    a change of C5 in that conv's gradient: a relative 1e-6 moves it by
    1.5e-4 of its scale in float64 (a test below), so the rounding by
    which JAX's C5 differs from the port's parted that gradient by more
    than the limit. The test centres each of those convs' rows over their
    inputs, which removes C5's common offset, as a normal init has it
    (the same change then moves it 2.0e-5).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax.linen import module as flax_module

from renderih_tpu.assets import make_synthetic_assets as jax_assets
from renderih_tpu.config import load_config as jax_load_config
from renderih_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from renderih_tpu.models import build_model as jax_build_model
from renderih_tpu.models import model_call_kwargs as jax_call_kwargs
from renderih_tpu.models import resnet as jax_resnet
from renderih_tpu.train.state import create_train_state as jax_create_train_state
from renderih_tpu.train.trainer import make_train_step as jax_make_train_step
from renderih_tpu_torch.assets import make_synthetic_assets
from renderih_tpu_torch.config import load_config
from renderih_tpu_torch.models import build_model, model_call_kwargs
from renderih_tpu_torch.train.state import create_train_state
from renderih_tpu_torch.train.trainer import make_train_step
from renderih_tpu_torch.utils.branches import record_branches
from renderih_tpu_torch.utils.weights import state_dict_from_jax

B, SPE, SIZE, LR = 4, 10, 128, 1e3
CFG = {
    "model": {"encoder": "resnet18", "img_size": SIZE, "grid_size": 4,
              "gcn_in_dims": [64, 32, 16], "gcn_out_dims": [32, 16, 8],
              "img_dims": [32, 16, 8], "deconv_dims": [32, 32, 32, 32],
              "graph_layer_num": 2, "dropout": 0.0, "with_aux_heads": True,
              "decoder": "mano"},
    "train": {"precision": "f32", "batch_size": B, "warmup_epochs": 0, "optimizer": "sgd",
              "lr": LR},
    "loss": {"norm_epoch": 0, "camera": 1.0},
}
LAYOUTS = ("device_hms", "stored_aux")
BN_BIAS, IMG_SEED = 3.0, 52  # as tests/test_torch_train.py (GRAD_IMG_SEED[1])
RELU_MARGIN, POOL_MARGIN, HARDSWISH_MARGIN = 8e-6, 2e-6, 1e-3
HEADS = ("hms_head", "dp_head")
BN_BUFFERS = (".running_mean", ".running_var")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _shift_bn_bias(tree: dict, shift: float) -> dict:
    return {k: (dict(v, bias=v["bias"] + shift) if k.startswith(("bn", "downsample_bn"))
                else _shift_bn_bias(v, shift) if isinstance(v, dict) else v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def init():
    """JAX's init at the config, random BatchNorm statistics, the encoder's
    BatchNorm biases raised and the heads' first convs centred (module
    docstring), and the two batches."""
    jcfg = jax_load_config(overrides=CFG)
    jassets = jax_assets(0)
    jmodel = jax_build_model(jcfg, jassets)
    variables = jax.jit(lambda key: jmodel.init(  # init_model's draw, compiled
        key, jnp.zeros((1, SIZE, SIZE, 3)), train=False,
        **jax_call_kwargs(jcfg, jassets)))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 1.5, a.shape) if path[-1].key == "var"
                         else rng.normal(0.0, 0.1, a.shape)).astype(np.float32),
        variables["batch_stats"])
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    params["encoder"] = _shift_bn_bias(params["encoder"], BN_BIAS)
    raw_heads = {head: params[head] for head in HEADS}
    for head in HEADS:
        k = params[head]["flat_conv"]["kernel"]  # (1, 1, in, out)
        params[head] = dict(params[head],
                            flat_conv={"kernel": k - k.mean(axis=2, keepdims=True)})
    labels = np.random.default_rng(5)
    mano = {f"pose_{h}": (labels.normal(size=(B, 48)) * 0.3).astype(np.float32)
            for h in ("left", "right")}
    mano.update({f"shape_{h}": labels.normal(size=(B, 10)).astype(np.float32)
                 for h in ("left", "right")})
    img = np.random.default_rng(IMG_SEED).normal(size=(B, SIZE, SIZE, 3)).astype(np.float32)
    batches = {
        layout: dict({k: np.asarray(v) for k, v in jax_synthetic_batch(
            jassets, jax.random.PRNGKey(1), batch_size=B, img_size=SIZE,
            with_aux=layout == "stored_aux").items()}, **mano, img=img)
        for layout in LAYOUTS}
    return dict(jcfg=jcfg, jmodel=jmodel, jassets=jassets, params=params, stats=stats,
                raw_heads=raw_heads, batches=batches, assets=make_synthetic_assets(0))


def _port_step(init, batch: dict, loss: dict | None = None):
    """The port's step on the init and `batch`, its branches recorded:
    (state, terms, {head: the ReLU masks recorded while that head ran})."""
    cfg = load_config(overrides={**CFG, "loss": {**CFG["loss"], **(loss or {})}})
    model = build_model(cfg, init["assets"])
    model.load_state_dict(state_dict_from_jax(init["params"], init["stats"]))
    state = create_train_state(cfg, model, SPE)
    spans = {}
    with record_branches() as taken:
        for head in HEADS:  # where in `taken` each head's forward began and ended
            mod = getattr(model, head)
            mod.register_forward_pre_hook(
                lambda m, a, head=head: spans.__setitem__(head, len(taken)))
            mod.register_forward_hook(
                lambda m, a, o, head=head: spans.__setitem__(head, (spans[head], len(taken))))
        terms = make_train_step(cfg, init["assets"], SPE, "cpu")(
            state, {k: torch.tensor(v) for k, v in batch.items()})
    head_relus = {head: [m for kind, m in taken[start:end] if kind == "relu"]
                  for head, (start, end) in spans.items()}
    return state, {k: float(v) for k, v in terms.items()}, head_relus


class _HeadBranches:
    """`flax.linen` as `renderih_tpu/models/resnet.py` sees it, but a ReLU
    inside an `AuxDecoderHead` multiplies by the port's mask for that head
    and map size."""

    def __init__(self, masks: dict):
        self.masks = masks

    def __getattr__(self, name):
        return getattr(fnn, name)

    def relu(self, x):
        mod = flax_module._context.module_stack[-1]
        if isinstance(mod, jax_resnet.AuxDecoderHead):
            return x * self.masks[(mod.name, x.shape[1])]
        return fnn.relu(x)


def _head_masks(head_relus: dict) -> dict:
    """The port's aux-head ReLU masks, NHWC, by (head, map size): the four
    ReLUs each head's forward ran, found by forward hooks on the head."""
    masks = {}
    for head, relus in head_relus.items():
        assert len(relus) == 4, (head, len(relus))
        for m in relus:
            assert m.shape[:2] == (B, 256), m.shape
            masks[(head, m.shape[2])] = jnp.asarray(
                m.permute(0, 2, 3, 1).numpy().astype(np.float32))
    assert len(masks) == 8
    return masks


def _steps(init, layout: str) -> dict:
    """One port step and one JAX step (its heads on the port's branches) on
    the layout's batch."""
    batch = init["batches"][layout]
    state, terms, head_relus = _port_step(init, batch)
    jcfg = init["jcfg"]
    state0 = jax_create_train_state(
        jcfg, {"params": init["params"], "batch_stats": init["stats"]}, SPE)
    jstep, _ = jax_make_train_step(jcfg, init["jmodel"], init["jassets"], SPE,
                                   params_template=init["params"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_resnet, "nn", _HeadBranches(_head_masks(head_relus)))
        state1, jterms = jstep(state0, {k: jnp.asarray(v) for k, v in batch.items()},
                               jax.random.PRNGKey(2))
    want = lambda tree: {k: v.numpy() for k, v in state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, tree.params),
        jax.tree_util.tree_map(np.asarray, tree.batch_stats)).items()}
    return dict(layout=layout, state=state, terms=terms,
                jterms={k: float(v) for k, v in jterms.items()},
                p0=state_dict_from_jax(init["params"], init["stats"]), p1=want(state1))


@pytest.fixture(scope="module")
def steps(init):
    return {layout: _steps(init, layout) for layout in LAYOUTS}


def _check_grads(state, p0: dict, p1: dict):
    """The port's `.grad` against JAX's (p0 − p1)/lr (tests/test_torch_train.py's
    limits; a key projection's bias against its weight's scale too)."""
    rel = {}
    for name, p in state.model.named_parameters():
        g_ref = (p0[name].numpy() - p1[name]) / LR
        if not p.requires_grad:
            assert name == "decoder.unsample_layer.weight" and not g_ref.any()
            continue
        err = np.abs(p.grad.numpy() - g_ref).max()
        scale = np.abs(g_ref).max()
        if name.endswith("w_ks.bias"):
            w = name[:-len("bias")] + "weight"
            scale = max(scale, np.abs((p0[w].numpy() - p1[w]) / LR).max())
        assert err <= 1.5e-3 * scale + 1e-7, (name, err, scale)
        rel[name] = err <= 1e-4 * scale + 1e-7
    assert np.mean(list(rel.values())) >= 0.8


@pytest.mark.parametrize("layout", LAYOUTS)
def test_recipe_step_loss_terms_match_jax(steps, layout):
    step = steps[layout]
    aux = {"aux_hms"} | ({"aux_mask", "aux_dense"} if step["layout"] == "stored_aux" else set())
    mano = {"mano_pose", "mano_shape", "mano_shape_reg"}
    got, want = step["terms"], step["jterms"]
    assert set(got) == set(want) and aux | mano <= set(got)
    assert not ({"aux_mask", "aux_dense"} - aux) & set(got)
    assert want["skipped_nonfinite"] == 0.0
    for k, ref in want.items():
        assert abs(got[k] - ref) <= 1e-4 * abs(ref) + 1e-7, (k, got[k], ref)
    assert all(got[k] > 0 for k in aux | mano)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_recipe_step_gradients_match_jax(steps, layout):
    step = steps[layout]
    _check_grads(step["state"], step["p0"], step["p1"])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_recipe_step_head_bn_stats_match_jax(steps, layout):
    """The aux heads' BatchNorm statistics after the step. (The trunk's are
    held by tests/test_torch_train.py from an init without raised biases:
    here they lift the trunk's BatchNorm inputs to means far above their
    spread, where JAX's one-pass variance, E[x²] − E[x]², loses digits.)"""
    got = steps[layout]["state"].model.state_dict()
    n = 0
    for k, ref in steps[layout]["p1"].items():
        if k.startswith(HEADS) and k.endswith(BN_BUFFERS):
            err = np.abs(got[k].numpy() - ref).max() / np.abs(ref).max()
            assert err <= 1e-5, (k, err)
            n += 1
    assert n == 2 * 4 * 2


def test_gradient_check_fails_on_a_dropped_aux_hms_term(init, steps):
    step = steps["device_hms"]
    state, terms, _ = _port_step(init, init["batches"]["device_hms"], loss={"hms": 0.0})
    assert terms["aux_hms"] == pytest.approx(step["terms"]["aux_hms"], rel=1e-6)
    with pytest.raises(AssertionError):
        _check_grads(state, step["p0"], step["p1"])


def test_recipe_batch_keeps_trunk_and_decoder_branches_off_their_kinks(init, monkeypatch):
    """The premise of the gradient test (module docstring): in the port's
    forward of the batch, outside the aux heads (whose branches are
    shared), every ReLU input is >= RELU_MARGIN from 0, every max-pool
    window's top two >= POOL_MARGIN apart (windows all 0 aside), and every
    hard-swish input >= HARDSWISH_MARGIN from ±3."""
    relu_gap, pool_gap, hs_gap = [], [], []
    relu, max_pool2d, hardswish = F.relu, F.max_pool2d, F.hardswish
    in_head = []

    def traced_relu(x, inplace=False):
        if not in_head:
            relu_gap.append(float(x.detach().abs().min()))
        return relu(x, inplace=inplace)

    def traced_pool(x, kernel_size, stride=None, padding=0, *args, **kwargs):
        xp = F.pad(x.detach(), (padding,) * 4, value=float("-inf"))
        top = F.unfold(xp.flatten(0, 1)[:, None], kernel_size, stride=stride).topk(2, dim=1)
        live = top.values[:, 0] > 0
        pool_gap.append(float((top.values[:, 0] - top.values[:, 1])[live].min()))
        return max_pool2d(x, kernel_size, stride, padding, *args, **kwargs)

    def traced_hardswish(x, inplace=False):
        hs_gap.append(float(((x.detach().abs() - 3.0).abs()).min()))
        return hardswish(x, inplace=inplace)

    monkeypatch.setattr(F, "relu", traced_relu)
    monkeypatch.setattr(F, "max_pool2d", traced_pool)
    monkeypatch.setattr(F, "hardswish", traced_hardswish)
    cfg = load_config(overrides=CFG)
    model = build_model(cfg, init["assets"]).train()
    model.load_state_dict(state_dict_from_jax(init["params"], init["stats"]))
    for head in HEADS:
        getattr(model, head).register_forward_pre_hook(lambda *a: in_head.append(1))
        getattr(model, head).register_forward_hook(lambda *a: in_head.clear())
    with torch.no_grad():
        model(torch.from_numpy(init["batches"]["device_hms"]["img"]), aux=True,
              **model_call_kwargs(init["assets"], "cpu"))
    assert relu_gap and pool_gap and len(hs_gap) == 2 * 4
    assert min(relu_gap) >= RELU_MARGIN and min(pool_gap) >= POOL_MARGIN, (
        min(relu_gap), min(pool_gap))
    assert min(hs_gap) >= HARDSWISH_MARGIN, min(hs_gap)


def test_recipe_branches_run_under_grad_accum(init):
    """grad_accum=2 on a batch of two equal halves is the step on one half
    (the second micro-batch sees the same batch statistics): the aux and
    MANO terms, averaged over the micro-batches, and the gradients."""
    half = {k: v[:B // 2] for k, v in init["batches"]["stored_aux"].items()}
    twice = {k: np.concatenate([v, v]) for k, v in half.items()}
    runs = {}
    for accum, batch in ((1, half), (2, twice)):
        cfg = load_config(overrides={**CFG, "train": {**CFG["train"], "grad_accum": accum,
                                                      "batch_size": len(batch["img"])}})
        model = build_model(cfg, init["assets"])
        model.load_state_dict(state_dict_from_jax(init["params"], init["stats"]))
        state = create_train_state(cfg, model, SPE)
        terms = make_train_step(cfg, init["assets"], SPE, "cpu")(
            state, {k: torch.tensor(v) for k, v in batch.items()})
        runs[accum] = (terms, {k: p.grad for k, p in model.named_parameters()
                               if p.grad is not None})
    (t1, g1), (t2, g2) = runs[1], runs[2]
    assert {"aux_hms", "aux_mask", "aux_dense", "mano_pose"} <= set(t2)
    for k, v in t1.items():
        torch.testing.assert_close(t2[k], v, rtol=1e-6, atol=0, msg=k)
    for k, g in g1.items():
        torch.testing.assert_close(g2[k], g, rtol=1e-5, atol=1e-6 * float(g.abs().max()),
                                   msg=k)


def test_app_trains_the_recipe_and_checkpoints_the_new_heads(tmp_path):
    """`apps.train` on the CPU, the small config with the levers of
    configs/convergence_r5d.yaml (aux heads, zero-init heads, normal from
    epoch 16, camera 10, theta ±30) and the MANO decoder, EMA on: every
    aux_/mano_ term logged, finite, in metrics.jsonl; the new parameters
    trained (in the optimizer with weight decay, in the EMA; the heatmap
    head and the regressor moved, the mask/densepose head, which no target
    of this split reaches, decayed) and saved, and a checkpoint restores
    them."""
    from renderih_tpu_torch.apps import train as train_app
    from renderih_tpu_torch.config import dump_config
    from renderih_tpu_torch.train.state import restore_checkpoint

    over = {"model": {**CFG["model"], "zero_init_heads": True},
            "loss": {"normal_epoch": 16, "camera": 10.0},
            "data": {"theta_range": [-30.0, 30.0]},
            "train": {"precision": "f32", "batch_size": 2, "warmup_epochs": 0, "lr": 1e-3,
                      "ema_decay": 0.9, "log_every": 1, "seed": 0,
                      "checkpoint_dir": str(tmp_path / "run")}}
    cfg = load_config(overrides=over)
    dump_config(cfg, str(tmp_path / "recipe.yaml"))
    out = train_app.main(["--cfg", str(tmp_path / "recipe.yaml"), "--synthetic", "--synth_n",
                          "8", "--steps", "2", "--device", "cpu"])
    new_terms = {"aux_hms", "mano_pose", "mano_shape", "mano_shape_reg"}
    for _, terms in out["logged"]:
        assert new_terms <= set(terms) and np.isfinite(list(terms.values())).all()
        assert terms["aux_hms"] > 0 and terms["skipped_nonfinite"] == 0
    logged = (tmp_path / "run" / "metrics.jsonl").read_text()
    assert all(f'"train/{k}"' in logged for k in new_terms)

    blob = torch.load(tmp_path / "run" / "final" / "state.pt", weights_only=True)
    model = build_model(cfg, make_synthetic_assets(0))
    state = create_train_state(cfg, model, 4)
    new = [k for k, _ in model.named_parameters()
           if k.startswith(HEADS + ("decoder.param_regressor.",))]
    assert len(new) == 2 * 14 + 12 and set(new) <= set(blob["ema"])
    group = state.optimizer.param_groups[0]
    assert group["weight_decay"] == cfg.train.weight_decay > 0
    named = dict(model.named_parameters())
    assert all(any(named[k] is p for p in group["params"]) for k in new)
    restore_checkpoint(str(tmp_path / "run" / "final"), state)
    first = init_model_state(cfg)
    for k in new:
        torch.testing.assert_close(named[k].detach(), blob["model"][k], rtol=0, atol=0)
        if k.startswith(("hms_head.", "decoder.param_regressor.")) or first[k].any():
            assert not torch.equal(blob["model"][k], first[k]), k
    assert len(blob["optimizer"]["state"]) == len(group["params"])


def init_model_state(cfg) -> dict:
    from renderih_tpu_torch.models import init_model

    return init_model(cfg, make_synthetic_assets(0),
                      torch.Generator().manual_seed(cfg.train.seed)).state_dict()


def test_centring_the_heads_first_conv_removes_its_ill_conditioning(init):
    """Why the test centres the heads' first conv (module docstring): on
    the C5 map of the port's forward from the raised biases, the
    mask/densepose head's float64 `flat_conv` gradient (its aux terms, on
    the stored targets) moves, under a relative change of 1e-6 in C5, by
    more than 1e-4 of its scale with the conv as drawn (measured 1.5e-4)
    and by less than a fifth of that once centred (2.0e-5); the branches
    are shared between the two inputs."""
    from renderih_tpu_torch.losses.graph_loss import aux_losses
    from renderih_tpu_torch.models.resnet import AuxDecoderHead
    from renderih_tpu_torch.utils import weights
    from renderih_tpu_torch.utils.branches import take_branches

    batch = init["batches"]["stored_aux"]
    cfg = load_config(overrides=CFG)
    model = build_model(cfg, init["assets"]).train()
    model.load_state_dict(state_dict_from_jax(init["params"], init["stats"]))
    c5 = []
    model.encoder.register_forward_hook(lambda m, a, out: c5.append(out[0].detach()))
    with torch.no_grad():
        model(torch.from_numpy(batch["img"]), **model_call_kwargs(init["assets"], "cpu"))
    x = c5[0].double()
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(0), dtype=x.dtype)
    targets = {k: torch.from_numpy(batch[k]).double()
               for k in ("mask", "dense", "mask_left", "mask_right")}

    def moved(head_params) -> float:
        sd = {}
        weights._aux_head(head_params, init["stats"]["dp_head"], "h", sd)
        head = AuxDecoderHead(x.shape[1], 7).double().train()
        head.load_state_dict({k.removeprefix("h."): v for k, v in sd.items()})
        grads, taken = [], None
        for inp in (x, x * (1 + 1e-6 * noise)):
            head.zero_grad()
            with record_branches() if taken is None else take_branches(taken) as rec:
                out = head(inp).permute(0, 2, 3, 1)
            aux_losses({"mask": out[..., 0], "dense": out[..., 1:]}, targets)["total"].backward()
            taken = rec if taken is None else taken
            grads.append(head.flat_conv.weight.grad.clone())
        return float((grads[1] - grads[0]).abs().max() / grads[0].abs().max())

    drawn = moved(init["raw_heads"]["dp_head"])
    centred = moved(init["params"]["dp_head"])
    assert drawn > 1e-4 and centred < 0.2 * drawn, (drawn, centred)
