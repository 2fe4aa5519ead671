"""`utils/branches.py` on the CPU: one SGD step of the small config (f32,
dropout 0, batch 4) from `init_model`'s weights, its ReLU and max-pool
branches recorded at one thread and taken at four. Two thread counts round
differently, as the card and the CPU do; without shared branches their
gradients can part by more than a planted fault moves them (`chip_smoke.py`
phase 9 prints both on the card). With them, the card-vs-CPU limits of `chip_smoke.py`'s phase 9 and
`tests/test_torch_cuda.py` (every tensor within 2e-2 of its scale, 95%
within 3e-3) hold at every draw tried, and the planted fault (the 2-D
term's weight 10% off: worst ~0.10, ~4% within 3e-3) lies outside them.
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

from renderih_tpu_torch.assets import make_synthetic_assets
from renderih_tpu_torch.config import load_config
from renderih_tpu_torch.data.synthetic import synthetic_batch
from renderih_tpu_torch.models import init_model, model_call_kwargs
from renderih_tpu_torch.train.state import create_train_state
from renderih_tpu_torch.train.trainer import make_train_step
from renderih_tpu_torch.utils.branches import gradient_gaps, record_branches, take_branches

WORST, TIER, SHARE = 2e-2, 3e-3, 0.95  # chip_smoke.GRAD_TOL
CFG = {"model": {"encoder": "resnet18", "img_size": 128, "grid_size": 4,
                 "graph_layer_num": 2, "dropout": 0.0},
       "train": {"precision": "f32", "optimizer": "sgd", "lr": 1.0, "warmup_epochs": 0}}


@pytest.fixture(scope="module")
def setup():
    prev = torch.get_num_threads()
    yield dict(cfg=load_config(overrides=CFG), assets=make_synthetic_assets(0))
    torch.set_num_threads(prev)


def _step(setup, seeds, threads, context, cfg=None):
    """(terms, gradients, what `context` yields) of one SGD step at
    `threads` threads inside `context`, from init seed seeds[0] on the
    batch of seed seeds[1]."""
    cfg, assets = cfg or setup["cfg"], setup["assets"]
    torch.set_num_threads(threads)
    with torch.no_grad():
        batch = synthetic_batch(assets, torch.Generator().manual_seed(seeds[1]), 4, 128)
    model = init_model(cfg, assets, torch.Generator().manual_seed(seeds[0]))
    with context as got:
        terms = make_train_step(cfg, assets, 10, "cpu")(create_train_state(cfg, model, 10), batch)
    return ({k: float(v) for k, v in terms.items()},
            {k: p.grad for k, p in model.named_parameters() if p.grad is not None}, got)


def _within_limits(gaps: dict) -> bool:
    return max(gaps.values()) <= WORST and np.mean([e <= TIER for e in gaps.values()]) >= SHARE


@pytest.fixture(scope="module")
def recorded(setup):
    terms, grads, taken = _step(setup, (0, 0), 1, record_branches())
    return dict(taken=taken, terms=terms, grads=grads)


def test_recording_leaves_the_step_as_it_was(setup, recorded):
    """Recording wraps F.relu and F.max_pool2d and changes nothing."""
    terms, grads, _ = _step(setup, (0, 0), 1, contextlib.nullcontext())
    assert terms == recorded["terms"]
    assert all(torch.equal(recorded["grads"][k], g) for k, g in grads.items())


def test_taking_its_own_branches_reproduces_the_step(setup, recorded):
    """At the same thread count the taken branches give the recorded
    step's terms, and its gradients within float32 rounding (a max-pool's
    gradient is summed by a gather's backward)."""
    assert {kind for kind, _ in recorded["taken"]} == {"relu", "max_pool2d"}
    terms, grads, _ = _step(setup, (0, 0), 1, take_branches(recorded["taken"]))
    assert terms == pytest.approx(recorded["terms"], rel=1e-6)
    assert max(gradient_gaps(grads, recorded["grads"]).values()) <= 1e-5


@pytest.mark.parametrize("seeds", [(2, 5), (4, 9)])
def test_shared_branches_hold_two_thread_counts_within_the_card_limits(setup, seeds):
    _, ref, taken = _step(setup, seeds, 1, record_branches())
    _, got, _ = _step(setup, seeds, 4, take_branches(taken))
    gaps = gradient_gaps(got, ref)
    assert _within_limits(gaps), (max(gaps, key=gaps.get), max(gaps.values()))


def test_the_limits_see_a_planted_fault(setup, recorded):
    """The 2-D term's weight 10% off, on the recorded branches."""
    fault = copy.deepcopy(setup["cfg"])
    fault.loss.label_2d *= 1.1
    _, grads, _ = _step(setup, (0, 0), 4, take_branches(recorded["taken"]), cfg=fault)
    gaps = gradient_gaps(grads, recorded["grads"])
    assert max(gaps.values()) > 5 * WORST
    assert not _within_limits(gaps)


def test_take_branches_refuses_another_run(setup, recorded):
    """A run whose calls differ from the record's (another batch size)
    raises; so does one that makes fewer calls."""
    model = init_model(setup["cfg"], setup["assets"], torch.Generator().manual_seed(0))
    kw = model_call_kwargs(setup["assets"], "cpu")
    with pytest.raises(RuntimeError, match="take_branches"), torch.no_grad():
        with take_branches(recorded["taken"]):
            model(torch.zeros(1, 128, 128, 3), **kw)
    with pytest.raises(RuntimeError, match="fewer calls"):
        with take_branches(recorded["taken"]):
            pass
