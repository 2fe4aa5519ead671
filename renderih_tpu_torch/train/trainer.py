"""The train and eval steps on one device (counterpart of
`renderih_tpu/train/trainer.py`, `make_train_step(mesh=None)`).

One step is the epoch loop body of `train_gcn`
(`core/lijun_trainer.py:233-341`): forward in train mode, the graph loss,
backward, the optimizer update. As in the JAX package:
  * with `model.with_aux_heads` the aux heads run and `aux_losses` joins
    the total (terms `aux_*`); a batch without 'hms' gets its heatmap
    target made on the device from its augmented 2-D joints, at the
    heads' output size S with sigma max(S/32, 1). Without ImageNet weights
    this supervision is what lets the encoder train from scratch
    (`renderih_tpu/train/trainer.py:114-125`);
  * with `decoder="mano"` and a batch that carries 'pose_left', the
    MANO-parameter losses join it (terms `mano_*`);
  * `epoch = step // steps_per_epoch` feeds the loss gates;
  * `grad_accum` splits the batch into sequential micro-batches, each
    gradient scaled by 1/accum, BatchNorm statistics chained through them,
    one update;
  * the NaN/Inf guard: a non-finite loss or gradient skips the update and
    leaves the parameters, optimizer, step counter, EMA and BatchNorm
    statistics as they were, reporting `skipped_nonfinite = 1`. Torch
    updates the BatchNorm statistics inside the forward, so the step
    snapshots them first and restores them on a skip (JAX drops the
    mutated copy instead). The check is one host sync a step;
  * the learning rate comes from the schedule at the number of updates
    applied; the EMA follows applied updates only; `state.steps_taken`
    counts every step, applied or skipped. A failure inside the
    update raises `UpdateFailed`, which the step guard does not retry.
`make_augmented_step` puts the on-device gather's batch through
`device_augment` and the step, drawing both from one generator seeded per
step (the counterpart of `make_fused_cached_step`).
"""

from __future__ import annotations

import numpy as np
import torch

from renderih_tpu_torch.assets import Assets, assets_to
from renderih_tpu_torch.config import Config
from renderih_tpu_torch.data.pipeline import device_augment
from renderih_tpu_torch.losses.graph_loss import (
    GraphLossWeights,
    aux_losses,
    two_hand_graph_loss,
)
from renderih_tpu_torch.losses.mano_loss import mano_param_losses
from renderih_tpu_torch.models.model import model_call_kwargs
from renderih_tpu_torch.ops.dropout import dropout_generator
from renderih_tpu_torch.ops.heatmap import joint_heatmap_targets
from renderih_tpu_torch.train.resilience import UpdateFailed
from renderih_tpu_torch.train.state import TrainState, trainable_parameters


def loss_weights_from_cfg(cfg: Config) -> GraphLossWeights:
    loss = cfg.loss
    return GraphLossWeights(label_3d=loss.label_3d, label_2d=loss.label_2d,
                            normal=loss.normal, edge=loss.edge,
                            norm_epoch=loss.norm_epoch, normal_epoch=loss.normal_epoch,
                            camera=loss.camera, upsample=loss.upsample)


def _bn_buffers(model: torch.nn.Module) -> list:
    return [buf for name, buf in model.named_buffers()
            if name.endswith(("running_mean", "running_var"))]


def make_train_step(cfg: Config, assets: Assets, steps_per_epoch: int,
                    device: torch.device | str):
    """`step(state, batch, generator=None) -> terms`: one update of `state`
    (in place) on `batch` (augmented tensors on `device`); dropout draws
    from `generator`. `terms` are the loss terms, 0-d tensors on the
    device, with `skipped_nonfinite`. After the step each trainable
    parameter's `.grad` holds the gradient it was given. With
    `train.nan_guard` off every update is applied, with no host sync and
    no `skipped_nonfinite`."""
    device = torch.device(device)
    call_kwargs = model_call_kwargs(assets, device)
    loss_assets = assets_to(assets, device)
    weights = loss_weights_from_cfg(cfg)
    accum = max(1, int(cfg.train.grad_accum))
    img_size = cfg.model.img_size
    ema_decay = cfg.train.ema_decay
    nan_guard = cfg.train.nan_guard
    one = torch.ones(1, device=device)
    with_aux = cfg.model.with_aux_heads
    with_mano = cfg.model.decoder == "mano"
    loss = cfg.loss

    def loss_and_backward(model, batch, epoch, scale):
        out = model(batch["img"], aux=with_aux, **call_kwargs)
        total, terms = two_hand_graph_loss(
            out, batch, loss_assets, epoch, weights,
            upsample_weight=model.decoder.unsample_layer.weight, img_size=img_size)
        if with_aux:
            if "hms" not in batch:
                batch = {**batch, "hms": joint_heatmap_targets(
                    batch["j2d_left"], batch["j2d_right"], out.aux["hms"].shape[1], img_size)}
            at = aux_losses(out.aux, batch, w_mask=loss.mask, w_dense=loss.dense,
                            w_hms=loss.hms)
            total = total + at.pop("total")
            terms.update({f"aux_{k}": v for k, v in at.items()})
        if with_mano and "pose_left" in batch:
            mt = mano_param_losses(out, batch)
            total = total + (loss.mano_pose * mt["pose"] + loss.mano_shape * mt["shape"]
                             + mt["shape_reg"])
            terms.update({f"mano_{k}": v for k, v in mt.items()})
        terms["total"] = total
        (total if scale == 1.0 else total * scale).backward()
        return {k: v.detach() for k, v in terms.items()}

    def apply_update(state: TrainState, model: torch.nn.Module):
        lr = state.schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        if state.ema is not None:
            named = dict(model.named_parameters())
            ema = list(state.ema.values())
            torch._foreach_mul_(ema, ema_decay)
            torch._foreach_add_(ema, [named[k].detach() for k in state.ema],
                                alpha=1.0 - ema_decay)

    def step(state: TrainState, batch: dict, generator: torch.Generator | None = None):
        model = state.model.train()
        params = trainable_parameters(model)
        epoch = state.step // steps_per_epoch
        bn = _bn_buffers(model)  # none in the ViT encoders
        bn_before = torch._foreach_mul(bn, 1.0) if bn else []  # copies

        def restore_bn():
            if bn:
                torch._foreach_copy_(bn, bn_before)

        for p in params:
            p.grad = None
        try:
            with dropout_generator(generator):
                if accum == 1:
                    terms = loss_and_backward(model, batch, epoch, 1.0)
                else:
                    b = batch["img"].shape[0]
                    if b % accum:
                        raise ValueError(f"batch size {b} not divisible by "
                                         f"grad_accum {accum}")
                    inv = 1.0 / accum
                    terms = {}
                    for i in range(accum):
                        mb = {k: v.split(b // accum)[i] for k, v in batch.items()}
                        for k, v in loss_and_backward(model, mb, epoch, inv).items():
                            terms[k] = terms[k] + v * inv if k in terms else v * inv
        except BaseException:
            restore_bn()
            raise
        for p in params:  # a parameter no loss term reaches (the JAX gradient: 0)
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        ok = True
        if nan_guard:
            found = torch.zeros(1, device=device)
            torch._amp_foreach_non_finite_check_and_unscale_([p.grad for p in params],
                                                             found, one)
            ok = not bool(found + torch.isfinite(terms["total"]).logical_not())  # host sync
            terms["skipped_nonfinite"] = torch.tensor(0.0 if ok else 1.0, device=device)
        if ok:
            try:
                apply_update(state, model)
            except Exception as err:
                raise UpdateFailed("the optimizer or EMA update failed") from err
        else:
            restore_bn()
        state.steps_taken += 1
        return terms

    return step


def step_seed(seed: int, step_i: int) -> int:
    """The seed of step `step_i`'s generator: distinct for every
    (seed, step), the same on a resumed run."""
    return int(np.random.SeedSequence([seed, step_i]).generate_state(1, np.uint64)[0])


def make_augmented_step(cfg: Config, step_fn, seed: int, device: torch.device | str):
    """`fn(state, raw_batch, step_i) -> terms`: `device_augment` of a raw
    batch (uint8 images and labels on `device`), then `step_fn`; the
    augmentation and dropout draw from one generator seeded with
    `step_seed(seed, step_i)`."""
    gen = torch.Generator(device=device)
    d = cfg.data

    def fn(state: TrainState, raw: dict, step_i: int):
        gen.manual_seed(step_seed(seed, step_i))
        batch = device_augment(raw, gen, img_size=cfg.model.img_size,
                               theta_range=tuple(d.theta_range),
                               scale_range=tuple(d.scale_range),
                               uv_range=tuple(d.uv_range), flip=d.flip, noise=d.noise,
                               bone_length=d.bone_length, train=True)
        return step_fn(state, batch, gen)

    return fn


def make_eval_step(cfg: Config, assets: Assets, device: torch.device | str):
    """`eval_step(model, img) -> DecoderOutput`: inference, eval mode."""
    call_kwargs = model_call_kwargs(assets, device)

    def eval_step(model, img):
        with torch.no_grad():
            return model.eval()(img, **call_kwargs)

    return eval_step
