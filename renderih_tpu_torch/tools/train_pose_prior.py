"""Train the pose-naturalness discriminator and save it as an artifact
(counterpart of `tools/train_pose_prior.py`).

The GAN prior of the reference (`pose_data_optimize/Ver2Code/
Discriminator/discrim.py:66-105`) ships no weights. This trains
`models/aux_nets.py:PoseDiscriminator` with the LSGAN objective (real ->
1, fake -> 0) and Adam on plausible poses (the synthetic corpus's
N(0, 0.3²) axis-angle) against three families of implausible ones, and
saves the npz layout both packages' `load_pose_prior` read (flax names,
`fc1/kernel` (9, 32), ...), for `optimize.geo.make_gan_pose_prior`.

    python -m renderih_tpu_torch.tools.train_pose_prior --out build/pose_prior.npz
    python -m renderih_tpu_torch.tools.train_pose_prior --out build/p.npz --steps 100 --device cpu

Runs on the card unless `--device cpu`; without a card the default raises.
Every draw comes from one `torch.Generator` seeded from `--seed` on the
device. At the end plausible poses must score above the fakes (as the JAX
tool checks). `main(argv)` returns the losses and those scores.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from renderih_tpu_torch.models.aux_nets import PoseDiscriminator
from renderih_tpu_torch.models.layers import lecun_normal_
from renderih_tpu_torch.ops.rotation import rodrigues
from renderih_tpu_torch.optimize.geo import POSE_PRIOR_PATH, save_pose_prior
from renderih_tpu_torch.serve import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=POSE_PRIOR_PATH)
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def sample_real(gen: torch.Generator, n: int) -> torch.Tensor:
    """Plausible poses: the synthetic corpus's N(0, 0.3²) axis-angle."""
    return torch.randn((n, 45), generator=gen, device=gen.device) * 0.3


def sample_fake(gen: torch.Generator, n: int) -> torch.Tensor:
    """Implausible poses, three families mixed: hyper-extended joints
    (axis-angle of 1.8-3.1 rad), sign-flipped plausible poses times 3
    (backwards bends), heavy-tailed noise (2.5x the plausible scale)."""
    dev = gen.device
    third = n // 3
    axis = torch.randn((third, 15, 3), generator=gen, device=dev)
    axis = axis / (torch.linalg.norm(axis, dim=-1, keepdim=True) + 1e-8)
    angle = torch.rand((third, 15, 1), generator=gen, device=dev) * 1.3 + 1.8
    fake = torch.cat([(axis * angle).reshape(third, 45),
                      -torch.abs(sample_real(gen, third)) * 3.0,
                      torch.randn((n - 2 * third, 45), generator=gen, device=dev) * 0.75])
    return fake[torch.randperm(n, generator=gen, device=dev)]


def logits(disc: PoseDiscriminator, pose_aa: torch.Tensor):
    return disc(rodrigues(pose_aa.reshape(-1, 15, 3)))


def flax_params(disc: PoseDiscriminator) -> dict:
    """The discriminator's weights in the JAX module's layout (numpy)."""
    return {name: {"kernel": lin.weight.detach().cpu().numpy().T,
                   "bias": lin.bias.detach().cpu().numpy()}
            for name, lin in disc.named_children()}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    init_gen = torch.Generator().manual_seed(args.seed)
    disc = PoseDiscriminator()
    for lin in disc.children():
        lecun_normal_(lin, init_gen)
    disc.to(device)
    opt = torch.optim.Adam(disc.parameters(), lr=args.lr)

    losses, accs = [], []
    t0 = time.perf_counter()
    for i in range(args.steps):
        pj_r, ov_r = logits(disc, sample_real(gen, args.batch))
        pj_f, ov_f = logits(disc, sample_fake(gen, args.batch))
        # LSGAN (stable, no saturation): real -> 1, fake -> 0
        loss = (torch.mean((pj_r - 1.0) ** 2) + torch.mean((ov_r - 1.0) ** 2)
                + torch.mean(pj_f ** 2) + torch.mean(ov_f ** 2))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        accs.append(0.5 * ((ov_r > 0.5).float().mean() + (ov_f < 0.5).float().mean()))
        if (i + 1) % 250 == 0 or i == 0:
            print(f"step {i + 1}/{args.steps}: loss {float(loss.detach()):.4f} "
                  f"acc {float(accs[-1]):.3f}", flush=True)
    losses = torch.stack(losses).cpu().numpy()
    seconds = time.perf_counter() - t0

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    save_pose_prior(flax_params(disc), args.out)
    print(f"saved {args.out}", flush=True)

    # sanity: plausible poses must score above randomized ones
    check = torch.Generator(device=device).manual_seed(123)
    with torch.no_grad():
        real = float(logits(disc, sample_real(check, 512))[1].mean())
        fake = float(logits(disc, sample_fake(check, 512))[1].mean())
    print(f"mean realism logit: plausible {real:.3f} vs randomized {fake:.3f}", flush=True)
    if not real > fake:
        raise RuntimeError(f"the discriminator scores plausible poses ({real:.3f}) "
                           f"no higher than randomized ones ({fake:.3f})")
    return dict(losses=losses, accuracy=float(accs[-1]), real_logit=real, fake_logit=fake,
                seconds=seconds, steps_per_s=args.steps / seconds, device=str(device))


if __name__ == "__main__":
    main(sys.argv[1:])
