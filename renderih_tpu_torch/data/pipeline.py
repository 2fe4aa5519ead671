"""Input pipeline: sampling + on-device augmentation (counterpart of
`renderih_tpu/data/pipeline.py`).

Per step the host draws a shard of indices (`HostSampler`, the
DistributedSampler equivalent) and the batch is gathered, then augmented
on the device, batched: affine warp (theta/scale/u/v), 50% L/R flip with
label swap, brightness/gaussian noise, ImageNet normalisation,
root-relative 3D with the bone rescaled to 0.095 m, the root_rel offset.
Label semantics match `handDataset.process_data`.

The augmentation is split into its random draws (`augment_draws`, from a
`torch.Generator`) and a deterministic transform that takes them
(`augment_transform`), so a caller can feed any draws; `device_augment`
is the two in one.
"""

from __future__ import annotations

import numpy as np
import torch

from renderih_tpu_torch.ops.image import (
    add_noise,
    affine_mat,
    noise_draws,
    normalize_imagenet,
    transform_points2d,
    warp_affine_bilinear,
)
from renderih_tpu_torch.ops.rotation import rodrigues, rodrigues_inverse, rotmat_z

_HANDS = ("left", "right")


def _uniform(gen, shape, low: float, high: float, device) -> torch.Tensor:
    return low + (high - low) * torch.rand(shape, generator=gen, device=device)


def augment_draws(gen: torch.Generator | None, batch_size: int, img_shape: tuple,
                  theta_range: tuple = (-90.0, 90.0),
                  scale_range: tuple = (0.9, 1.1), uv_range: tuple = (0.0, 0.0),
                  flip: bool = True, noise: float = 0.0) -> dict:
    """The random draws of one training augmentation, on `gen`'s device:
    theta, scale, u, v (B,) uniform in their ranges; flip (B,) bool, true
    with probability 1/2 when `flip`; the noise draws of `add_noise` for
    images of `img_shape` (the augmented output's (B, S, S, C))."""
    dev = gen.device if gen is not None else None
    b = batch_size
    draws = {
        "theta": _uniform(gen, (b,), *theta_range, dev),
        "scale": _uniform(gen, (b,), *scale_range, dev),
        "u": _uniform(gen, (b,), *uv_range, dev),
        "v": _uniform(gen, (b,), *uv_range, dev),
        "flip": (torch.rand((b,), generator=gen, device=dev) > 0.5 if flip
                 else torch.zeros((b,), dtype=torch.bool, device=dev)),
    }
    draws["noise"] = noise_draws(gen, img_shape, noise)
    return draws


def augment_transform(batch: dict, draws: dict | None, img_size: int = 256,
                      noise: float = 0.0, bone_length: float = 0.095) -> dict:
    """uint8 images + raw labels -> augmented, normalized training batch.

    `draws` from `augment_draws` (train), or None (eval: no warp, flip or
    noise)."""
    img_u8 = batch["img_u8"]
    b = img_u8.shape[0]
    l2d = {h: {"v": batch[f"v2d_{h}"], "j": batch[f"j2d_{h}"]} for h in _HANDS}
    l3d = {h: {"v": batch[f"v3d_{h}"], "j": batch[f"j3d_{h}"]} for h in _HANDS}

    if draws is not None:
        theta = draws["theta"]
        mat = affine_mat(theta, draws["scale"], draws["u"], draws["v"], float(img_size))
        img = warp_affine_bilinear(img_u8, mat, img_size)
        rz = rotmat_z(theta)  # (B, 3, 3)
        for h in _HANDS:
            for k in ("v", "j"):
                l2d[h][k] = transform_points2d(l2d[h][k], mat)
                l3d[h][k] = torch.einsum("bij,bnj->bni", rz, l3d[h][k])
        img = add_noise(img, draws["noise"], noise=noise)
        do_flip = draws["flip"]
    else:
        theta = torch.zeros((b,), device=img_u8.device)
        img = img_u8.float()
        do_flip = torch.zeros((b,), dtype=torch.bool, device=img_u8.device)

    # 50% horizontal flip with hand swap (`core/loader.py:144-212`)
    img = torch.where(do_flip[:, None, None, None], img.flip(2), img)

    def flip2d(x):
        return torch.cat([img_size - x[..., :1], x[..., 1:]], dim=-1)

    def flip3d(x):
        return torch.cat([-x[..., :1], x[..., 1:]], dim=-1)

    f = do_flip[:, None, None]
    out2d, out3d = {}, {}
    for h, other in (("left", "right"), ("right", "left")):
        out2d[h] = {k: torch.where(f, flip2d(l2d[other][k]), l2d[h][k]) for k in ("v", "j")}
        out3d[h] = {k: torch.where(f, flip3d(l3d[other][k]), l3d[h][k]) for k in ("v", "j")}

    # root-relative 3D (root = joint 9) + bone rescale (`:180-196`)
    root = {h: out3d[h]["j"][:, 9:10] for h in _HANDS}
    root_rel = (root["right"] - root["left"])[:, 0]
    for h in _HANDS:
        out3d[h] = {k: v - root[h] for k, v in out3d[h].items()}
    length = 0.5 * (
        torch.linalg.vector_norm(out3d["left"]["j"][:, 9] - out3d["left"]["j"][:, 0], dim=-1)
        + torch.linalg.vector_norm(out3d["right"]["j"][:, 9] - out3d["right"]["j"][:, 0],
                                   dim=-1))
    s = bone_length / (length + 1e-12)
    root_rel = root_rel * s[:, None]
    for h in _HANDS:
        out3d[h] = {k: v * s[:, None, None] for k, v in out3d[h].items()}

    out = {
        "img": normalize_imagenet(img / 255.0),
        "v2d_left": out2d["left"]["v"], "j2d_left": out2d["left"]["j"],
        "v2d_right": out2d["right"]["v"], "j2d_right": out2d["right"]["j"],
        "v3d_left": out3d["left"]["v"], "j3d_left": out3d["left"]["j"],
        "v3d_right": out3d["right"]["v"], "j3d_right": out3d["right"]["j"],
        "root_rel": root_rel,
    }

    # MANO parameter labels (`core/loader_mano.py:124-190`): the in-plane
    # rotation composes onto the root axis-angle; the flip mirrors the pose
    # (negate y/z per joint) and swaps the hands.
    if "pose_left" in batch:
        rz = rotmat_z(theta)

        def rotate_root(pose48):
            new_root = rodrigues_inverse(torch.einsum("bij,bjk->bik", rz,
                                                      rodrigues(pose48[:, :3])))
            return torch.cat([new_root, pose48[:, 3:]], -1)

        mirror = torch.tensor([1.0, -1.0, -1.0], device=img_u8.device)
        pose = {h: rotate_root(batch[f"pose_{h}"]) for h in _HANDS}
        f1 = do_flip[:, None]
        for h, other in (("left", "right"), ("right", "left")):
            mirrored = (pose[other].reshape(b, 16, 3) * mirror).reshape(b, 48)
            out[f"pose_{h}"] = torch.where(f1, mirrored, pose[h])
            out[f"shape_{h}"] = torch.where(f1, batch[f"shape_{other}"], batch[f"shape_{h}"])
    return out


def device_augment(batch: dict, gen: torch.Generator | None, img_size: int = 256,
                   theta_range: tuple = (-90.0, 90.0), scale_range: tuple = (0.9, 1.1),
                   uv_range: tuple = (0.0, 0.0), flip: bool = True, noise: float = 0.0,
                   bone_length: float = 0.095, train: bool = True) -> dict:
    """`augment_transform` on draws from `gen` (train) or on none (eval)."""
    draws = None
    if train:
        b, _, _, c = batch["img_u8"].shape
        draws = augment_draws(gen, b, (b, img_size, img_size, c), theta_range,
                              scale_range, uv_range, flip, noise)
    return augment_transform(batch, draws, img_size, noise, bone_length)


class HostSampler:
    """Per-host shard of a shuffled epoch (DistributedSampler equivalent):
    epoch e is `np.random.default_rng(seed + e).permutation(n)`, the host's
    stride of it, cut to whole batches."""

    def __init__(self, n: int, batch_size: int, host_id: int = 0,
                 num_hosts: int = 1, seed: int = 0):
        self.n = n
        self.batch_size = batch_size
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.seed = seed
        self.epoch = 0
        self._order = None
        self._pos = 0

    def _reshuffle(self):
        order = np.random.default_rng(self.seed + self.epoch).permutation(self.n)
        shard = order[self.host_id::self.num_hosts]
        usable = (len(shard) // self.batch_size) * self.batch_size
        self._order = shard[:usable]
        self._pos = 0

    @property
    def batches_per_epoch(self) -> int:
        return (self.n // self.num_hosts) // self.batch_size

    def skip(self, n_batches: int) -> None:
        """Advance as `n_batches` calls of `next_indices` would (a resumed
        run sees the batches the uninterrupted one would have)."""
        if n_batches <= 0:
            return
        per_epoch = len(range(self.host_id, self.n, self.num_hosts)) // self.batch_size
        full, rest = divmod(n_batches, per_epoch)
        if rest == 0:
            full, rest = full - 1, per_epoch
        self.epoch = full
        self._reshuffle()
        self.epoch += 1
        self._pos = rest * self.batch_size

    def next_indices(self) -> np.ndarray:
        if self._order is None or self._pos >= len(self._order):
            self._reshuffle()
            self.epoch += 1
        idx = self._order[self._pos:self._pos + self.batch_size]
        self._pos += self.batch_size
        return np.sort(idx)  # sorted slice = sequential memmap reads


class DataProvider:
    """Infinite provider: packed dataset -> host batches (augmentation runs
    on the device, `device_augment`)."""

    def __init__(self, dataset, batch_size: int, host_id: int = 0,
                 num_hosts: int = 1, seed: int = 0):
        self.dataset = dataset
        self.sampler = HostSampler(len(dataset), batch_size, host_id, num_hosts, seed)

    @property
    def batch_per_epoch(self) -> int:
        return self.sampler.batches_per_epoch

    def next(self) -> dict:
        return self.dataset.batch(self.sampler.next_indices())
