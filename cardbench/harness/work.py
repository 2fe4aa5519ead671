"""The work of one forward, counted from the shapes of the benchmark's own
reference model (the configuration's module of `cardbench/reference/`) on the
meta device: no weights, no arithmetic, nothing of the program. So the
yardstick reads the same work whatever implements it, and a change to the
program cannot move it.

  * B2, the hand-written stride-1 3x3 convolution, sits at every stride-1
    `BlockConv3x3` (the residual blocks' 3x3 convs, where the upstream network's
    `Conv3x3` sits). A launch over x (B, H, W, Cin), w (3, 3, Cin, Cout) and
    y (B, H, W, Cout) does 2 B H W 9 Cin Cout FLOPs and moves each of x, w and
    y once: (B H W Cin + 9 Cin Cout + B H W Cout) elements.
  * B1, the fused attention core, sits at every `AttentionCore`: q (B, N, H, D),
    k and v (B, M, H, D), out (B, N, H D): 4 B H N M D FLOPs (the two
    products), B H N M exponentials, and q, k, v and out moved once.
  * The whole forward: every convolution (2 x output elements x Cin/groups x
    kh x kw), every linear layer (2 x rows x in x out) and every attention
    core, each in the dtype its part runs in (encoder and mid model, or
    decoder). Norms, activations and other elementwise work are not counted.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch import nn

from cardbench.harness.cell import reference_of

BYTES = {"bfloat16": 2, "float32": 4}


@dataclass
class Launch:
    flops: float
    n_bytes: float
    dtype: str
    exps: float = 0.0
    shape: tuple = ()


@dataclass
class ForwardWork:
    b2: list = field(default_factory=list)  # Launch per B2 site, in call order
    b1: list = field(default_factory=list)  # Launch per B1 site
    flops: dict = field(default_factory=dict)  # {dtype: FLOPs of the whole forward}


_CACHE: dict = {}


def forward_work(config: dict, batch: int) -> ForwardWork:
    """The work of one forward of `config`'s network over `batch` images, each
    part in the dtype `config["precision"]` names for it."""
    key = (repr(sorted(config.items())), batch)
    if key in _CACHE:
        return _CACHE[key]
    ref = reference_of(config)
    model = ref.build(config, "meta")
    prec = config["precision"]
    work = ForwardWork()
    hooks = []

    def add(dtype: str, flops: float) -> None:
        work.flops[dtype] = work.flops.get(dtype, 0.0) + flops

    def on_conv(dtype):
        def hook(mod, inputs, out):
            x = inputs[0]
            per_out = mod.in_channels // mod.groups * mod.kernel_size[0] * mod.kernel_size[1]
            flops = 2.0 * out.numel() * per_out
            add(dtype, flops)
            if isinstance(mod, ref.BlockConv3x3) and mod.stride == (1, 1):
                n = x.numel() + mod.weight.numel() + out.numel()
                work.b2.append(Launch(flops, n * BYTES[dtype], dtype,
                                      shape=(x.shape[0], x.shape[2], x.shape[1], out.shape[1])))
        return hook

    def on_linear(dtype):
        def hook(mod, inputs, out):
            add(dtype, 2.0 * out.numel() * mod.in_features)
        return hook

    def on_core(dtype):
        def hook(mod, inputs, out):
            q, k, v = inputs
            b, n, h, d = q.shape
            m = k.shape[1]
            flops = 4.0 * b * h * n * m * d
            add(dtype, flops)
            moved = q.numel() + k.numel() + v.numel() + out.numel()
            work.b1.append(Launch(flops, moved * BYTES[dtype], dtype, exps=float(b * h * n * m),
                                  shape=(b, n, m, h, d)))
        return hook

    for part, dtype in (("encoder", prec["encoder"]), ("mid_model", prec["encoder"]),
                        ("decoder", prec["decoder"])):
        for mod in getattr(model, part).modules():
            if isinstance(mod, nn.Conv2d):
                hooks.append(mod.register_forward_hook(on_conv(dtype)))
            elif isinstance(mod, nn.Linear):
                hooks.append(mod.register_forward_hook(on_linear(dtype)))
            elif isinstance(mod, ref.AttentionCore):
                hooks.append(mod.register_forward_hook(on_core(dtype)))
    size = config["img_size"]
    pe = torch.zeros(config["verts_nums"][0], 3, device="meta")
    with torch.no_grad():
        model(torch.zeros(batch, size, size, 3, dtype=torch.uint8, device="meta"), pe, pe)
    for h in hooks:
        h.remove()
    _CACHE[key] = work
    return work
