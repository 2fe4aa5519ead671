"""Peak rates of one NVIDIA H100 SXM5 80 GB, and the least time a piece of work
can take on it.

Sources: NVIDIA H100 Tensor Core GPU data sheet (SXM5 column, dense rates,
no sparsity): 989 TFLOP/s bf16 and fp16, 495 TFLOP/s TF32, 67 TFLOP/s
float32 outside the tensor cores, 3.35 TB/s HBM3. The exponential rate is
the MUFU's: 16 `ex2` a clock on each of the 132 SMs at the 1.98 GHz boost
clock (CUDA C++ Programming Guide, arithmetic instruction throughput, compute
capability 9.0). The rates assume the card's full 700 W power limit; a card
set lower runs slower, so every result line names the card and its limit.

Float32 work is held to the TF32 tensor-core peak on every route: a float32
kernel may run on the tensor cores (3xTF32), and its yardstick does not
change with the route it took.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "tfloat32": 495e12, "float32": 67e12}
MUFU_EXP_PER_S = 132 * 16 * 1.98e9
# the peak each compute dtype is held to
YARDSTICK = {"bfloat16": "bfloat16", "float32": "tfloat32"}


def ops_s(flops: float, dtype: str) -> float:
    """FLOPs of `dtype` ("bfloat16" or "float32") over the peak it is held to."""
    return flops / PEAK_FLOPS[YARDSTICK[dtype]]


def bound_s(n_bytes: float, flops: float, dtype: str, exps: float = 0.0) -> float:
    """The least time for this work: bytes over the HBM rate, FLOPs over the
    dtype's peak, or exponentials over the MUFU rate, whichever is largest."""
    return max(n_bytes / HBM_BYTES_PER_S, ops_s(flops, dtype), exps / MUFU_EXP_PER_S)
