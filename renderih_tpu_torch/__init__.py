"""renderih_tpu_torch: the PyTorch/CUDA port of renderih_tpu.

Two-hand MANO mesh recovery (ResNet encoder + dual-graph decoder) on an
NVIDIA H100. `renderih_tpu/` (JAX) is the reference every module here is
held against; this package imports none of it. Its hand-written CUDA
kernels (`csrc/`) are the path on the card; their plain PyTorch versions
run only for CPU tensors.
"""
