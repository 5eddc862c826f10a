"""PyTorch/CUDA port of invertible_cd_tpu for NVIDIA Hopper (H100).

The module layout mirrors the JAX package's, so each module's counterpart
has the same path under `invertible_cd_tpu/`. This package imports torch
and numpy only, never JAX or the JAX package. Its kernels are hand-written
CUDA C++ under `ops/csrc/`, built with nvcc at first use.
"""
