"""Full-fp32 products for the scorers, whatever the process's TF32 settings.

The metric modules compute in fp32, as the JAX package's do. PyTorch runs
fp32 convolutions through cuDNN in TF32 by default
(`torch.backends.cudnn.allow_tf32` is True), which rounds the operands to
10 mantissa bits, and a caller may allow TF32 matmuls too
(`torch.set_float32_matmul_precision("high")`). `fp32_products` turns both
off for the code it wraps and restores them after; every scorer's forward
and `resize` run under it.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def fp32_products():
    """Context manager (and decorator): cuDNN convolutions and matmuls in
    full fp32 inside, the caller's settings restored on exit."""
    conv, matmul = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.set_float32_matmul_precision(matmul)
