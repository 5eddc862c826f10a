"""`jax.image.resize`'s bilinear and cubic rules, as two products.

The JAX metric modules resize with `jax.image.resize` (antialias on): the
ViTs' `preprocess_for` in "cubic", Inception's 299^2 input and LPIPS's 224^2
in "bilinear". That resize is separable: along each axis whose size changes
it multiplies by a weight matrix (`jax/_src/image/scale.py`,
`compute_weight_mat`), built so:

  * output pixel j samples input coordinate (j + 0.5) / scale - 0.5;
  * the kernel is the triangle (bilinear) or Keys' cubic with a = -0.5
    (cubic), evaluated at |sample - i| / kernel_scale, where kernel_scale =
    max(1 / scale, 1): a downsample widens the kernel (antialiasing), an
    upsample does not;
  * each output pixel's weights are divided by their sum (where the sum is
    above 1000 * fp32 eps, else zeroed), and zeroed where the sample falls
    outside [-0.5, in - 0.5];
  * an axis whose size does not change is left as it is.

`F.interpolate(mode="bicubic")` differs on both counts (a = -0.75, no
antialias), so the matrices are built here (in float32 as JAX builds them,
cast to the input's dtype) and applied as one product per axis. Layout
NCHW: the last two axes are resized.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from .precision import fp32_products

METHODS = ("bilinear", "cubic")


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


@functools.lru_cache(maxsize=64)
def weight_matrix(in_size: int, out_size: int, method: str) -> np.ndarray:
    """(out_size, in_size) float32 weights of one axis: JAX's
    `compute_weight_mat` at translation 0, antialias on, transposed, in its
    float32 arithmetic (the sample positions' float32 rounding moves a
    weight by up to ~1e-5 at a few hundred pixels)."""
    if method not in METHODS:
        raise ValueError(f"resize method {method!r}; expected one of {METHODS}")
    kernel = _triangle if method == "bilinear" else _keys_cubic
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    w = kernel(np.abs(sample[:, None] - np.arange(in_size, dtype=f32)[None, :]) / kernel_scale)
    w = w.astype(f32)
    total = w.sum(axis=1, keepdims=True, dtype=f32)
    eps = 1000.0 * float(np.finfo(f32).eps)
    w = np.where(np.abs(total) > eps, w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[:, None], w, f32(0.0)).astype(f32)


def _matrix(in_size: int, out_size: int, method: str, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(weight_matrix(in_size, out_size, method), dtype=like.dtype,
                           device=like.device)


@fp32_products()
def resize(x: torch.Tensor, size: Tuple[int, int], method: str) -> torch.Tensor:
    """(..., H, W) -> (..., size[0], size[1]) by `jax.image.resize(...,
    method)`'s rule (antialiased when shrinking)."""
    h, w = x.shape[-2:]
    out_h, out_w = size
    if h != out_h:
        x = torch.matmul(_matrix(h, out_h, method, x), x)
    if w != out_w:
        x = torch.matmul(x, _matrix(w, out_w, method, x).T)
    return x
