"""Pixel-space metrics: PSNR, MSE (reference `utils/metrics.py:295-308`).

The port's own copy of `invertible_cd_tpu/metrics/basic.py`: numpy
float64 on the host. LPIPS lives in lpips.py.
"""
from __future__ import annotations

import numpy as np


def mse(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.mean((a - b) ** 2))


def psnr(a, b, max_value: float = 255.0) -> float:
    """Peak signal-to-noise ratio between uint8-range images
    (reference `calculate_psnr`, `utils/metrics.py:295-308`)."""
    m = mse(a, b)
    if m == 0:
        return float("inf")
    return float(20.0 * np.log10(max_value) - 10.0 * np.log10(m))


def batch_psnr(a: np.ndarray, b: np.ndarray, max_value: float = 255.0) -> np.ndarray:
    """Per-image PSNR over matching (B, H, W, C) batches."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    per = ((a - b) ** 2).mean(axis=(1, 2, 3))
    return 20.0 * np.log10(max_value) - 10.0 * np.log10(np.maximum(per, 1e-12))
