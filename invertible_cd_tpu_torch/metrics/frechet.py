"""Fréchet distance (FID core math), scipy-free.

Capability twin of the Fréchet computation in reference
`utils/metrics.py:81-136` / `training/src/fid_score_in_memory.py:152-200`,
which use `scipy.linalg.sqrtm` on the covariance product. Here the trace of
the matrix square root is computed via symmetric eigendecompositions only:

  tr sqrt(S1 S2) = tr sqrt(S1^{1/2} S2 S1^{1/2})
                 = sum_i sqrt(eig_i(S1^{1/2} S2 S1^{1/2}))

S1^{1/2} comes from `eigh` (S1 is PSD up to numerical noise; eigenvalues
are clipped at 0). This is numerically equivalent to the reference's
sqrtm-based formula for PSD covariances, avoids the known scipy sqrtm
complex-drift warnings, and runs as plain linear algebra.

The port's own copy of `invertible_cd_tpu/metrics/frechet.py`: numpy
float64 on the host, as there (no torch linear algebra).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def compute_statistics(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) of an (N, D) feature matrix (rowvar=False covariance)."""
    features = np.asarray(features, np.float64)
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    vals, vecs = np.linalg.eigh(mat)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(
    mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray,
    eps: float = 0.0,
) -> float:
    """||mu1-mu2||^2 + tr(S1 + S2 - 2 sqrt(S1 S2)).

    eps defaults to 0: the eigh-based square root clips negative
    eigenvalues, so the degenerate-covariance regulariser the reference
    needs for scipy sqrtm (`fid_score_in_memory.py:168-175`) is not
    required; a nonzero eps biases the self-distance by ~2*D*eps."""
    mu1 = np.atleast_1d(np.asarray(mu1, np.float64))
    mu2 = np.atleast_1d(np.asarray(mu2, np.float64))
    sigma1 = np.atleast_2d(np.asarray(sigma1, np.float64))
    sigma2 = np.atleast_2d(np.asarray(sigma2, np.float64))

    diff = mu1 - mu2
    s1_half = _sqrtm_psd(sigma1 + eps * np.eye(sigma1.shape[0]))
    inner = s1_half @ (sigma2 + eps * np.eye(sigma2.shape[0])) @ s1_half
    vals = np.linalg.eigvalsh((inner + inner.T) / 2.0)
    tr_covmean = np.sum(np.sqrt(np.clip(vals, 0.0, None)))

    return float(
        diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2.0 * tr_covmean
    )


def frechet_from_features(f1: np.ndarray, f2: np.ndarray) -> float:
    m1, s1 = compute_statistics(f1)
    m2, s2 = compute_statistics(f2)
    return frechet_distance(m1, s1, m2, s2)
