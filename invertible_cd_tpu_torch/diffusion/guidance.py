"""Guidance math: dynamic tau schedules and the w-embedding.

PyTorch counterpart of `invertible_cd_tpu/diffusion/guidance.py`.
"""
from __future__ import annotations

import numpy as np
import torch


def linear_schedule_old(t, guidance_scale, tau1: float, tau2: float):
    """Step/ramp schedule of the *w-embedding* value under dynamic guidance:
    gamma = 1 for t/1000 <= tau1, 0 for t/1000 >= tau2, linear in between;
    returns gamma * guidance_scale."""
    tn = torch.as_tensor(t, dtype=torch.float32) / 1000.0
    ramp = (tau2 - tn) / max(tau2 - tau1, 1e-12)
    gamma = torch.where(
        tn <= tau1, torch.ones_like(tn), torch.where(tn >= tau2, torch.zeros_like(tn), ramp)
    )
    return gamma * guidance_scale


def linear_schedule(t, guidance_scale, tau1: float = 0.4, tau2: float = 0.8):
    """Ramp from full guidance down to 1.0 for explicit CFG mixing under
    dynamic guidance."""
    tn = torch.as_tensor(t, dtype=torch.float32) / 1000.0
    mid = (tau2 - tn) / max(tau2 - tau1, 1e-12) * (guidance_scale - 1.0) + 1.0
    full = torch.full_like(tn, float(guidance_scale))
    return torch.where(tn <= tau1, full, torch.where(tn >= tau2, torch.ones_like(tn), mid))


def guidance_scale_embedding(w, embedding_dim: int = 512, dtype=torch.float32):
    """Sinusoidal embedding of the guidance scale, scaled by 1000.

    Args:
      w: (B,) guidance scales (tensor; its device is kept).
    Returns:
      (B, embedding_dim) [sin || cos] features.
    """
    w = torch.as_tensor(w).to(dtype) * 1000.0
    half_dim = embedding_dim // 2
    freq = torch.exp(
        torch.arange(half_dim, dtype=dtype, device=w.device)
        * (-np.log(10000.0) / (half_dim - 1))
    )
    emb = w[:, None] * freq[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
    if embedding_dim % 2 == 1:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb
