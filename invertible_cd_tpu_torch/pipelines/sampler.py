"""Consistency sampling loop — the generation hot path.

PyTorch counterpart of `invertible_cd_tpu/pipelines/sampler.py`
(`GuidanceConfig`, `w_embedding_for`, `predict_noise`, `cons_generation`).
Timesteps, boundaries and guidance values are host-side constants of the
static grid; w-conditioned models run the cond rows only.

The `NoiseModel` callable abstracts the denoiser:
    noise_model(latent, t, context, w_embedding) -> epsilon
with `latent` (B, C, H, W) NCHW, `t` a python int, `context` (B, S, D) text
states and `w_embedding` an optional (B, w_dim) tensor. Controller hooks,
step callbacks and trajectories come with the editing slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..diffusion.guidance import guidance_scale_embedding
from ..diffusion.schedule import NoiseSchedule
from ..diffusion.solver import SolverGrid, predicted_origin

NoiseModel = Callable  # (latent, t, context, w_embedding) -> eps


@dataclasses.dataclass(frozen=True)
class GuidanceConfig:
    """Static guidance setup for one sampling run.

    `w_embed_dim > 0` selects the w-conditioned path (guidance inside the
    model), otherwise explicit CFG. `edit_pair=True`: only the last row
    receives w, the reconstruction row runs unguided.
    """

    guidance_scale: float = 19.0
    w_embed_dim: int = 512
    dynamic_guidance: bool = False
    tau1: float = 1.0
    tau2: float = 1.0
    edit_pair: bool = False

    def w_at(self, t: int) -> float:
        """Host-side `linear_schedule_old`."""
        if not self.dynamic_guidance:
            return float(self.guidance_scale)
        tn = t / 1000.0
        if tn <= self.tau1:
            gamma = 1.0
        elif tn >= self.tau2:
            gamma = 0.0
        else:
            gamma = (self.tau2 - tn) / (self.tau2 - self.tau1)
        return gamma * float(self.guidance_scale)

    def cfg_scale_at(self, t: int) -> float:
        """Host-side `linear_schedule`."""
        if not self.dynamic_guidance:
            return float(self.guidance_scale)
        tn = t / 1000.0
        if tn <= self.tau1:
            return float(self.guidance_scale)
        if tn >= self.tau2:
            return 1.0
        return (self.tau2 - tn) / (self.tau2 - self.tau1) * (
            float(self.guidance_scale) - 1.0
        ) + 1.0


def w_embedding_for(
    g: GuidanceConfig, t: int, batch: int, dtype=torch.float32, device="cpu"
) -> Optional[torch.Tensor]:
    """The per-step guidance embedding (B, w_embed_dim), or None for CFG."""
    if g.w_embed_dim <= 0:
        return None
    w = g.w_at(t)
    if g.edit_pair:
        ws = np.zeros((batch,), np.float32)
        ws[-1] = w
    else:
        ws = np.full((batch,), w, np.float32)
    return guidance_scale_embedding(
        torch.from_numpy(ws).to(device), g.w_embed_dim, dtype=dtype
    )


def predict_noise(
    noise_model: NoiseModel,
    latent: torch.Tensor,
    t: int,
    context_uncond: torch.Tensor,
    context_cond: torch.Tensor,
    g: GuidanceConfig,
) -> torch.Tensor:
    """One guided epsilon prediction at static timestep `t`: cond rows only
    for w-conditioned models, the doubled [uncond; cond] batch for CFG
    models."""
    b = latent.shape[0]
    if g.w_embed_dim > 0:
        w_emb = w_embedding_for(g, t, b, latent.dtype, latent.device)
        return noise_model(latent, t, context_cond, w_emb)

    doubled = torch.cat([latent, latent], dim=0)
    ctx = torch.cat([context_uncond, context_cond], dim=0)
    eps = noise_model(doubled, t, ctx, None)
    eps_uncond, eps_text = eps.chunk(2, dim=0)
    if g.guidance_scale > 1:
        return eps_uncond + g.cfg_scale_at(t) * (eps_text - eps_uncond)
    return eps_text


def cons_generation(
    noise_model: NoiseModel,
    latent: torch.Tensor,
    context_uncond: torch.Tensor,
    context_cond: torch.Tensor,
    grid: SolverGrid,
    schedule: NoiseSchedule,
    g: GuidanceConfig,
) -> torch.Tensor:
    """Multi-boundary reverse CD: noise -> image in 3-4 hops over the
    grid's (t, s) pairs."""
    b = latent.shape[0]
    for t, s in zip(grid.reverse_timesteps.tolist(), grid.reverse_boundaries.tolist()):
        eps = predict_noise(noise_model, latent, t, context_uncond, context_cond, g)
        latent = predicted_origin(
            eps,
            torch.full((b,), t, dtype=torch.long, device=latent.device),
            torch.full((b,), s, dtype=torch.long, device=latent.device),
            latent,
            schedule.sqrt_alphas_cumprod,
            schedule.sqrt_one_minus_alphas_cumprod,
        )
    return latent
