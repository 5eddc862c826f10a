"""Noise schedule for the latent diffusion models (scaled-linear betas).

PyTorch counterpart of `invertible_cd_tpu/diffusion/schedule.py`: the
diffusers `DDIMScheduler(beta_start=0.00085, beta_end=0.012,
beta_schedule="scaled_linear", set_alpha_to_one=False)` tables, computed
once on the host in float64 and held as float32 tensors on one device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    """Precomputed diffusion schedule tables, each (T,) float32 on one device.

    `sqrt_alphas_cumprod` is alpha_t and `sqrt_one_minus_alphas_cumprod`
    sigma_t in consistency-model notation; `final_alpha_cumprod` is
    alphas_cumprod[0] (`set_alpha_to_one=False`).
    """

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    final_alpha_cumprod: torch.Tensor
    num_train_timesteps: int


def make_schedule(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    beta_schedule: str = "scaled_linear",
    device="cpu",
    dtype=torch.float32,
) -> NoiseSchedule:
    """Build the schedule tables (host-side, float64 accumulation)."""
    if beta_schedule == "scaled_linear":
        betas = (
            np.linspace(
                beta_start**0.5, beta_end**0.5, num_train_timesteps, dtype=np.float64
            )
            ** 2
        )
    elif beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    else:
        raise ValueError(f"Unsupported beta schedule: {beta_schedule}")
    alphas_cumprod = np.cumprod(1.0 - betas)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return NoiseSchedule(
        betas=t(betas),
        alphas_cumprod=t(alphas_cumprod),
        sqrt_alphas_cumprod=t(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=t(np.sqrt(1.0 - alphas_cumprod)),
        final_alpha_cumprod=t(alphas_cumprod[0]),
        num_train_timesteps=num_train_timesteps,
    )


def extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather `table[t]` and reshape to broadcast over an `ndim`-D sample.

    `t` has shape (B,) (or is a scalar); the result has shape (B, 1, ..., 1).
    """
    t = torch.as_tensor(t, device=table.device)
    out = table[t]
    if t.ndim == 0:
        return out
    return out.reshape(out.shape[0], *((1,) * (ndim - 1)))


def add_noise(
    schedule: NoiseSchedule, sample: torch.Tensor, noise: torch.Tensor, t
) -> torch.Tensor:
    """Forward diffusion: z_t = alpha_t * x + sigma_t * eps."""
    a = extract(schedule.sqrt_alphas_cumprod, t, sample.ndim)
    s = extract(schedule.sqrt_one_minus_alphas_cumprod, t, sample.ndim)
    return a * sample + s * noise


def ddim_timestep_grid(n_steps: int, num_train_timesteps: int = 1000) -> np.ndarray:
    """The DDIM discretisation `(arange(1..n) * (T // n)).round() - 1`,
    e.g. [19, 39, ..., 999] for n=50 (host numpy ints)."""
    step_ratio = num_train_timesteps // n_steps
    return (np.arange(1, n_steps + 1) * step_ratio).round().astype(np.int64) - 1
