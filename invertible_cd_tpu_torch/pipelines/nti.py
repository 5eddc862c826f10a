"""Null-text inversion (NTI) and negative-prompt inversion (NPI).

PyTorch counterpart of `invertible_cd_tpu/pipelines/nti.py`: after a
50-step DDIM inversion, NTI optimises one unconditional text embedding per
DDIM step so that CFG-guided DDIM reconstruction lands on the recorded
trajectory; NPI takes the prompt's own embedding as that uncond context at
every step, for free.

JAX runs each step's inner Adam loop as one compiled `while_loop`. Here it
is an eager loop whose early-stop test reads the loss on the host: one
device-to-host sync an inner iteration. The embedding is optimised in fp32
whatever the UNet's compute dtype (the UNet casts its context); the
teacher's weights take no gradient, so only the layers downstream of the
first cross-attention run backward (on the card, B1 with its logsumexp and
B3/B4 there).

NTI runs the UNet without added conditioning, as JAX's does: SD1.5 only.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..diffusion.schedule import NoiseSchedule
from ..diffusion.solver import ddim_prev_step
from .pipeline import InvertibleCD

# optax.adam's defaults; JAX uses optax.adam(1.0) and scales its update by lr
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def nti_loss(
    noise_model,
    uncond: torch.Tensor,
    cond_noise: torch.Tensor,
    latent_cur: torch.Tensor,
    latent_prev: torch.Tensor,
    t: int,
    schedule: NoiseSchedule,
    step_ratio: int,
    guidance_scale: float,
    hook=None,
) -> torch.Tensor:
    """The reconstruction loss of one DDIM step under the uncond context
    `uncond` (JAX `nti.py:42-46`): the mean squared distance of the
    CFG-guided step from `latent_cur` (NCHW) to the recorded `latent_prev`.
    `cond_noise` is the cond prediction, computed once a step; `hook` an
    optional attention hook (e.g. the identity, for the materialised path)."""
    uncond_noise = noise_model(latent_cur, t, uncond, None, hook)
    eps = uncond_noise + guidance_scale * (cond_noise - uncond_noise)
    rec = ddim_prev_step(eps, t, latent_cur, schedule, step_ratio)
    return torch.mean((rec - latent_prev) ** 2)


def make_nti_step(pipe: InvertibleCD, num_inner_steps: int, guidance_scale: float):
    """One outer NTI step on the teacher (JAX `_build_nti_step`,
    `nti.py:28-73`): `step(uncond, latent_cur, latent_prev, ctx_c, t, lr,
    threshold) -> (optimised uncond (fp32), next latent, last loss, inner
    iterations)`, latents NCHW.

    Adam (b1 0.9, b2 0.999, eps 1e-8 added to sqrt(v_hat)), written out as
    optax's, starts afresh at every outer step; each iteration takes the
    loss and gradient at the current embedding, applies the update, then
    stops if that pre-update loss fell below `threshold` or after
    `num_inner_steps` iterations. The trajectory advances with the
    optimised embedding."""
    # outside any quantisation scope, whatever `pipe.quantize` (JAX
    # `nti.py:33-37` applies the UNet directly): the optimisation stays float
    noise_model = pipe._noise_model(pipe.unets["teacher"], quantized=False)
    schedule = pipe.schedule
    step_ratio = schedule.num_train_timesteps // pipe.grid.n_steps

    def step(uncond, latent_cur, latent_prev, ctx_c, t: int, lr: float, threshold: float):
        with torch.no_grad():
            cond_noise = noise_model(latent_cur, t, ctx_c, None)
        u = uncond.detach().float().clone()
        m, v = torch.zeros_like(u), torch.zeros_like(u)
        n_iter, loss = 0, math.inf
        while n_iter < num_inner_steps and loss >= threshold:
            u.requires_grad_(True)
            with torch.enable_grad():
                value = nti_loss(noise_model, u, cond_noise, latent_cur, latent_prev, t,
                                 schedule, step_ratio, guidance_scale)
                (grad,) = torch.autograd.grad(value, u)
            n_iter += 1
            with torch.no_grad():
                m = (1 - ADAM_B1) * grad + ADAM_B1 * m
                v = (1 - ADAM_B2) * grad * grad + ADAM_B2 * v
                m_hat = m / (1 - ADAM_B1**n_iter)
                v_hat = v / (1 - ADAM_B2**n_iter)
                u = u.detach() - lr * (m_hat / (v_hat.sqrt() + ADAM_EPS))
            loss = value.item()  # the early-stop test: one host sync an iteration
        with torch.no_grad():
            uncond_noise = noise_model(latent_cur, t, u, None)
            eps = uncond_noise + guidance_scale * (cond_noise - uncond_noise)
            latent_next = ddim_prev_step(eps, t, latent_cur, schedule, step_ratio)
        return u, latent_next, loss, n_iter

    return step


def null_text_inversion(
    pipe: InvertibleCD,
    image,
    prompt: str,
    num_inner_steps: int = 10,
    epsilon: float = 1e-5,
    guidance_scale: float = 7.5,
    trajectory=None,
    return_inner_steps: bool = False,
):
    """Invert `image` with the 50-step DDIM, then optimise per-step uncond
    embeddings (JAX `nti.py:76-118`; reference `null_optimization`): at
    step i (t descending) with lr 1e-2 * (1 - i / 100) and the early-stop
    threshold `epsilon` + i * 2e-5, each step starting from the previous
    step's embedding.

    `trajectory`: the (n+1, B, h, w, 4) NHWC output of `pipe.ddim_invert`
    (tensor or numpy), to skip the inversion here.

    Returns (per-step uncond (n_steps, B, 77, D) fp32, the inverted latent
    (B, h, w, 4) NHWC), for `pipe.ddim_generate(..., latent=...,
    nti_uncond=...)`; with `return_inner_steps` also the list of inner
    iterations each step took (one host sync each)."""
    if trajectory is None:
        trajectory, _ = pipe.ddim_invert(image, prompt)
    if isinstance(trajectory, np.ndarray):
        trajectory = np.array(trajectory, dtype=np.float32)
    traj = torch.as_tensor(trajectory, dtype=torch.float32, device=pipe.device).permute(0, 1, 4, 2, 3)
    ctx_u, ctx_c = (c.clone() for c in pipe.encode_prompt([prompt]))
    step = make_nti_step(pipe, num_inner_steps, guidance_scale)

    n = pipe.grid.n_steps
    latent_cur, uncond = traj[-1], ctx_u
    per_step, inner_steps = [], []
    for i, t in enumerate(pipe.grid.ddim_timesteps[::-1].tolist()):
        uncond, latent_cur, _, n_iter = step(
            uncond, latent_cur, traj[n - i - 1], ctx_c, t,
            1e-2 * (1.0 - i / 100.0), epsilon + i * 2e-5,
        )
        per_step.append(uncond)
        inner_steps.append(n_iter)
    inverted = traj[-1].permute(0, 2, 3, 1).contiguous()
    if return_inner_steps:
        return torch.stack(per_step), inverted, inner_steps
    return torch.stack(per_step), inverted


def negative_prompt_inversion(pipe: InvertibleCD, prompt: str) -> torch.Tensor:
    """NPI (JAX `nti.py:121-126`): the prompt's cond embedding as the
    uncond context of every step, (n_steps, 1, 77, D)."""
    _, ctx_c = pipe.encode_prompt([prompt])
    return ctx_c[None].expand((pipe.grid.n_steps,) + tuple(ctx_c.shape))
