"""Consistency sampling loop — the generation hot path.

PyTorch counterpart of `invertible_cd_tpu/pipelines/sampler.py`
(`GuidanceConfig`, `w_embedding_for`, `predict_noise`, `cons_generation`,
`cons_inversion`, and the 50-step DDIM baseline loop `ddim_loop`).
Timesteps, boundaries and guidance values are host-side constants of the
static grid; w-conditioned models run the cond rows only.

The `NoiseModel` callable abstracts the denoiser:
    noise_model(latent, t, context, w_embedding, hook) -> epsilon
with `latent` (B, C, H, W) NCHW, `t` a python int, `context` (B, S, D) text
states, `w_embedding` an optional (B, w_dim) tensor and `hook` an optional
attention controller hook (`models.attention.AttnHook`). A hook factory
gives the hook of each hop, and a step callback (LocalBlend) runs between
hops. Trajectories (`return_all`) are stacked NHWC, (n_hops+1, B, H, W, C),
as the JAX package returns them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..diffusion.guidance import guidance_scale_embedding
from ..diffusion.schedule import NoiseSchedule, add_noise
from ..diffusion.solver import SolverGrid, ddim_next_step, ddim_prev_step, predicted_origin

NoiseModel = Callable  # (latent, t, context, w_embedding, hook) -> eps
AttnHookFactory = Callable  # (step_index) -> Optional[hook]
StepCallback = Callable  # (latent, step_index) -> latent


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


def _wrap_cond_half(hook):
    """CFG runs a doubled [uncond; cond] batch; the controller edits the
    cond half only (JAX `sampler.py:109-126`). The wrapper keeps the hook's
    `applies` predicate, so identity layers keep the fused kernel."""
    if hook is None:
        return None

    def cond_half_hook(probs, meta):
        keep, edit = probs.chunk(2, dim=0)
        return torch.cat([keep, hook(edit, meta)], dim=0)

    applies = getattr(hook, "applies", None)
    if applies is not None:
        cond_half_hook.applies = applies
    return cond_half_hook


def predict_noise(
    noise_model: NoiseModel,
    latent: torch.Tensor,
    t: int,
    context_uncond: torch.Tensor,
    context_cond: torch.Tensor,
    g: GuidanceConfig,
    hook=None,
) -> torch.Tensor:
    """One guided epsilon prediction at static timestep `t` (JAX
    `sampler.py:129-157`): cond rows only for w-conditioned models, the
    doubled [uncond; cond] batch for CFG models, with the hook on the cond
    half."""
    b = latent.shape[0]
    if g.w_embed_dim > 0:
        w_emb = w_embedding_for(g, t, b, latent.dtype, latent.device)
        return noise_model(latent, t, context_cond, w_emb, hook)

    doubled = torch.cat([latent, latent], dim=0)
    ctx = torch.cat([context_uncond, context_cond], dim=0)
    eps = noise_model(doubled, t, ctx, None, _wrap_cond_half(hook))
    eps_uncond, eps_text = eps.chunk(2, dim=0)
    if g.guidance_scale > 1:
        return eps_uncond + g.cfg_scale_at(t) * (eps_text - eps_uncond)
    return eps_text


def _hop(eps, latent, t: int, s: int, schedule: NoiseSchedule) -> torch.Tensor:
    b = latent.shape[0]
    return predicted_origin(
        eps,
        torch.full((b,), t, dtype=torch.long, device=latent.device),
        torch.full((b,), s, dtype=torch.long, device=latent.device),
        latent,
        schedule.sqrt_alphas_cumprod,
        schedule.sqrt_one_minus_alphas_cumprod,
    )


def _nhwc_stack(trajectory) -> torch.Tensor:
    return torch.stack(trajectory, dim=0).permute(0, 1, 3, 4, 2).contiguous()


def cons_generation(
    noise_model: NoiseModel,
    latent: torch.Tensor,
    context_uncond: torch.Tensor,
    context_cond: torch.Tensor,
    grid: SolverGrid,
    schedule: NoiseSchedule,
    g: GuidanceConfig,
    hook_factory: Optional[AttnHookFactory] = None,
    step_callback: Optional[StepCallback] = None,
    context_amplify: Optional[torch.Tensor] = None,
    return_all: bool = False,
) -> torch.Tensor:
    """Multi-boundary reverse CD: noise -> image in 3-4 hops over the
    grid's (t, s) pairs (JAX `sampler.py:160-217`).

    `hook_factory(i)` gives hop i's attention hook and `step_callback(latent,
    i)` runs after hop i. `context_amplify` (the SDXL editing prompt swap)
    replaces the cond context while `t > tau1 * 1000` under dynamic
    guidance. Returns the final NCHW latent, or with `return_all=True` the
    NHWC trajectory (n_hops+1, B, H, W, C), row i the input of hop i."""
    trajectory = [latent]
    for i, (t, s) in enumerate(zip(grid.reverse_timesteps.tolist(),
                                   grid.reverse_boundaries.tolist())):
        hook = hook_factory(i) if hook_factory is not None else None
        use_amplify = context_amplify is not None and g.dynamic_guidance and t > g.tau1 * 1000
        ctx_c = context_amplify if use_amplify else context_cond
        eps = predict_noise(noise_model, latent, t, context_uncond, ctx_c, g, hook)
        latent = _hop(eps, latent, t, s, schedule)
        if step_callback is not None:
            latent = step_callback(latent, i)
        if return_all:
            trajectory.append(latent)
    return _nhwc_stack(trajectory) if return_all else latent


def cons_inversion(
    noise_model: NoiseModel,
    latent: torch.Tensor,
    noise: torch.Tensor,
    context_uncond: torch.Tensor,
    context_cond: torch.Tensor,
    grid: SolverGrid,
    schedule: NoiseSchedule,
    g: GuidanceConfig,
    return_all: bool = False,
) -> torch.Tensor:
    """Forward CD: clean latent -> noise in 3-4 hops (JAX `sampler.py:220-262`).

    `noise` (NCHW, the caller's) perturbs the clean latent to the grid's
    start timestep first. No hook. Returns the final NCHW latent, or with
    `return_all=True` the NHWC trajectory (n_hops+1, B, H, W, C), row i the
    input of forward hop i (row 0 the noised start latent)."""
    b = latent.shape[0]
    latent = add_noise(
        schedule, latent, noise,
        torch.full((b,), grid.start_timestep, dtype=torch.long, device=latent.device),
    )
    trajectory = [latent]
    for t, s in zip(grid.forward_timesteps.tolist(), grid.forward_boundaries.tolist()):
        eps = predict_noise(noise_model, latent, t, context_uncond, context_cond, g)
        latent = _hop(eps, latent, t, s, schedule)
        if return_all:
            trajectory.append(latent)
    return _nhwc_stack(trajectory) if return_all else latent


def ddim_loop(
    noise_model: NoiseModel,
    latent: torch.Tensor,
    context_uncond: torch.Tensor,
    context_cond: torch.Tensor,
    grid: SolverGrid,
    schedule: NoiseSchedule,
    g: GuidanceConfig,
    is_forward: bool,
    per_step_uncond: Optional[torch.Tensor] = None,
    hook_factory: Optional[AttnHookFactory] = None,
    step_callback: Optional[StepCallback] = None,
    return_all: bool = False,
) -> torch.Tensor:
    """The DDIM baseline loop over the grid's `n_steps` timesteps in either
    direction (JAX `sampler.py:267-491`): `is_forward=True` inverts (t
    ascending), False generates (t descending). `per_step_uncond` (n, B,
    77, D) gives step i its own uncond context (null-text embeddings).

    One eager loop gives the results of JAX's three forms (unrolled, scan,
    controller-hooked scan). A CFG model runs the doubled batch at every
    scale, keeping the cond half at scale <= 1, as JAX's do. As in JAX's
    hooked scan form, a `store_all` controller over more than two steps
    keeps one step-averaged map per hooked layer instead of one per (step,
    layer): the runtime behind `hook_factory` sums each step's maps.
    Returns the final NCHW latent, or with `return_all=True` the NHWC
    trajectory (n+1, B, H, W, C), row i the input of step i."""
    timesteps = grid.ddim_timesteps if is_forward else grid.ddim_timesteps[::-1]
    step = ddim_next_step if is_forward else ddim_prev_step
    step_ratio = schedule.num_train_timesteps // grid.n_steps
    rt = getattr(hook_factory, "__self__", None)
    sum_store = rt is not None and rt.spec.store_all and len(timesteps) > 2
    sums = None
    trajectory = [latent]
    for i, t in enumerate(timesteps.tolist()):
        cu = context_uncond if per_step_uncond is None else per_step_uncond[i]
        hook = hook_factory(i) if hook_factory is not None else None
        eps = predict_noise(noise_model, latent, t, cu, context_cond, g, hook)
        latent = step(eps, t, latent, schedule, step_ratio)
        if step_callback is not None:
            latent = step_callback(latent, i)
        if sum_store:
            sums = rt.take_step_store() if sums is None else rt.add_step_store(sums)
        if return_all:
            trajectory.append(latent)
    if sum_store:
        rt.finalize_store(sums, len(timesteps))
    return _nhwc_stack(trajectory) if return_all else latent
