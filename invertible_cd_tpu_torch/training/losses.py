"""The four iCD training losses as functions of tensors.

PyTorch counterpart of `invertible_cd_tpu/training/losses.py`:

  reverse_cd_loss        — reverse consistency distillation
  forward_cd_loss        — forward (inversion) CD
  forward_preserve_loss  — the forward student must invert the reverse
                           student's multi-step rollout back to its input
  reverse_preserve_loss  — the reverse student must undo the forward
                           student's hop

No optimizer plumbing inside a loss; the trainer composes them. Teacher and
self-target passes run under `torch.no_grad()`; the differentiable rollout
of `reverse_preserve_loss` wraps each UNet call in
`torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`.

The denoiser is abstracted as `apply(params, x, t, w_emb) -> eps`, with the
text context closed over by the trainer. The losses are elementwise over
everything after the batch axis, so `x` may be NCHW or NHWC, whichever
`apply` takes. Each loss draws its timestep indices from a
`torch.Generator`, or takes them as an argument (`index=` /
`endpoint_index=`), so a caller can replay another implementation's draws.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..diffusion.guidance import guidance_scale_embedding
from ..diffusion.schedule import NoiseSchedule, add_noise
from ..diffusion.solver import TrainSolver, predicted_origin

Apply = Callable  # (params, x, t:(B,), w_emb Optional) -> eps


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Static loss hyperparameters."""

    num_ddim_timesteps: int = 50
    num_train_timesteps: int = 1000
    loss_type: str = "huber"  # "huber" | "l2"
    huber_c: float = 0.001
    embed_guidance: bool = True
    w_embed_dim: int = 512
    start_forward_timestep: int = 19
    forward_preserve_coef: float = 1.5
    reverse_preserve_coef: float = 1.5

    @property
    def topk(self) -> int:
        return self.num_train_timesteps // self.num_ddim_timesteps


def draw_index(generator: Optional[torch.Generator], high: int, batch: int, device) -> torch.Tensor:
    """(batch,) int64 indices uniform in [0, high) from `generator` (drawn on
    the generator's device), on `device`."""
    gdev = generator.device if generator is not None else device
    return torch.randint(0, high, (batch,), generator=generator, device=gdev).to(device)


def _loss(pred: torch.Tensor, target: torch.Tensor, cfg: LossConfig) -> torch.Tensor:
    diff = pred.float() - target.float()
    if cfg.loss_type == "l2":
        return torch.mean(diff**2)
    return torch.mean(torch.sqrt(diff**2 + cfg.huber_c**2) - cfg.huber_c)


def _w_emb(w: torch.Tensor, cfg: LossConfig, dtype) -> Optional[torch.Tensor]:
    if not cfg.embed_guidance:
        return None
    return guidance_scale_embedding(w, cfg.w_embed_dim, dtype=dtype)


def _origin(eps, t, s, x, schedule: NoiseSchedule):
    return predicted_origin(
        eps, t, s, x,
        schedule.sqrt_alphas_cumprod, schedule.sqrt_one_minus_alphas_cumprod,
    )


def _batch_shaped(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.reshape(-1, *([1] * (like.ndim - 1)))


@torch.no_grad()
def _teacher_ode_target(
    teacher_apply: Apply,
    teacher_params,
    uncond_apply: Optional[Callable],
    z_t: torch.Tensor,
    start_t: torch.Tensor,
    index: torch.Tensor,
    w: torch.Tensor,
    w_emb,
    solver: TrainSolver,
    schedule: NoiseSchedule,
    cfg: LossConfig,
    forward: bool,
):
    """One teacher ODE step, without gradient: x0/eps prediction (CFG-mixed
    when the teacher is not w-conditioned) then a single DDIM hop along the
    grid."""
    zero_t = torch.zeros_like(start_t)
    eps_c = teacher_apply(teacher_params, z_t, start_t, w_emb)
    x0_c = _origin(eps_c, start_t, zero_t, z_t, schedule)
    if not cfg.embed_guidance and uncond_apply is not None:
        eps_u = uncond_apply(teacher_params, z_t, start_t, None)
        x0_u = _origin(eps_u, start_t, zero_t, z_t, schedule)
        wb = _batch_shaped(w, z_t)
        x0 = x0_c + wb * (x0_c - x0_u)
        eps = eps_c + wb * (eps_c - eps_u)
    else:
        x0, eps = x0_c, eps_c
    if forward:
        return solver.forward_ddim_step(x0, eps, index)
    return solver.ddim_step(x0, eps, index)


def _cd_loss(
    student_apply, student_params, teacher_apply, teacher_params, latents, noise, w,
    index, t_of, boundary_of, solver, schedule, cfg, uncond_apply, forward: bool,
):
    """The body both CD losses share: student prediction at start_t ->
    boundary against the student's own (no-grad) prediction from the
    teacher's one-step neighbour at t -> boundary."""
    start_t = solver.ddim_timesteps[index]
    t = t_of(start_t)
    boundary = boundary_of(t)

    z_t = add_noise(schedule, latents, noise, start_t)
    w_emb = _w_emb(w, cfg, latents.dtype)

    # Student prediction (grad) at start_t -> boundary.
    eps_student = student_apply(student_params, z_t, start_t, w_emb)
    model_pred = _origin(eps_student, start_t, boundary, z_t, schedule)

    # Teacher ODE step (no grad) start_t -> t.
    x_next = _teacher_ode_target(
        teacher_apply, teacher_params, uncond_apply, z_t, start_t, index,
        w, w_emb, solver, schedule, cfg, forward=forward,
    )

    # Self-target (no grad, the online student) at t -> boundary, with the
    # boundary condition.
    with torch.no_grad():
        eps_target = student_apply(student_params, x_next, t, w_emb)
        target_pred = _origin(eps_target, t, boundary, x_next, schedule)
        at_boundary = _batch_shaped(t == boundary, latents)
        target_pred = torch.where(at_boundary, x_next, target_pred)

    return _loss(model_pred, target_pred, cfg)


def reverse_cd_loss(
    student_apply: Apply,
    student_params,
    teacher_apply: Apply,
    teacher_params,
    latents: torch.Tensor,
    noise: torch.Tensor,
    w: torch.Tensor,
    generator: Optional[torch.Generator],
    solver: TrainSolver,
    schedule: NoiseSchedule,
    cfg: LossConfig,
    uncond_apply: Optional[Callable] = None,
    index: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Reverse (noise->image) consistency distillation loss."""
    if index is None:
        index = draw_index(generator, cfg.num_ddim_timesteps, latents.shape[0], latents.device)
    last_t = solver.ddim_timesteps[-1]
    loss = _cd_loss(
        student_apply, student_params, teacher_apply, teacher_params, latents, noise, w, index,
        lambda start_t: torch.minimum((start_t - cfg.topk).clamp_min(0), last_t),
        solver.reverse_boundaries_for, solver, schedule, cfg, uncond_apply, forward=False,
    )
    return loss, {"reverse_cd_loss": loss.detach()}


def forward_cd_loss(
    student_apply: Apply,
    student_params,
    teacher_apply: Apply,
    teacher_params,
    latents: torch.Tensor,
    noise: torch.Tensor,
    w: torch.Tensor,
    generator: Optional[torch.Generator],
    solver: TrainSolver,
    schedule: NoiseSchedule,
    cfg: LossConfig,
    uncond_apply: Optional[Callable] = None,
    index: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward (image->noise) CD loss. The forward student always trains at
    w == 0."""
    if index is None:
        index = draw_index(generator, cfg.num_ddim_timesteps - 1, latents.shape[0], latents.device)
    max_t = solver.ddim_timesteps[cfg.num_ddim_timesteps - 1]
    loss = _cd_loss(
        student_apply, student_params, teacher_apply, teacher_params, latents, noise,
        torch.zeros_like(w), index,
        lambda start_t: torch.minimum((start_t + cfg.topk).clamp_min(0), max_t),
        solver.forward_boundaries_for, solver, schedule, cfg, uncond_apply, forward=True,
    )
    return loss, {"forward_cd_loss": loss.detach()}


def _preserve_grids(solver: TrainSolver, cfg: LossConfig, endpoint_index):
    """Shared start/end/rollout-timestep selection for the preserve losses."""
    n_rev = solver.endpoints.shape[0] // solver.forward_endpoints.shape[0]
    start = torch.full_like(solver.endpoints[:1], cfg.start_forward_timestep)
    fwd_end = solver.forward_endpoints[endpoint_index]
    low_ends = solver.endpoints[::n_rev][endpoint_index]
    low_ends = torch.where(low_ends == 0, start, low_ends)
    rollout = solver.endpoints.reshape(-1, n_rev)[endpoint_index]
    rollout = torch.where(rollout == 0, start, rollout)
    return n_rev, fwd_end, low_ends, rollout


def _preserve_setup(latents, generator, endpoint_index, solver, cfg):
    b = latents.shape[0]
    if endpoint_index is None:
        endpoint_index = draw_index(
            generator, solver.forward_endpoints.shape[0], b, latents.device)
    n_rev, high_t, low_t, rollout = _preserve_grids(solver, cfg, endpoint_index)
    zero_w = torch.zeros((b,), dtype=torch.float32, device=latents.device)  # CFG = 0
    return n_rev, high_t, low_t, rollout, _w_emb(zero_w, cfg, latents.dtype)


def forward_preserve_loss(
    forward_apply: Apply,
    forward_params,
    reverse_apply: Apply,
    reverse_params,
    latents: torch.Tensor,
    noise: torch.Tensor,
    generator: Optional[torch.Generator],
    solver: TrainSolver,
    schedule: NoiseSchedule,
    cfg: LossConfig,
    endpoint_index: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Train the forward student to invert the reverse student's (frozen)
    multi-step rollout. Gradients flow only into the forward student."""
    n_rev, start_t, left_end, rollout, w_emb = _preserve_setup(
        latents, generator, endpoint_index, solver, cfg)
    z_start = add_noise(schedule, latents, noise, start_t)

    # Frozen reverse rollout start_t -> ... -> left_end.
    with torch.no_grad():
        x = z_start
        cur_t = start_t
        for i in range(n_rev):
            eps = reverse_apply(reverse_params, x, cur_t, w_emb)
            next_t = rollout[:, n_rev - i - 1]
            x = _origin(eps, cur_t, next_t, x, schedule)
            cur_t = next_t

    # Forward student (grad) maps the rollout result back up to start_t.
    eps_f = forward_apply(forward_params, x, left_end, w_emb)
    pred = _origin(eps_f, left_end, start_t, x, schedule)

    loss = _loss(pred, z_start, cfg)
    return loss, {"forward_preserve_loss": loss.detach()}


def reverse_preserve_loss(
    forward_apply: Apply,
    forward_params,
    reverse_apply: Apply,
    reverse_params,
    latents: torch.Tensor,
    noise: torch.Tensor,
    generator: Optional[torch.Generator],
    solver: TrainSolver,
    schedule: NoiseSchedule,
    cfg: LossConfig,
    remat: bool = True,
    endpoint_index: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Train the reverse student to undo the forward student's (frozen) hop:
    a differentiable multi-step reverse rollout back to the start latent.
    The most memory-hungry loss: each rollout UNet call is rematerialised
    unless `remat=False`."""
    n_rev, end_t, start_t, rollout, w_emb = _preserve_setup(
        latents, generator, endpoint_index, solver, cfg)
    z_start = add_noise(schedule, latents, noise, start_t)

    # Frozen forward hop start_t -> end_t.
    with torch.no_grad():
        eps_f = forward_apply(forward_params, z_start, start_t, w_emb)
        x = _origin(eps_f, start_t, end_t, z_start, schedule)

    # Differentiable reverse rollout end_t -> ... -> start_t.
    def rev(x, t):
        return reverse_apply(reverse_params, x, t, w_emb)

    cur_t = end_t
    for i in range(n_rev):
        eps = (checkpoint(rev, x, cur_t, use_reentrant=False, preserve_rng_state=False)
               if remat else rev(x, cur_t))
        next_t = rollout[:, n_rev - i - 1]
        x = _origin(eps, cur_t, next_t, x, schedule)
        cur_t = next_t

    loss = _loss(x, z_start, cfg)
    return loss, {"reverse_preserve_loss": loss.detach()}
