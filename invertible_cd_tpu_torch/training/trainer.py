"""Dual-student LoRA trainer: one step computing all four iCD losses.

PyTorch counterpart of `invertible_cd_tpu/training/trainer.py`. A step
  * merges each student's LoRA into the frozen base weights (fp32) and casts
    the result to the UNet's compute dtype once per student,
  * evaluates reverse/forward CD + both preserve losses,
  * takes gradients w.r.t. the two adapter dicts only,
  * applies two AdamW updates with global-norm clipping.
Both students update from the same pre-step state: each objective sees the
other student's adapters as they were before the step.

The optimizer is written out on the adapter dict (`optimizer_update`) and
follows `optax.chain(clip_by_global_norm, adamw)` wrapped in
`optax.apply_if_finite` operation by operation: clip as
`g if norm < max_norm else (g / norm) * max_norm`, bias correction by
`1 - beta**count`, `eps` outside the root, decoupled weight decay.

Waiting for later slices: a data-parallel mesh, lazy per-layer adapter
application, SDXL's added conditioning.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..diffusion.schedule import NoiseSchedule
from ..diffusion.solver import TrainSolver
from ..models.lora import call_with_state, compute_dtypes, init_lora, merged_state_dict
from . import losses as L

Lora = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Static training hyperparameters."""

    learning_rate: float = 8e-6
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 0.0
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    lora_rank: int = 64
    lora_alpha: float = 8.0
    # Guidance-scale sampling: uniform over the discrete set when given,
    # else U[w_min, w_max].
    w_min: float = 3.0
    w_max: float = 15.0
    discrete_w: Optional[Tuple[float, ...]] = (0.0, 7.0, 11.0, 15.0, 19.0)
    use_reverse_cd: bool = True
    use_forward_cd: bool = True
    use_forward_preserve: bool = True
    use_reverse_preserve: bool = True
    # Rematerialise every student UNet call during backprop.
    remat: bool = False
    # Store Adam's first moment in bf16.
    bf16_moments: bool = False
    # Skip an optimizer update whose gradients contain any non-finite value
    # instead of writing NaN into the adapters. After `max_nonfinite_skips`
    # CONSECUTIVE bad steps the guard stops masking and the NaN surfaces, so
    # persistent divergence still fails loudly.
    skip_nonfinite: bool = False
    max_nonfinite_skips: int = 100
    loss: L.LossConfig = dataclasses.field(default_factory=L.LossConfig)


@dataclasses.dataclass
class ICDTrainState:
    """Everything that changes during training. Base and teacher weights
    live outside (frozen). An optimizer state is a dict: `count` (int), `mu`
    and `nu` (adapter-shaped dicts), and with `skip_nonfinite` also
    `notfinite_count`, `total_notfinite` (ints) and `last_finite` (bool)."""

    step: int
    lora_reverse: Lora
    lora_forward: Lora
    opt_reverse: Dict
    opt_forward: Dict


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
def _flat(tree: Lora) -> List[torch.Tensor]:
    return [ab[name] for ab in tree.values() for name in ("down", "up")]


def _like(tree: Lora, flat: List[torch.Tensor]) -> Lora:
    it = iter(flat)
    return {key: {"down": next(it), "up": next(it)} for key in tree}


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares over every tensor), fp32 scalar on their device."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def init_optimizer(lora: Lora, cfg: TrainConfig) -> Dict:
    """Fresh optimizer state for one adapter dict."""
    mu_dtype = torch.bfloat16 if cfg.bf16_moments else None
    state = {
        "count": 0,
        "mu": _like(lora, [torch.zeros_like(t, dtype=mu_dtype) for t in _flat(lora)]),
        "nu": _like(lora, [torch.zeros_like(t) for t in _flat(lora)]),
    }
    if cfg.skip_nonfinite:
        state.update(notfinite_count=0, total_notfinite=0, last_finite=True)
    return state


def make_optimizer(cfg: TrainConfig) -> Tuple[Callable, Callable]:
    """(init, update) of the configured optimizer: `init(lora) -> state`,
    `update(grads, state, lora) -> (new_lora, new_state, grad_norm)`."""
    return (lambda lora: init_optimizer(lora, cfg),
            lambda grads, state, lora: optimizer_update(grads, state, lora, cfg))


@torch.no_grad()
def optimizer_update(grads: Lora, state: Dict, lora: Lora, cfg: TrainConfig):
    """One clipped AdamW step. Returns (new_lora, new_state, grad_norm);
    nothing is updated in place. `grad_norm` is the global norm before
    clipping."""
    g, p = _flat(grads), _flat(lora)
    norm = global_norm(g)

    if cfg.skip_nonfinite:
        finite = bool(torch.isfinite(norm))  # one non-finite entry makes the norm non-finite
        notfinite_count = 0 if finite else state["notfinite_count"] + 1
        guard = {
            "notfinite_count": notfinite_count,
            "total_notfinite": state["total_notfinite"] + (0 if finite else 1),
            "last_finite": finite,
        }
        if not (finite or notfinite_count > cfg.max_nonfinite_skips):
            return lora, {**state, **guard}, norm
    else:
        guard = {}

    clipped = [torch.where(norm < cfg.max_grad_norm, t, (t / norm) * cfg.max_grad_norm) for t in g]
    b1, b2 = cfg.adam_beta1, cfg.adam_beta2
    count = state["count"] + 1
    # a bf16 first moment decays in bf16 (by beta1 rounded to bf16, as optax's
    # weakly typed scalar is), then joins the fp32 gradient
    mu = _flat(state["mu"])
    mu = torch._foreach_mul(mu, torch.tensor(b1, dtype=mu[0].dtype, device=mu[0].device))
    mu = [m.float() for m in mu]
    torch._foreach_add_(mu, clipped, alpha=1 - b1)
    nu = torch._foreach_mul(_flat(state["nu"]), b2)
    torch._foreach_addcmul_(nu, clipped, clipped, value=1 - b2)
    denom = torch._foreach_div(nu, 1 - b2**count)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, cfg.adam_epsilon)
    update = torch._foreach_div(mu, 1 - b1**count)
    torch._foreach_div_(update, denom)
    if cfg.adam_weight_decay:
        torch._foreach_add_(update, p, alpha=cfg.adam_weight_decay)
    new_p = torch._foreach_add(p, update, alpha=-cfg.learning_rate)
    if cfg.bf16_moments:
        mu = [m.to(torch.bfloat16) for m in mu]
    new_state = {"count": count, "mu": _like(lora, mu), "nu": _like(lora, nu), **guard}
    return _like(lora, list(new_p)), new_state, norm


def init_train_state(
    generator: torch.Generator, base: Dict[str, torch.Tensor], cfg: TrainConfig
) -> ICDTrainState:
    """Fresh LoRA adapters (identity at init) + optimizer states for both
    students, on the device of `base` (`generator` must live there too)."""
    lora_r = init_lora(base, generator, rank=cfg.lora_rank)
    lora_f = init_lora(base, generator, rank=cfg.lora_rank)
    return ICDTrainState(
        step=0,
        lora_reverse=lora_r,
        lora_forward=lora_f,
        opt_reverse=init_optimizer(lora_r, cfg),
        opt_forward=init_optimizer(lora_f, cfg),
    )


def sample_w(generator: Optional[torch.Generator], batch: int, cfg: TrainConfig,
             device="cpu") -> torch.Tensor:
    """Guidance scale per sample: uniform over the discrete set when given,
    else U[w_min, w_max]."""
    if cfg.discrete_w is not None:
        idx = L.draw_index(generator, len(cfg.discrete_w), batch, device)
        return torch.tensor(cfg.discrete_w, dtype=torch.float32, device=device)[idx]
    gdev = generator.device if generator is not None else device
    u = torch.rand((batch,), generator=generator, device=gdev).to(device)
    return cfg.w_min + (cfg.w_max - cfg.w_min) * u


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------
def make_train_step(
    unet: torch.nn.Module,
    base: Dict[str, torch.Tensor],
    teacher: Dict[str, torch.Tensor],
    solver: TrainSolver,
    schedule: NoiseSchedule,
    cfg: TrainConfig,
):
    """Build the train step.

    `unet` supplies the architecture and, through the dtypes of its own
    tensors, the compute dtype of every weight (`cast_compute_weights`);
    `base` is the frozen state dict the adapters merge into (fp32, or bf16
    to halve its memory) and `teacher` the teacher's; both stay unchanged.

    Returned signature:
      step_fn(state, batch, generator=None, draws=None) -> (new_state, metrics)
    batch: dict with
      latents: (B, h, w, 4) clean VAE latents (already scaled),
      context: (B, 77, D) prompt embeddings,
      uncond_context: (B, 77, D) (used only when not embed_guidance),
      noise: (B, h, w, 4), optional.
    `generator` (on the batch's device) draws the noise, the guidance scales
    and the four losses' timestep indices; `draws` may give any of them
    instead, under the keys "noise", "w", "reverse_index", "forward_index",
    "forward_preserve_index", "reverse_preserve_index". `state` is not
    modified; metrics are 0-dim tensors on the device (ints for the skip
    counters).
    """
    dtypes = compute_dtypes(unet)
    teacher = {key: t.detach().to(dtypes[key]) for key, t in teacher.items()}
    base = {key: t.detach() for key, t in base.items()}

    def apply_of(weights: Dict[str, torch.Tensor], context: torch.Tensor, remat: bool = False):
        def apply(x, t, w_emb):
            return call_with_state(unet, weights, x, t, context, w_cond=w_emb)
        if not remat:
            return apply
        return lambda x, t, w_emb: checkpoint(
            apply, x, t, w_emb, use_reentrant=False, preserve_rng_state=False)

    def merged(lora: Lora) -> Dict[str, torch.Tensor]:
        return merged_state_dict(
            base, lora, alpha=cfg.lora_alpha, rank=cfg.lora_rank, dtypes=dtypes)

    def step_fn(state: ICDTrainState, batch: Dict, generator=None, draws: Optional[Dict] = None):
        draws = draws or {}
        latents = batch["latents"].permute(0, 3, 1, 2)  # the UNet runs NCHW
        device = latents.device
        context = batch["context"]
        uncond_context = batch.get("uncond_context", context)
        b = latents.shape[0]
        noise = draws.get("noise", batch.get("noise"))
        if noise is None:
            gdev = generator.device if generator is not None else device
            noise = torch.randn(batch["latents"].shape, generator=generator, device=gdev,
                                dtype=latents.dtype).to(device)
        noise = noise.permute(0, 3, 1, 2)
        w = draws["w"] if "w" in draws else sample_w(generator, b, cfg, device)

        # leaves of this step's two graphs; the state's own tensors stay plain
        lora_r = _like(state.lora_reverse,
                       [t.detach().requires_grad_(True) for t in _flat(state.lora_reverse)])
        lora_f = _like(state.lora_forward,
                       [t.detach().requires_grad_(True) for t in _flat(state.lora_forward)])
        # Each student is merged once; the frozen counterpart the other
        # objective sees is the same pre-step tensors, detached.
        merged_r, merged_f = merged(lora_r), merged(lora_f)
        student_r = apply_of(merged_r, context, cfg.remat)
        student_f = apply_of(merged_f, context, cfg.remat)
        frozen_r = apply_of({k: t.detach() for k, t in merged_r.items()}, context)
        frozen_f = apply_of({k: t.detach() for k, t in merged_f.items()}, context)
        teacher_apply = apply_of(teacher, context)
        uncond_apply = apply_of(teacher, uncond_context)

        def as_loss_apply(apply):
            return lambda params, x, t, w_emb: apply(x, t, w_emb)

        common = (solver, schedule, cfg.loss)
        metrics: Dict = {}

        def update(name, total, logs, lora, lora_state, opt_state):
            grads = _like(lora, list(torch.autograd.grad(total, _flat(lora))))
            new_lora, new_opt, norm = optimizer_update(grads, opt_state, lora_state, cfg)
            metrics.update(logs)
            metrics[f"{name}_total_loss"] = total.detach()
            metrics[f"{name}_grad_norm"] = norm
            if cfg.skip_nonfinite:
                metrics[f"{name}_nonfinite_skips"] = new_opt["total_notfinite"]
            return new_lora, new_opt

        # ---- reverse student objective -------------------------------
        new_lora_r, new_opt_r = state.lora_reverse, state.opt_reverse
        if cfg.use_reverse_cd or cfg.use_reverse_preserve:
            total = torch.zeros((), dtype=torch.float32, device=device)
            logs = {}
            if cfg.use_reverse_cd:
                loss, lg = L.reverse_cd_loss(
                    as_loss_apply(student_r), None, as_loss_apply(teacher_apply), None,
                    latents, noise, w, generator, *common,
                    uncond_apply=as_loss_apply(uncond_apply), index=draws.get("reverse_index"),
                )
                total = total + loss
                logs.update(lg)
            if cfg.use_reverse_preserve:
                loss, lg = L.reverse_preserve_loss(
                    as_loss_apply(frozen_f), None, as_loss_apply(student_r), None,
                    latents, noise, generator, *common,
                    endpoint_index=draws.get("reverse_preserve_index"),
                )
                total = total + cfg.loss.reverse_preserve_coef * loss
                logs.update(lg)
            new_lora_r, new_opt_r = update(
                "reverse", total, logs, lora_r, state.lora_reverse, state.opt_reverse)
            del total, loss

        # ---- forward student objective -------------------------------
        new_lora_f, new_opt_f = state.lora_forward, state.opt_forward
        if cfg.use_forward_cd or cfg.use_forward_preserve:
            total = torch.zeros((), dtype=torch.float32, device=device)
            logs = {}
            if cfg.use_forward_cd:
                loss, lg = L.forward_cd_loss(
                    as_loss_apply(student_f), None, as_loss_apply(teacher_apply), None,
                    latents, noise, w, generator, *common,
                    uncond_apply=as_loss_apply(uncond_apply), index=draws.get("forward_index"),
                )
                total = total + loss
                logs.update(lg)
            if cfg.use_forward_preserve:
                loss, lg = L.forward_preserve_loss(
                    as_loss_apply(student_f), None, as_loss_apply(frozen_r), None,
                    latents, noise, generator, *common,
                    endpoint_index=draws.get("forward_preserve_index"),
                )
                total = total + cfg.loss.forward_preserve_coef * loss
                logs.update(lg)
            new_lora_f, new_opt_f = update(
                "forward", total, logs, lora_f, state.lora_forward, state.opt_forward)

        new_state = ICDTrainState(
            step=state.step + 1,
            lora_reverse=new_lora_r,
            lora_forward=new_lora_f,
            opt_reverse=new_opt_r,
            opt_forward=new_opt_f,
        )
        return new_state, metrics

    return step_fn
