"""Dual-student LoRA trainer: one step computing all four iCD losses.

PyTorch counterpart of `invertible_cd_tpu/training/trainer.py`. A step
  * merges each student's LoRA into the frozen base weights (fp32) and casts
    the result to the UNet's compute dtype once per student, or, with
    `lazy_lora`, adds each adapter's low-rank path to its layer's output
    during every student call (`models.lora.call_with_lora`) on the base
    weights in the compute dtype, so no merged copy and no full-size weight
    gradient exists,
  * passes SDXL's added conditioning (`batch["added_cond"]`) to every UNet
    call, with the pooled text embeds zeroed for the unconditional teacher
    call,
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

A step makes its random draws (the noise, the guidance scales, the four
losses' timestep indices) up front, at the global batch size, and keeps its
rows of them. With a mesh (`parallel.make_mesh`) the step is data parallel
over the mesh's dp x fsdp ranks: each rank is given its own rows of the
batch and a generator seeded alike on every rank (or the draws at the
global batch); the adapter gradients (before the clip and the non-finite
guard) and the logged losses are averaged over the ranks, so every rank
applies the same update and the step is the one-process step on the
concatenated batch. Under fsdp > 1 each rank holds only its
`parallel.param_sharding` shard of every large base and teacher tensor
between steps (`parallel.ShardedWeights`); a step gathers them whole at its
start and frees them at its end, so during a step a rank holds the whole
weights plus its shards (JAX's GSPMD gathers each weight where it is
used). JAX's `split=True` (two compiled programs) has no counterpart: an
eager step has no program to split.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..diffusion.schedule import NoiseSchedule
from ..diffusion.solver import TrainSolver
from ..models.lora import (
    call_with_lora, call_with_state, compute_dtypes, init_lora, lora_modules, merged_state_dict)
from ..parallel import Mesh, ShardedWeights, all_reduce_mean
from . import losses as L

Lora = Dict[str, Dict[str, torch.Tensor]]
# Under fsdp > 1 the step splits base and teacher tensors of at least this
# many elements (`parallel.param_sharding`'s rule); smaller ones stay whole.
FSDP_MIN_SIZE = 2**16


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
    # Apply the adapters lazily per layer (models.lora.call_with_lora)
    # instead of merging them into a copy of the weights in every step; the
    # same function up to rounding, without a merged copy per student or the
    # merge's full-size weight gradients.
    lazy_lora: bool = False
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
    mesh: Optional[Mesh] = None,
):
    """Build the train step.

    `unet` supplies the architecture and, through the dtypes of its own
    tensors, the compute dtype of every weight (`cast_compute_weights`);
    `base` is the frozen state dict the adapters merge into (fp32, or bf16
    to halve its memory) and `teacher` the teacher's; both stay unchanged.
    Both are cast to the compute dtype once, here; a tensor already in it is
    used as it is, and with `lazy_lora` a tensor that is both base and
    teacher is cast once, so passing the UNet's own state dict for both
    holds no copy.

    Returned signature:
      step_fn(state, batch, generator=None, draws=None) -> (new_state, metrics)
    batch: dict with
      latents: (B, h, w, 4) clean VAE latents (already scaled),
      context: (B, 77, D) prompt embeddings,
      uncond_context: (B, 77, D) (used only when not embed_guidance),
      noise: (B, h, w, 4), optional,
      added_cond: SDXL's {"text_embeds": (B, P), "time_ids": (B, 6)},
        required by a UNet config with `addition_embed_dim`.
    `generator` (on the batch's device) draws the noise (unless the batch
    has it), the guidance scales and the four losses' timestep indices, in
    that order; `draws` may give any of them instead, under the keys
    "noise", "w", "reverse_index", "reverse_preserve_index",
    "forward_index", "forward_preserve_index". `state` is not
    modified; metrics are 0-dim tensors on the device (ints for the skip
    counters).

    With `mesh`, `batch` holds this rank's rows (B = the global batch /
    `mesh.rows`), while `generator` and `draws` are at the global batch, the
    same on every rank; the metrics are the global batch's. Under
    `mesh.fsdp > 1` the step keeps only shards of `base` and `teacher`
    (`step_fn.weights`, a `parallel.ShardedWeights` splitting tensors of at
    least `FSDP_MIN_SIZE` elements; `step_fn.gather()` gives both whole),
    and the caller may free its own copies. `step_fn.resident_bytes()` is
    what the step holds of them between steps; during a step a rank holds
    them whole besides its shards. A mesh with sp or tp > 1 is refused (the
    step over tp waits for ROADMAP item 17d).
    """
    if mesh is not None and (mesh.sp > 1 or mesh.tp > 1):
        raise NotImplementedError("the train step runs over dp and fsdp; sp and tp training "
                                  "wait for ROADMAP item 17d")
    dtypes = compute_dtypes(unet)
    casts: Dict[tuple, torch.Tensor] = {}

    def compute_copy(key: str, t: torch.Tensor) -> torch.Tensor:
        ident = (t.data_ptr(), t.dtype, tuple(t.shape), dtypes[key])
        if ident not in casts:
            casts[ident] = t.detach().to(dtypes[key])
        return casts[ident]

    teacher = {key: compute_copy(key, t) for key, t in teacher.items()}
    if cfg.lazy_lora:
        base = {key: compute_copy(key, t) for key, t in base.items()}
    else:
        base = {key: t.detach() for key, t in base.items()}
    store = None
    if mesh is not None and mesh.fsdp > 1:
        store = ShardedWeights([base, teacher], mesh, FSDP_MIN_SIZE)
        base = teacher = None
        casts.clear()
    scale = cfg.lora_alpha / cfg.lora_rank

    def gather():
        """(base, teacher), whole."""
        return tuple(store.gather()) if store is not None else (base, teacher)

    def apply_of(weights: Dict[str, torch.Tensor], context: torch.Tensor, added: Optional[Dict],
                 lora: Optional[Lora] = None, targets=None, remat: bool = False):
        """The denoiser on `weights` (+ `lora`'s low-rank paths, lazily)."""
        def apply(x, t, w_emb):
            if lora is None:
                return call_with_state(unet, weights, x, t, context, w_cond=w_emb,
                                       added_cond=added)
            return call_with_lora(unet, weights, lora, scale, x, t, context, w_cond=w_emb,
                                  added_cond=added, targets=targets)
        if not remat:
            return apply
        return lambda x, t, w_emb: checkpoint(
            apply, x, t, w_emb, use_reentrant=False, preserve_rng_state=False)

    def merged(base: Dict[str, torch.Tensor], lora: Lora) -> Dict[str, torch.Tensor]:
        return merged_state_dict(
            base, lora, alpha=cfg.lora_alpha, rank=cfg.lora_rank, dtypes=dtypes)

    def in_compute_dtype(lora: Lora) -> Lora:
        return {key: {n: t.to(dtypes[key]) for n, t in ab.items()} for key, ab in lora.items()}

    def detached(lora: Lora) -> Lora:
        return {key: {n: t.detach() for n, t in ab.items()} for key, ab in lora.items()}

    rows, row = (mesh.rows, mesh.row) if mesh is not None else (1, 0)

    def global_draws(draws: Dict, batch: Dict, generator) -> Dict:
        """This rank's rows of the draws at the global batch (`rows` times
        the rank's): those not given are drawn in the order the step uses
        them (noise unless the batch has it, w, then the losses' indices in
        the order the losses run)."""
        x = batch["latents"]
        b, device = x.shape[0], x.device
        gb = b * rows
        out = dict(draws)
        gdev = generator.device if generator is not None else device
        if "noise" not in out and batch.get("noise") is None:
            out["noise"] = torch.randn((gb,) + tuple(x.shape[1:]), generator=generator,
                                       device=gdev, dtype=x.dtype).to(device)
        if "w" not in out:
            out["w"] = sample_w(generator, gb, cfg, device)
        n_ep = solver.forward_endpoints.shape[0]
        for name, high, used in (
                ("reverse_index", cfg.loss.num_ddim_timesteps, cfg.use_reverse_cd),
                ("reverse_preserve_index", n_ep, cfg.use_reverse_preserve),
                ("forward_index", cfg.loss.num_ddim_timesteps - 1, cfg.use_forward_cd),
                ("forward_preserve_index", n_ep, cfg.use_forward_preserve)):
            if used and name not in out:
                out[name] = L.draw_index(generator, high, gb, device)
        return {k: v[row * b:(row + 1) * b] for k, v in out.items()}

    def step_fn(state: ICDTrainState, batch: Dict, generator=None, draws: Optional[Dict] = None):
        draws = global_draws(draws or {}, batch, generator)
        latents = batch["latents"].permute(0, 3, 1, 2)  # the UNet runs NCHW
        device = latents.device
        base, teacher = gather()
        context = batch["context"]
        uncond_context = batch.get("uncond_context", context)
        added = batch.get("added_cond")
        # the unconditional teacher call sees zeroed pooled embeds
        # (reference train_icd_xl_lora.py:900-903)
        added_u = None if added is None else dict(
            added, text_embeds=torch.zeros_like(added["text_embeds"]))
        noise = draws.get("noise", batch.get("noise")).permute(0, 3, 1, 2)
        w = draws["w"]

        # leaves of this step's two graphs; the state's own tensors stay plain
        lora_r = _like(state.lora_reverse,
                       [t.detach().requires_grad_(True) for t in _flat(state.lora_reverse)])
        lora_f = _like(state.lora_forward,
                       [t.detach().requires_grad_(True) for t in _flat(state.lora_forward)])
        if cfg.lazy_lora:
            # the adapters ride the base weights' calls, cast to their
            # layers' compute dtype once a step (JAX casts them in every
            # call); the frozen counterpart the other objective sees is the
            # same pre-step adapters, detached
            targets = lora_modules(unet, lora_r)
            lora_rc, lora_fc = in_compute_dtype(lora_r), in_compute_dtype(lora_f)
            student_r = apply_of(base, context, added, lora_rc, targets, cfg.remat)
            student_f = apply_of(base, context, added, lora_fc, targets, cfg.remat)
            frozen_r = apply_of(base, context, added, detached(lora_rc), targets)
            frozen_f = apply_of(base, context, added, detached(lora_fc), targets)
        else:
            # Each student is merged once; the frozen counterpart the other
            # objective sees is the same pre-step tensors, detached.
            merged_r, merged_f = merged(base, lora_r), merged(base, lora_f)
            student_r = apply_of(merged_r, context, added, remat=cfg.remat)
            student_f = apply_of(merged_f, context, added, remat=cfg.remat)
            frozen_r = apply_of({k: t.detach() for k, t in merged_r.items()}, context, added)
            frozen_f = apply_of({k: t.detach() for k, t in merged_f.items()}, context, added)
        teacher_apply = apply_of(teacher, context, added)
        uncond_apply = apply_of(teacher, uncond_context, added_u)

        def as_loss_apply(apply):
            return lambda params, x, t, w_emb: apply(x, t, w_emb)

        common = (solver, schedule, cfg.loss)
        metrics: Dict = {}

        def update(name, total, logs, lora, lora_state, opt_state):
            grads = _like(lora, all_reduce_mean(torch.autograd.grad(total, _flat(lora)), mesh))
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
                    uncond_apply=as_loss_apply(uncond_apply), index=draws["reverse_index"],
                )
                total = total + loss
                logs.update(lg)
            if cfg.use_reverse_preserve:
                loss, lg = L.reverse_preserve_loss(
                    as_loss_apply(frozen_f), None, as_loss_apply(student_r), None,
                    latents, noise, generator, *common,
                    endpoint_index=draws["reverse_preserve_index"],
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
                    uncond_apply=as_loss_apply(uncond_apply), index=draws["forward_index"],
                )
                total = total + loss
                logs.update(lg)
            if cfg.use_forward_preserve:
                loss, lg = L.forward_preserve_loss(
                    as_loss_apply(student_f), None, as_loss_apply(frozen_r), None,
                    latents, noise, generator, *common,
                    endpoint_index=draws["forward_preserve_index"],
                )
                total = total + cfg.loss.forward_preserve_coef * loss
                logs.update(lg)
            new_lora_f, new_opt_f = update(
                "forward", total, logs, lora_f, state.lora_forward, state.opt_forward)

        losses = [k for k in metrics if k.endswith("_loss")]
        metrics.update(zip(losses, all_reduce_mean([metrics[k] for k in losses], mesh)))
        new_state = ICDTrainState(
            step=state.step + 1,
            lora_reverse=new_lora_r,
            lora_forward=new_lora_f,
            opt_reverse=new_opt_r,
            opt_forward=new_opt_f,
        )
        return new_state, metrics

    def resident_bytes() -> int:
        """Bytes of base and teacher weights the step holds between steps
        (a tensor both hold counts once)."""
        if store is not None:
            return store.resident_bytes()
        held = {(t.data_ptr(), t.dtype): t.numel() * t.element_size()
                for d in (base, teacher) for t in d.values()}
        return sum(held.values())

    step_fn.weights = store
    step_fn.gather = gather
    step_fn.resident_bytes = resident_bytes
    return step_fn
