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
rows of them. With a mesh (`parallel.make_mesh`) the step is the
one-process step on the concatenated batch, as JAX's is under GSPMD:

  * dp and fsdp: each rank of dp x fsdp is given its own rows of the batch
    and a generator seeded alike on every rank (or the draws at the global
    batch); the adapter gradients (before the clip and the non-finite
    guard) and the logged losses are averaged over those ranks (the
    "rows" group), so every rank applies the same update.
  * tp: the ranks of a tp group take the same rows and run a copy of the
    UNet split over the group (`parallel.tp`: this rank's heads of every
    attention block whose heads divide over tp, its features of every
    feed-forward), on this rank's slices of base and teacher (`tp_plan`),
    with the Megatron pair of reductions under autograd (`to_tp` on the
    split blocks' inputs, `from_tp` after their output projections). The
    adapters and both optimizer states stay whole on every rank, as JAX
    keeps them (its `init_train_state` is not sharded); a split layer's
    adapter enters the split module as this rank's slice of it. A split
    layer's adapter gradients are summed over the tp group (each rank holds
    its slice's part), but for `up` of a layer split on its in-features on
    the lazy path, which follows the low-rank partial's sum over tp and so
    is whole on each rank already; every other adapter's gradient is whole
    on each rank already (`to_tp`'s backward sums the split blocks' input
    gradients), so it takes no tp reduction. Then everything is averaged
    over the rows group, and the clip's global norm is read after both. An
    attention block whose heads do not divide over tp stays whole, as in
    serving, and its adapters take no tp reduction.
  * fsdp > 1: each rank holds only its 1/fsdp of the base and teacher
    tensors that `parallel.param_sharding` splits over fsdp, laid end to
    end unit by unit, between uses (`parallel.ShardedWeights`; a tensor tp
    splits keeps its tp slice whole, as `param_sharding` gives tp
    precedence). Every UNet call gathers one
    unit at a time (`models.lora.call_by_units`: each down, mid and up
    block, and each top-level layer) just before the unit runs, merges the
    adapters into it there (merged path), and drops it after; autograd
    keeps a reference in place of each gathered or merged weight, and the
    backward pass gathers (and merges) the unit again, one unit at a time.
    So no more than one unit's weights are whole at once, as JAX's GSPMD
    gathers each weight where it is used; the cost is a gather of every
    unit per UNet call and per backward pass.

sp training is refused: no JAX entry point trains over sp
(`latent_sharding` is used by inference only). JAX's `split=True` (two
compiled programs) has no counterpart: an eager step has no program to
split.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import itertools
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..diffusion.schedule import NoiseSchedule
from ..diffusion.solver import TrainSolver
from ..models.lora import (
    UnitCache, call_by_units, call_with_lora, call_with_state, compute_dtypes, init_lora,
    lora_hooks, lora_modules, merged_state_dict, module_units)
from ..parallel import Mesh, ShardedWeights, all_reduce_mean, all_reduce_sum
from ..parallel.tp import tensor_parallel, tp_plan, tp_slice, tp_slice_lora
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
    `mesh.rows`; the ranks of a tp group hold the same rows), while
    `generator` and `draws` are at the global batch, the same on every
    rank; the metrics are the global batch's, and every rank returns the
    same state. `unet`, `base` and `teacher` are whole on every rank: under
    `mesh.tp > 1` the step runs a split copy of `unet` (its structure only,
    on the meta device) on its own slices of `base` and `teacher`. Under
    `mesh.fsdp > 1` the step keeps only shards of `base` and `teacher`
    (`step_fn.weights`, a `parallel.ShardedWeights` splitting tensors of at
    least `FSDP_MIN_SIZE` elements; `step_fn.gather()` gives both whole
    over fsdp, at this rank's tp slices), and the caller may free its own
    copies; `step_fn.units` maps each gathering unit's prefix to its keys.
    `step_fn.resident_bytes()` is what the step holds of them between
    steps; during a step a rank holds besides them at most one unit's
    gathered (and merged) weights at a time. A mesh with sp > 1 is refused.
    """
    if mesh is not None and mesh.sp > 1:
        raise NotImplementedError(
            "the train step does not run over sp: no JAX entry point trains over sp "
            "(its latent_sharding is used by inference only); use dp, fsdp and tp")
    dtypes = compute_dtypes(unet)
    plan = tp_plan(unet, mesh) if mesh is not None else {}
    model = unet if not plan else tensor_parallel(_structure(unet), mesh)
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
    if plan:  # this rank's tp slices; a tensor both hold is sliced once
        sliced: Dict[tuple, torch.Tensor] = {}

        def tp_copy(key: str, t: torch.Tensor) -> torch.Tensor:
            ident = (t.data_ptr(), t.dtype, key)
            if ident not in sliced:
                sliced[ident] = tp_slice({key: t}, plan)[key]
            return sliced[ident]
        base = {key: tp_copy(key, t) for key, t in base.items()}
        teacher = {key: tp_copy(key, t) for key, t in teacher.items()}
        del sliced
    store, units = None, None
    if mesh is not None and mesh.fsdp > 1:
        units = {prefix: [k for k in dtypes if k.startswith(prefix + ".")]
                 for prefix in module_units(model)}
        if sum(map(len, units.values())) != len(dtypes):
            raise ValueError("the UNet has parameters outside its gathering units")
        store = ShardedWeights([base, teacher], mesh, FSDP_MIN_SIZE, units.values())
        base = teacher = None
    casts.clear()
    scale = cfg.lora_alpha / cfg.lora_rank

    def gather():
        """(base, teacher), whole over fsdp (this rank's tp slices)."""
        return tuple(store.gather()) if store is not None else (base, teacher)

    def merged(base: Dict[str, torch.Tensor], lora: Lora) -> Dict[str, torch.Tensor]:
        return merged_state_dict(
            base, lora, alpha=cfg.lora_alpha, rank=cfg.lora_rank, dtypes=dtypes)

    def in_compute_dtype(lora: Lora) -> Lora:
        return {key: {n: t.to(dtypes[key]) for n, t in ab.items()} for key, ab in lora.items()}

    def detached(lora: Lora) -> Lora:
        return {key: {n: t.detach() for n, t in ab.items()} for key, ab in lora.items()}

    def fetcher(which: int, lora: Optional[Lora] = None):
        """Under fsdp, a unit's tensors of base (0) or teacher (1),
        gathered, with `lora` merged in when given."""
        def fetch(prefix: str) -> Dict[str, torch.Tensor]:
            keys = units[prefix]
            weights = store.gather(keys, dicts=(which,))[0]
            if lora is None:
                return weights
            return merged(weights, {k: lora[k] for k in keys if k in lora})
        return fetch

    def reduce_grads(grads: List[torch.Tensor], lora: Lora) -> List[torch.Tensor]:
        """A split layer's adapter gradients summed over tp, then every
        gradient averaged over the rows (in that order on every rank). The
        lazy path sums a row-split layer's low-rank partial (x @ down^T)
        over tp before `up`, so `up`'s gradient there is whole already."""
        grads = list(grads)
        if plan:
            split = [i for i, (key, name) in enumerate((k, n) for k in lora for n in ("down", "up"))
                     if key in plan and not (cfg.lazy_lora and name == "up" and plan[key][0] == 1)]
            for i, g in zip(split, all_reduce_sum([grads[i] for i in split], mesh, "tp")):
                grads[i] = g
        return all_reduce_mean(grads, mesh)

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
        context = batch["context"]
        uncond_context = batch.get("uncond_context", context)
        added = batch.get("added_cond")
        # the unconditional teacher call sees zeroed pooled embeds
        # (reference train_icd_xl_lora.py:900-903)
        added_u = None if added is None else dict(
            added, text_embeds=torch.zeros_like(added["text_embeds"]))
        noise = draws.get("noise", batch.get("noise")).permute(0, 3, 1, 2)
        w = draws["w"]
        cache = UnitCache()  # under fsdp: the unit a backward pass gathered last

        def apply_of(weights, context: torch.Tensor, added: Optional[Dict],
                     lora: Optional[Lora] = None, remat: bool = False):
            """The denoiser on `weights` (a dict, or under fsdp a unit
            fetcher) + `lora`'s low-rank paths, lazily."""
            def apply(x, t, w_emb):
                kwargs = dict(w_cond=w_emb, added_cond=added)
                if store is not None:
                    hooks = contextlib.nullcontext() if lora is None else lora_hooks(
                        model, lora, scale, targets)
                    with hooks:
                        return call_by_units(model, weights, cache, x, t, context, **kwargs)
                if lora is None:
                    return call_with_state(model, weights, x, t, context, **kwargs)
                return call_with_lora(model, weights, lora, scale, x, t, context, targets=targets,
                                      **kwargs)
            if not remat:
                return apply
            return lambda x, t, w_emb: checkpoint(
                apply, x, t, w_emb, use_reentrant=False, preserve_rng_state=False)

        # leaves of this step's two graphs (whole adapters); the state's own
        # tensors stay plain
        lora_r = _like(state.lora_reverse,
                       [t.detach().requires_grad_(True) for t in _flat(state.lora_reverse)])
        lora_f = _like(state.lora_forward,
                       [t.detach().requires_grad_(True) for t in _flat(state.lora_forward)])
        targets = None
        if cfg.lazy_lora:
            # the adapters ride the base weights' calls, cast to their
            # layers' compute dtype once a step (JAX casts them in every
            # call), as this rank's tp slices; the frozen counterpart the
            # other objective sees is the same pre-step adapters, detached
            targets = lora_modules(model, lora_r)
            lora_rc = tp_slice_lora(in_compute_dtype(lora_r), plan)
            lora_fc = tp_slice_lora(in_compute_dtype(lora_f), plan)
            weights = fetcher(0) if store is not None else base
            student_r = apply_of(weights, context, added, lora_rc, cfg.remat)
            student_f = apply_of(weights, context, added, lora_fc, cfg.remat)
            frozen_r = apply_of(weights, context, added, detached(lora_rc))
            frozen_f = apply_of(weights, context, added, detached(lora_fc))
        elif store is not None:
            # each unit merged where it is gathered, in the forward and the
            # backward pass
            lora_rs, lora_fs = tp_slice_lora(lora_r, plan), tp_slice_lora(lora_f, plan)
            student_r = apply_of(fetcher(0, lora_rs), context, added, remat=cfg.remat)
            student_f = apply_of(fetcher(0, lora_fs), context, added, remat=cfg.remat)
            frozen_r = apply_of(fetcher(0, detached(lora_rs)), context, added)
            frozen_f = apply_of(fetcher(0, detached(lora_fs)), context, added)
        else:
            # Each student is merged once; the frozen counterpart the other
            # objective sees is the same pre-step tensors, detached.
            merged_r = merged(base, tp_slice_lora(lora_r, plan))
            merged_f = merged(base, tp_slice_lora(lora_f, plan))
            student_r = apply_of(merged_r, context, added, remat=cfg.remat)
            student_f = apply_of(merged_f, context, added, remat=cfg.remat)
            frozen_r = apply_of({k: t.detach() for k, t in merged_r.items()}, context, added)
            frozen_f = apply_of({k: t.detach() for k, t in merged_f.items()}, context, added)
        teacher_w = fetcher(1) if store is not None else teacher
        teacher_apply = apply_of(teacher_w, context, added)
        uncond_apply = apply_of(teacher_w, uncond_context, added_u)

        def as_loss_apply(apply):
            return lambda params, x, t, w_emb: apply(x, t, w_emb)

        common = (solver, schedule, cfg.loss)
        metrics: Dict = {}

        def update(name, total, logs, lora, lora_state, opt_state):
            grads = torch.autograd.grad(total, _flat(lora))
            cache.clear()
            grads = _like(lora, reduce_grads(grads, lora))
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
    step_fn.units = units
    step_fn.gather = gather
    step_fn.resident_bytes = resident_bytes
    return step_fn


def _structure(module: torch.nn.Module) -> torch.nn.Module:
    """A copy of `module` with every parameter and buffer on the meta
    device: its structure and dtypes, without weights (nor cached int8
    weight codes)."""
    memo = {}
    for t in itertools.chain(module.parameters(), module.buffers()):
        meta = torch.empty_like(t, device="meta")
        memo[id(t)] = torch.nn.Parameter(meta, t.requires_grad) if isinstance(
            t, torch.nn.Parameter) else meta
    for m in module.modules():
        codes = m.__dict__.get("_int8_weight_codes")
        if codes is not None:
            memo[id(codes)] = None
    return copy.deepcopy(module, memo)
