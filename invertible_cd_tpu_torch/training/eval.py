"""Eval during training: sampling twins, FID sweeps and the inversion round trip.

PyTorch counterpart of `invertible_cd_tpu/training/eval.py`, the twin of
reference `training/src/sampling.py` (C24), `reverse_eval.py` (C23) and
`forward_eval.py` (C26):

  grid_from_train_solver  the inference grid implied by the training endpoints
  reverse_sample          noise -> clean latent along that chain
  forward_sample          clean latent -> noise (guidance 0)
  sample_for_fid          a prompt sweep -> uint8 images for FID
  eval_inversion          forward + reverse round trip over a val set:
                          latent recon-MSE and, optionally, recon-FID
  fid_of_student          FID of the live reverse student
  student_unet            a UNet with a student's adapters, merged or lazy

Latents keep the JAX package's NHWC layout at these functions' edges.
JAX's `PRNGKey(seed + i)` / `PRNGKey(i)` become `torch.Generator`s seeded
`seed + i` / `i` on the pipeline's device; the draws differ from JAX's, so
the tests pass the latents in.

With a mesh (`parallel.make_mesh`), `sample_for_fid` and `eval_inversion`
stride their batches over the ranks (rank r takes batches r, r + n, ...,
each seeded as in one process) and gather the results on every rank in
batch order, as JAX's `process_allgather` gives every process the whole
set: the gathered images equal the one-process sweep's. JAX strides single
prompts and seeds a process's batches by their local index, so its
multi-process images are not its one-process ones, and its gather is in
process order; `eval_inversion` in JAX runs every chunk on every process.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..diffusion.schedule import NoiseSchedule
from ..diffusion.solver import SolverGrid, TrainSolver
from ..models.lora import (
    call_with_lora, call_with_state, compute_dtypes, lora_modules, merged_state_dict)
from ..parallel import all_gather_in_order, stride
from ..pipelines import sampler as S


def grid_from_train_solver(solver: TrainSolver, start_timestep: int = 19,
                           n_steps: int = 50) -> SolverGrid:
    """The inference (t, s) pairs implied by the training endpoints
    (reference `sampling.py:63-64`): reverse timesteps = the flipped forward
    endpoints, reverse boundaries = the flipped endpoints; the forward chain
    starts at `start_timestep`."""
    ep = solver.endpoints.cpu().numpy()
    fep = solver.forward_endpoints.cpu().numpy()
    fwd_t = ep.copy()
    fwd_t[0] = start_timestep
    return SolverGrid(
        reverse_timesteps=fep[::-1].copy(),
        reverse_boundaries=ep[::-1].copy(),
        forward_timesteps=fwd_t,
        forward_boundaries=fep.copy(),
        ddim_timesteps=solver.ddim_timesteps.cpu().numpy(),
        n_steps=n_steps,
        start_timestep=start_timestep,
    )


def _nchw(latent: torch.Tensor) -> torch.Tensor:
    return latent.permute(0, 3, 1, 2)


def _nhwc(latent: torch.Tensor) -> torch.Tensor:
    return latent.permute(0, 2, 3, 1).contiguous()


def reverse_sample(noise_model, latent_noise: torch.Tensor, context_uncond: torch.Tensor,
                   context_cond: torch.Tensor, grid: SolverGrid, schedule: NoiseSchedule,
                   guidance: S.GuidanceConfig) -> torch.Tensor:
    """Noise -> clean latent along the endpoint chain (C24); NHWC."""
    return _nhwc(S.cons_generation(noise_model, _nchw(latent_noise), context_uncond,
                                   context_cond, grid, schedule, guidance))


def forward_sample(noise_model, latent: torch.Tensor, noise: torch.Tensor,
                   context_uncond: torch.Tensor, context_cond: torch.Tensor, grid: SolverGrid,
                   schedule: NoiseSchedule, w_embed_dim: int = 0) -> torch.Tensor:
    """Clean latent -> noise at guidance 0 (the forward student trains at
    w = 0, reference train.py:227; C24); NHWC."""
    g = S.GuidanceConfig(guidance_scale=0.0, w_embed_dim=w_embed_dim)
    return _nhwc(S.cons_inversion(noise_model, _nchw(latent), _nchw(noise), context_uncond,
                                  context_cond, grid, schedule, g))


def to_uint8_truncated(images) -> np.ndarray:
    """float [0, 1] images -> uint8 by truncation, as JAX's eval does
    (`(clip(x, 0, 1) * 255).astype(uint8)`)."""
    if isinstance(images, torch.Tensor):
        images = images.detach().float().cpu().numpy()
    return (np.clip(np.asarray(images), 0, 1) * 255).astype(np.uint8)


def sample_for_fid(generate_fn: Callable[[Sequence[str], torch.Generator], object],
                   prompts: Sequence[str], batch_size: int, seed: int = 0,
                   max_count: Optional[int] = None, device="cuda", mesh=None) -> List[np.ndarray]:
    """A prompt sweep -> uint8 images for FID (C23 `distributed_sampling`).

    `generate_fn(batch_prompts, generator) -> (B, H, W, 3) float [0, 1]`;
    batch i (its first prompt's index) draws from a generator seeded
    `seed + i` on `device`. The last batch runs at its own size (JAX pads it
    to keep one compiled shape and drops the padded rows). With `mesh`, each
    rank runs its stride of the batches and every rank returns all images in
    prompt order."""
    prompts = list(prompts)[: max_count or len(prompts)]
    starts = list(range(0, len(prompts), batch_size))
    mine = {}
    for k in stride(len(starts), mesh):
        i = starts[k]
        gen = torch.Generator(device=device).manual_seed(seed + i)
        mine[i] = to_uint8_truncated(generate_fn(prompts[i:i + batch_size], gen))
    return [img for batch in all_gather_in_order(mine, mesh) for img in batch]


def eval_inversion(invert_fn: Callable, reconstruct_fn: Callable, val_latents: torch.Tensor,
                   batch_size: int = 8, decode_fn: Optional[Callable] = None, scorer=None,
                   reference_images=None, reference_stats_path: Optional[str] = None,
                   val_context: Optional[torch.Tensor] = None, mesh=None) -> Dict[str, float]:
    """Forward -> reverse round trip over a val set (C26 `eval_inversion`,
    forward_eval.py:259-342): the latent recon-MSE and, given `decode_fn`
    (NHWC latents -> float [0, 1] images) and a FID `scorer`, the FID of the
    decoded reconstructions against reference stats or images
    (`fid_score_cm`, forward_eval.py:296-341).

    `invert_fn(latents, generator[, context]) -> noise latents` and
    `reconstruct_fn(noise_latents, generator[, context]) -> latents`, NHWC;
    chunk i (its first row's index) gets a generator seeded i on the
    latents' device, shared by both calls. With `val_context` (one context
    per sample, sliced with the latents) both take the chunk's context.
    With `mesh`, each rank runs its stride of the chunks, and the per-sample
    errors and the reconstructions are gathered on every rank before the
    means and the FID."""
    starts = list(range(0, val_latents.shape[0], batch_size))
    mine = {}
    for k in stride(len(starts), mesh):
        i = starts[k]
        chunk = val_latents[i:i + batch_size]
        gen = torch.Generator(device=chunk.device).manual_seed(i)
        ctx = () if val_context is None else (val_context[i:i + batch_size],)
        rec = reconstruct_fn(invert_fn(chunk, gen, *ctx), gen, *ctx)
        mse = ((rec.float() - chunk.float()) ** 2).mean(dim=(1, 2, 3)).cpu().numpy()
        images = (to_uint8_truncated(decode_fn(rec))
                  if decode_fn is not None and scorer is not None else None)
        mine[i] = (mse, images)
    done = all_gather_in_order(mine, mesh)
    mses = [mse for mse, _ in done]
    recon_images = [img for _, images in done if images is not None for img in images]
    out = {"inversion_latent_mse": float(np.mean(np.concatenate(mses)))}
    if recon_images:
        out["inversion_fid"] = float(scorer.fid(recon_images, reference_images=reference_images,
                                                reference_stats_path=reference_stats_path))
    return out


class StudentUNet:
    """A UNet module called on other weights: `weights` in place of its own
    (`call_with_state`), plus, when `lora` is given, each adapter's low-rank
    path scaled by `scale` (`call_with_lora`). Callable as the module is,
    with its `cfg`, so a pipeline's `unets` may hold it."""

    def __init__(self, unet: torch.nn.Module, weights: Dict[str, torch.Tensor],
                 lora: Optional[Dict] = None, scale: float = 0.0):
        self.unet, self.weights, self.lora, self.scale = unet, weights, lora, scale
        self.cfg = unet.cfg
        self.targets = None if lora is None else lora_modules(unet, lora)

    def __call__(self, *args, **kwargs):
        if self.lora is None:
            return call_with_state(self.unet, self.weights, *args, **kwargs)
        return call_with_lora(self.unet, self.weights, self.lora, self.scale, *args,
                              targets=self.targets, **kwargs)


def student_unet(unet: torch.nn.Module, base: Dict[str, torch.Tensor], lora: Dict,
                 alpha: float = 8.0, lazy: bool = False) -> StudentUNet:
    """`unet` with `lora` on `base`, in the module's compute dtypes: merged
    into a copy of the adapted weights (the others shared with `base`), or
    with `lazy` applied per layer on `base` (no weight copy), as the train
    step does under `TrainConfig.lazy_lora`. The rank is the adapters'."""
    rank = next(iter(lora.values()))["down"].shape[0]
    dtypes = compute_dtypes(unet)
    with torch.no_grad():
        if not lazy:
            return StudentUNet(unet, merged_state_dict(base, lora, alpha=alpha, rank=rank,
                                                       dtypes=dtypes))
        weights = {k: t.detach().to(dtypes[k]) for k, t in base.items()}
        cast = {k: {n: t.detach().to(dtypes[k]) for n, t in ab.items()} for k, ab in lora.items()}
    return StudentUNet(unet, weights, cast, alpha / rank)


def fid_of_student(pipe, lora: Dict, scorer, prompts: Sequence[str], batch_size: int = 8,
                   seed: int = 0, lora_alpha: float = 8.0, reference_images=None,
                   reference_stats_path: Optional[str] = None, max_count: Optional[int] = None,
                   base: Optional[Dict[str, torch.Tensor]] = None, lazy: bool = False,
                   mesh=None) -> float:
    """FID of the live reverse student (reference `distributed_sampling` +
    `calculate_fid`, `train_icd_sd15_lora.py:1063-1082`): the adapters on
    `base` (default: the pipeline teacher's own weights) through the
    teacher module (`student_unet`) stand in for `pipe.unets["reverse"]`
    while the prompts are swept with `pipe.generate` at its default
    guidance (over the ranks of `mesh`, each rank scoring the gathered
    set), and the pipeline's own reverse UNet is put back afterwards, also
    on an error."""
    teacher = pipe.unets["teacher"]
    student = student_unet(teacher, teacher.state_dict() if base is None else base, lora,
                           alpha=lora_alpha, lazy=lazy)
    old = pipe.unets.get("reverse")
    pipe.unets["reverse"] = student
    try:
        def gen(batch, generator):
            return pipe.generate(list(batch), generator=generator)[0]

        images = sample_for_fid(gen, prompts, batch_size, seed, max_count, device=pipe.device,
                                mesh=mesh)
    finally:
        if old is None:
            del pipe.unets["reverse"]
        else:
            pipe.unets["reverse"] = old
    return scorer.fid(images, reference_images=reference_images,
                      reference_stats_path=reference_stats_path)
