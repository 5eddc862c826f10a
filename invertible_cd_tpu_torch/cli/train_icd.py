"""iCD LoRA training entry point of the PyTorch port.

    python -m invertible_cd_tpu_torch.cli.train_icd --model sd15 \\
        --synthetic_data --batch_size 2 --max_steps 3 --output_dir runs/smoke
    python -m invertible_cd_tpu_torch.cli.train_icd --model sdxl --lazy_lora --remat \\
        --resolution 1024 --data_root images/ --batch_size 2 --output_dir runs/xl
    python -m invertible_cd_tpu_torch.cli.train_icd --model tiny --device cpu \\
        --synthetic_data --batch_size 2 --lora_rank 4 --max_steps 2 --validation_steps 2 \\
        --inversion_eval_steps 2 --inversion_eval_samples 4 --output_dir runs/tiny

Counterpart of `cli/train_icd.py`: one step trains both students (reverse +
forward LoRA) with all four losses; metrics go to
`<output_dir>/logs/metrics.jsonl`; checkpoints rotate under
`<output_dir>/checkpoints`, and every checkpoint also writes both students'
adapters in kohya's format under `<output_dir>/export_<step>/`. It runs on
the CUDA device unless `--device cpu` is given. The UNet (base = teacher) is
seeded from `--seed`, or read from `--base_params` (a diffusers state dict).
Batches are seeded random latents and contexts with `--synthetic_data`, or
images and captions from `--data_root` (`<root>/<data_subset>.csv`),
encoded per batch by the VAE and the text encoder(s) of a pipeline built
from `--vae_checkpoint` / `--text_checkpoint` or, without them, seeded.

Eval on cadence, on that pipeline with the live students (their adapters
merged into a copy of the adapted weights, or applied per layer with
`--lazy_lora`, as the step does), in the JAX CLI's order after a step:
`--evaluation_steps` (FID of the reverse student over `--fid_prompts`
against `--fid_stats`, with `--inception_weights`), `--inversion_eval_steps`
(forward + reverse round trip of `--inversion_eval_samples` val samples:
latent MSE, and recon-FID when the FID files are given), and
`--validation_steps` (image panels of the fixed validation prompts, and
with `--inversion_validation_samples` the inversion triptychs), sent to
TensorBoard when `torch.utils.tensorboard` imports and otherwise written as
PNGs under `<output_dir>/logs/samples/` (`utils.logging`). JAX's
`--split_step` has no counterpart (an eager step has no program to split).

Over several processes (`torchrun --nproc_per_node N -m
invertible_cd_tpu_torch.cli.train_icd ...`, one card each) the step is data
parallel (`training.make_train_step(..., mesh=)`): each rank takes
`--batch_size / N` rows (the synthetic stream makes the global batch from
its per-step seed and keeps the rank's rows; the image stream reads the
rank's stride of the data), and the adapter gradients are averaged. With
`--fsdp F` each rank also keeps only its shard of the frozen base and
teacher weights, gathering one UNet block at a time where it runs (in the
forward and again in the backward pass), and its rows still count: the
batch must divide over all N ranks (JAX asks only that it divide over dp =
N / F). JAX's train CLI has no `--tp`, and neither has this one
(`make_train_step` takes a tp mesh).
Rank 0 prints, logs and writes the checkpoints and exports; the eval runs
on every rank and gathers.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np
import torch

from . import apply_config_file
from ..diffusion.schedule import make_schedule
from ..diffusion.solver import make_train_solver
from ..models.clip import CLIPTextConfig, CLIPTextModel
from ..models.layers import cast_compute_weights, fan_in_init_
from ..models.unet2d import UNet2DCondition, UNetConfig
from ..models.vae import AutoencoderKL, VAEConfig
from ..parallel import initialize_distributed, is_main, local_device, make_mesh, shard_batch
from ..pipelines.loading import load_bundle_params
from ..pipelines.pipeline import InvertibleCD, resolve_device
from ..pipelines.sdxl import InvertibleCDXL
from ..training import LossConfig, TrainConfig, init_train_state, make_train_step
from ..training.checkpoint import (
    export_inference, latest_step, restore_checkpoint, save_checkpoint)
from ..training.eval import (
    eval_inversion, fid_of_student, forward_sample, grid_from_train_solver, reverse_sample,
    student_unet)
from ..utils.logging import MetricLogger

# (reverse, forward) endpoint grids by model: the reference's
# run_sd15_lora.sh and run_sdxl_lora.sh
ENDPOINTS = {"sd15": ("0,259,519,779", "259,519,779,999"),
             "sdxl": ("0,249,499,699", "249,499,699,999")}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default=None, help="JSON config with flag defaults (configs/*.json)")
    p.add_argument("--model", default="sd15", choices=["sd15", "sdxl", "tiny"])
    p.add_argument("--output_dir", required=True)
    p.add_argument("--base_params", default=None,
                   help="diffusers UNet state dict (.pt/.safetensors) with the base "
                        "(guidance-distilled teacher) weights; seeded when absent")
    p.add_argument("--data_root", default=None,
                   help="folder of images with <data_subset>.csv (file_name, caption)")
    p.add_argument("--data_subset", default="train")
    p.add_argument("--vae_checkpoint", default=None,
                   help="diffusers VAE state dict for --data_root (seeded when absent)")
    p.add_argument("--text_checkpoint", default=None,
                   help="transformers CLIP text state dict(s) for --data_root, comma-separated "
                        "(SDXL: ViT-L,bigG; seeded when absent)")
    p.add_argument("--synthetic_data", action="store_true",
                   help="random latents/contexts (no dataset)")
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--max_steps", type=int, default=6000)
    p.add_argument("--learning_rate", type=float, default=8e-6)
    p.add_argument("--lora_rank", type=int, default=64)
    p.add_argument("--loss_type", default="huber", choices=["huber", "l2"])
    p.add_argument("--huber_c", type=float, default=0.001)
    p.add_argument("--num_ddim_timesteps", type=int, default=50)
    p.add_argument("--endpoints", default=None,
                   help="default 0,259,519,779 (SD1.5) / 0,249,499,699 (SDXL)")
    p.add_argument("--forward_endpoints", default=None,
                   help="default 259,519,779,999 (SD1.5) / 249,499,699,999 (SDXL)")
    p.add_argument("--forward_preserve_coef", type=float, default=1.5)
    p.add_argument("--reverse_preserve_coef", type=float, default=1.5)
    p.add_argument("--no_forward_preserve", action="store_true")
    p.add_argument("--no_reverse_preserve", action="store_true")
    p.add_argument("--embed_guidance", action="store_true", default=True,
                   help="the students take the guidance scale as a w-embedding (always on, "
                        "as in the JAX CLI)")
    p.add_argument("--discrete_w", default="0,7,11,15,19")
    p.add_argument("--checkpointing_steps", type=int, default=500)
    p.add_argument("--checkpoints_total_limit", type=int, default=5)
    p.add_argument("--validation_steps", type=int, default=500,
                   help="validation image panels every N steps (0: never)")
    p.add_argument("--evaluation_steps", type=int, default=0,
                   help="FID eval of the reverse student every N steps (needs --fid_stats, "
                        "--fid_prompts and --inception_weights)")
    p.add_argument("--fid_stats", default=None,
                   help="npz with mu/sigma reference statistics "
                        "(the reference's fid_stats_mscoco256_val.npz)")
    p.add_argument("--fid_prompts", default=None, help="generation benchmark CSV for the FID sweep")
    p.add_argument("--fid_num_samples", type=int, default=5000)
    p.add_argument("--inception_weights", default=None,
                   help="pt_inception-2015-12-05 torch state dict")
    p.add_argument("--validation_prompts_max", type=int, default=13,
                   help="how many of the 13 validation prompts to render each validation step")
    p.add_argument("--validation_batch", type=int, default=4)
    p.add_argument("--validation_guidance", type=float, default=7.0)
    p.add_argument("--inversion_validation_samples", type=int, default=4,
                   help="triptych panels (decoded noise latent / original / reconstruction) "
                        "from the live forward + reverse students each validation step; 0 "
                        "disables (reference log_validation_inversion)")
    p.add_argument("--inversion_eval_steps", type=int, default=0,
                   help="forward-student eval (latent recon-MSE, and recon-FID when "
                        "--fid_stats and --inception_weights are given) every N steps")
    p.add_argument("--inversion_eval_samples", type=int, default=32)
    p.add_argument("--val_data_subset", default="val",
                   help="captions CSV subset of --data_root for the inversion eval and panels")
    p.add_argument("--resume_from_checkpoint", default=None, help='"latest" or a step number')
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fsdp", type=int, default=1,
                   help="shard the frozen base/teacher weights over this many of the ranks "
                        "(torchrun); the rows split over every rank")
    p.add_argument("--remat", action="store_true",
                   help="gradient checkpointing on the student UNets")
    p.add_argument("--bf16_params", action="store_true",
                   help="store the base weights in bf16 (halves their memory; "
                        "LoRA adapters and optimizer stay fp32)")
    p.add_argument("--lazy_lora", action="store_true",
                   help="apply the adapters per layer instead of merging them into a copy of "
                        "the weights every step (no merged copy, no full-size weight gradients; "
                        "the base is the UNet's own compute-dtype weights)")
    p.add_argument("--bf16_moments", action="store_true",
                   help="store Adam's first moment in bf16")
    p.add_argument("--skip_nonfinite", action="store_true",
                   help="skip optimizer updates whose gradients contain NaN/Inf instead "
                        "of poisoning the adapters; after 100 consecutive bad steps the "
                        "NaN surfaces")
    p.add_argument("--log_every", type=int, default=10)
    argv = apply_config_file(p, argv)
    args = p.parse_args(argv)
    reverse, forward = ENDPOINTS.get(args.model, ENDPOINTS["sd15"])
    args.endpoints = args.endpoints or reverse
    args.forward_endpoints = args.forward_endpoints or forward
    return args


def unet_config(model: str) -> UNetConfig:
    return {"tiny": UNetConfig.tiny, "sdxl": UNetConfig.sdxl, "sd15": UNetConfig.sd15}[model]()


def build_models(args, device):
    """(unet, cfg, base, latent_size): the UNet module holding the teacher
    weights in the compute dtype (bf16; fp32 for the tiny model), read from
    --base_params (a diffusers state dict, through
    `pipelines.loading.load_bundle_params`) or seeded from --seed, on
    `device`, and the base state dict the adapters apply to: with
    --lazy_lora the UNet's own tensors (base and teacher are one set of
    weights), else an fp32 copy (bf16 with --bf16_params)."""
    cfg = unet_config(args.model)
    latent, dtype = (8, torch.float32) if args.model == "tiny" else (
        args.resolution // 8, torch.bfloat16)
    with torch.device(device):
        unet = UNet2DCondition(cfg)
    if args.base_params:
        unet.load_state_dict(load_bundle_params(teacher=args.base_params)["teacher"])
    else:
        fan_in_init_(unet, torch.Generator(device=device).manual_seed(args.seed))
    store = torch.bfloat16 if args.bf16_params else torch.float32
    base = None if args.lazy_lora else {
        k: v.detach().to(store, copy=True) for k, v in unet.state_dict().items()}
    cast_compute_weights(unet, dtype).eval().requires_grad_(False)
    return unet, cfg, unet.state_dict() if base is None else base, latent


def build_encoder_pipe(args, device, unet=None):
    """The VAE and text encoder(s) of --model for the --data_root path and
    the eval, with `unet` (the training UNet, whose own weights are the
    teacher) as its "teacher": `InvertibleCD` (SD1.5, the tiny bundle) or
    `InvertibleCDXL` (SDXL: ViT-L + bigG, fp32 VAE) at --resolution, from
    --vae_checkpoint / --text_checkpoint where given, the rest seeded from
    --seed + 2 (ViT-L, bigG, VAE in that order)."""
    if args.model == "tiny":
        from ..testing import tiny_bundle

        pipe = tiny_bundle(None, device=device)
        if unet is not None:
            pipe.unets["teacher"] = unet
        return pipe
    xl = args.model == "sdxl"
    texts = {"text": CLIPTextConfig.vit_l()}
    if xl:
        texts["text_2"] = CLIPTextConfig.open_clip_big_g()
    gen = torch.Generator(device=device).manual_seed(args.seed + 2)
    with torch.device(device):
        modules = {name: CLIPTextModel(cfg) for name, cfg in texts.items()}
        modules["vae"] = AutoencoderKL(VAEConfig.sdxl() if xl else VAEConfig.sd())
    params = {name: fan_in_init_(m, gen).state_dict() for name, m in modules.items()}
    paths = args.text_checkpoint.split(",") if args.text_checkpoint else []
    params = load_bundle_params(vae=args.vae_checkpoint, text=paths[0] if paths else None,
                                text_2=paths[1] if len(paths) > 1 else None, params=params)
    lat = (args.resolution // 8,) * 2
    if xl:
        pipe = InvertibleCDXL.sdxl(params=params, device=device, latent_size=lat,
                                   default_resolution=args.resolution)
    else:
        pipe = InvertibleCD.sd15(params=params, device=device, latent_size=lat)
    if unet is not None:
        pipe.unets["teacher"] = unet
    return pipe


def batch_iterator(args, cfg, latent_size, device, start: int = 0, pipe=None, mesh=None):
    """This rank's rows of the training batches, on `device`. Synthetic
    (--synthetic_data): unit-normal latents (B, h, w, 4) and contexts at
    scale 0.1, global batch i from seed `seed * 100003 + i`, beginning with
    batch `start` (a resumed run goes on where the saved one stopped), the
    rank's rows kept (`parallel.shard_batch`); an SDXL config adds
    `added_cond` (pooled text embeds at scale 0.1 and time ids [r, r, 0, 0,
    r, r] at r = --resolution). Real data: `make_train_iterator` over
    --data_root (the rank's stride of the seeded index stream, B / ranks
    images a batch), its index stream started after the
    `start` batches a resumed run has already taken (the JAX CLI starts it
    anew, replaying the first images), each batch's pixels encoded by `pipe`'s VAE
    in chunks (4 images for SDXL, 32 for SD1.5) and its captions by
    `encode_prompt` (SD1.5) or `encode_prompt_xl` + `add_time_ids`
    (SDXL)."""
    r = float(args.resolution)
    if args.synthetic_data:
        def synth():
            gen = torch.Generator(device=device)
            i = start
            while True:
                gen.manual_seed(args.seed * 100003 + i)
                batch = {
                    "latents": torch.randn((args.batch_size, latent_size, latent_size, 4),
                                           generator=gen, device=device),
                    "context": 0.1 * torch.randn((args.batch_size, 77, cfg.cross_attention_dim),
                                                 generator=gen, device=device),
                }
                if cfg.addition_embed_dim is not None:
                    pooled = cfg.addition_embed_dim - 6 * cfg.addition_time_embed_dim
                    batch["added_cond"] = {
                        "text_embeds": 0.1 * torch.randn((args.batch_size, pooled),
                                                         generator=gen, device=device),
                        "time_ids": torch.tensor([[r, r, 0.0, 0.0, r, r]], device=device).repeat(
                            args.batch_size, 1),
                    }
                yield batch if mesh is None else shard_batch(batch, mesh)
                i += 1
        return synth()

    from ..data.dataset import ImageCaptionDataset, make_train_iterator

    ds = ImageCaptionDataset(args.data_root, args.data_subset, args.resolution)
    rows, row = (1, 0) if mesh is None else (mesh.rows, mesh.row)
    raw = make_train_iterator(ds, args.batch_size // rows, rank=row, num_replicas=rows,
                              seed=args.seed, start=start)
    xl = args.model == "sdxl"
    chunk = 4 if xl else 32

    def real():
        for imgs, caps in raw:
            pixels = torch.from_numpy(imgs).to(device)
            with torch.no_grad():
                latents = torch.cat([pipe._encode_image(pixels[i:i + chunk])
                                     for i in range(0, len(pixels), chunk)])
            # the encoders run in inference mode; clones are tensors a graph may save
            if xl:
                ctx, pooled = pipe.encode_prompt_xl(list(caps))
                batch = {"context": ctx.clone(), "added_cond": {
                    "text_embeds": pooled.clone(),
                    "time_ids": pipe.add_time_ids(len(caps), original_size=(r, r),
                                                  target_size=(r, r)).clone()}}
            else:
                batch = {"context": pipe.encode_prompt(list(caps))[1].clone()}
            batch["latents"] = latents.permute(0, 2, 3, 1)
            yield batch
    return real()


# The reference's fixed validation prompts (training/src/reverse_eval.py:129-143).
VALIDATION_PROMPTS = [
    "portrait photo of a girl, photograph, highly detailed face, depth of "
    "field, moody light, golden hour, style by Dan Winters, Russell James, "
    "Steve McCurry, centered, extremely detailed, Nikon D850, award winning "
    "photography",
    "Self-portrait oil painting, a beautiful cyborg with golden hair, 8k",
    "Astronaut in a jungle, cold color palette, muted colors, detailed, 8k",
    "A photo of beautiful mountain with realistic sunset and blue lake, "
    "highly detailed, masterpiece",
    "A sad puppy with large eyes",
    "A girl with pale blue hair and a cami tank top",
    "cute girl, Kyoto animation, 4k, high resolution",
    "A person laying on a surfboard holding his dog",
    "Green commercial building with refrigerator and refrigeration units "
    "outside",
    "An airplane with two propellor engines flying in the sky",
    "Four cows in a pen on a sunny day",
    "Three dogs sleeping together on an unmade bed",
    "a deer with bird feathers, highly detailed, full body",
]


class Eval:
    """The eval of the training loop (JAX CLI :359-565) on the encoder
    pipeline, whose "teacher" is the training UNet: the students are built
    from the live adapters on the training base (`student_unet`: merged, or
    lazy with --lazy_lora); the val batch and the FID scorer are made once."""

    def __init__(self, args, cfg, latent_size, unet, base, tcfg, solver, pipe_fn, mesh=None):
        self.args, self.cfg, self.latent_size = args, cfg, latent_size
        self.unet, self.base, self.tcfg, self.solver = unet, base, tcfg, solver
        self.grid = grid_from_train_solver(solver)
        self.pipe_fn, self.mesh = pipe_fn, mesh
        self._val, self._scorer = None, None

    def student(self, lora):
        return student_unet(self.unet, self.base, lora, alpha=self.tcfg.lora_alpha,
                            lazy=self.tcfg.lazy_lora)

    def scorer(self):
        if self._scorer is None:
            from ..metrics import FIDScorer
            from ..models.convert import convert_inception_weights, load_torch_file

            self._scorer = FIDScorer.from_state_dict(convert_inception_weights(
                load_torch_file(self.args.inception_weights)), device=self.unet_device)
        return self._scorer

    @property
    def unet_device(self) -> torch.device:
        return next(self.unet.parameters()).device

    def val_batch(self, n: int):
        """The first n samples of the val set, made once at the largest n
        asked for: encoded from --val_data_subset of --data_root (VAE and
        text encoder(s)), or seeded synthetic latents and contexts (seed
        --seed + 999)."""
        if self._val is None or self._val["latents"].shape[0] < n:
            self._val = collect_val_batch(self.args, self.cfg, self.latent_size, self.pipe_fn(), n,
                                          self.unet_device)
        return _slice(self._val, 0, n)

    # the round trip of JAX's `_roundtrip_fns`: both directions at guidance 0
    # on the training endpoints' grid (the reference evaluates unguided
    # processes, forward_eval.py:101-104,148-151); NHWC latents
    @torch.inference_mode()
    def invert(self, fwd, latents, noise, context, added=None):
        pipe = self.pipe_fn()
        return forward_sample(pipe._noise_model(fwd, added), latents, noise, context, context,
                              self.grid, pipe.schedule, pipe.w_embed_dim)

    @torch.inference_mode()
    def reconstruct(self, rev, noisy, context, added=None):
        pipe = self.pipe_fn()
        return reverse_sample(pipe._noise_model(rev, added), noisy, context, context, self.grid,
                              pipe.schedule, pipe.default_guidance(guidance_scale=0.0))

    @torch.inference_mode()
    def decode(self, latents):
        return self.pipe_fn()._decode_latents(latents.permute(0, 3, 1, 2))

    def fid(self, state) -> float:
        """FID of the live reverse student over --fid_prompts (reference
        trainer cadence, train_icd_sd15_lora.py:1063-1082; batch 8)."""
        from ..data import load_benchmark

        prompts = load_benchmark(self.args.fid_prompts, kind="generation",
                                 max_count=self.args.fid_num_samples)
        return fid_of_student(self.pipe_fn(), state.lora_reverse, self.scorer(), prompts,
                              batch_size=8, lora_alpha=self.tcfg.lora_alpha,
                              reference_stats_path=self.args.fid_stats, base=self.base,
                              lazy=self.tcfg.lazy_lora, mesh=self.mesh)

    def inversion(self, state) -> dict:
        """Latent recon-MSE of the round trip over the val set (chunks of at
        most 8), and recon-FID when --fid_stats and --inception_weights are
        given (reference train_icd_sd15_lora.py:1085-1096)."""
        args = self.args
        fwd, rev = self.student(state.lora_forward), self.student(state.lora_reverse)
        val = self.val_batch(args.inversion_eval_samples)
        size = min(8, val["latents"].shape[0])
        chunk_added = []  # SDXL: the chunk's added conditioning, taken in chunk order

        def invert_fn(chunk, gen, ctx):
            i = size * len(chunk_added)
            chunk_added.append(_slice(val["added_cond"], i, size) if "added_cond" in val else None)
            noise = torch.randn(chunk.shape, generator=gen, device=chunk.device, dtype=chunk.dtype)
            return self.invert(fwd, chunk, noise, ctx, chunk_added[-1])

        def reconstruct_fn(noisy, gen, ctx):
            return self.reconstruct(rev, noisy, ctx, chunk_added[-1])

        fid_on = bool(args.fid_stats and args.inception_weights)
        with torch.inference_mode():
            return eval_inversion(
                invert_fn, reconstruct_fn, val["latents"], batch_size=size,
                decode_fn=self.decode if fid_on else None, scorer=self.scorer() if fid_on else None,
                reference_stats_path=args.fid_stats,
                val_context=val["context"].to(val["latents"].dtype), mesh=self.mesh)

    def validation(self, logger, state, step: int) -> None:
        """Validation panels from the live reverse student (reference
        `log_validation`, reverse_eval.py:129-173): the fixed prompts, each at
        batch --validation_batch from seed 42 at --validation_guidance on the
        training endpoints' grid; logs `validation_image_std`."""
        args, pipe = self.args, self.pipe_fn()
        old_reverse, old_grid = pipe.unets.get("reverse"), pipe.grid
        pipe.unets["reverse"] = self.student(state.lora_reverse)
        pipe.grid = self.grid
        g = pipe.default_guidance(guidance_scale=args.validation_guidance)
        try:
            stds = []
            for prompt in VALIDATION_PROMPTS[: args.validation_prompts_max]:
                gen = torch.Generator(device=pipe.device).manual_seed(42)
                imgs, _ = pipe.generate([prompt] * args.validation_batch, generator=gen, guidance=g)
                imgs = imgs.float().cpu().numpy()
                logger.log_images(step, f"validation/{prompt[:48]}", imgs)
                stds.append(float(np.std(imgs)))
            if stds:  # --validation_prompts_max 0 renders nothing
                logger.log(step, {"validation_image_std": float(np.mean(stds))})
        finally:
            if old_reverse is None:
                del pipe.unets["reverse"]
            else:
                pipe.unets["reverse"] = old_reverse
            pipe.grid = old_grid

    def inversion_panels(self, logger, state, step: int) -> float:
        """Triptychs from the live students (reference
        `log_validation_inversion`, forward_eval.py:96-191): per val sample
        [decoded noise latent, original, reconstruction] from one round trip
        (noise from seed --seed); logs `inversion_panel_latent_mse`."""
        val = self.val_batch(self.args.inversion_validation_samples)
        lat = val["latents"]
        gen = torch.Generator(device=lat.device).manual_seed(self.args.seed)
        noise = torch.randn(lat.shape, generator=gen, device=lat.device, dtype=lat.dtype)
        ctx, added = val["context"].to(lat.dtype), val.get("added_cond")
        noisy = self.invert(self.student(state.lora_forward), lat, noise, ctx, added)
        recon = self.reconstruct(self.student(state.lora_reverse), noisy, ctx, added)
        panel = torch.stack([self.decode(noisy), self.decode(lat), self.decode(recon)], dim=1)
        panel = panel.float().cpu().numpy()  # (B, 3, H, W, C)
        for i in range(panel.shape[0]):
            logger.log_images(step, f"inversion/sample_{i}", panel[i])
        mse = float(((recon.float() - lat.float()) ** 2).mean())
        logger.log(step, {"inversion_panel_latent_mse": mse})
        return mse


def _slice(batch: dict, i: int, n: int) -> dict:
    return {k: _slice(v, i, n) if isinstance(v, dict) else v[i:i + n] for k, v in batch.items()}


def collect_val_batch(args, cfg, latent_size, pipe, n: int, device) -> dict:
    """n val samples {"latents" (n, h, w, 4), "context"[, "added_cond"]}:
    VAE / CLIP-encoded from --val_data_subset of --data_root, or seeded
    synthetic tensors (one generator seeded --seed + 999: latents, contexts
    at scale 0.1, then SDXL's pooled embeds) with --synthetic_data."""
    r = float(args.resolution)
    xl = cfg.addition_embed_dim is not None
    if args.synthetic_data or args.data_root is None:
        gen = torch.Generator(device=device).manual_seed(args.seed + 999)
        val = {"latents": torch.randn((n, latent_size, latent_size, 4), generator=gen,
                                      device=device),
               "context": 0.1 * torch.randn((n, 77, cfg.cross_attention_dim), generator=gen,
                                            device=device)}
        if xl:
            pooled = cfg.addition_embed_dim - 6 * cfg.addition_time_embed_dim
            val["added_cond"] = {
                "text_embeds": 0.1 * torch.randn((n, pooled), generator=gen, device=device),
                "time_ids": torch.tensor([[r, r, 0.0, 0.0, r, r]], device=device).repeat(n, 1)}
        return val
    from ..data.dataset import ImageCaptionDataset

    ds = ImageCaptionDataset(args.data_root, args.val_data_subset, args.resolution)
    imgs, caps = zip(*(ds[i] for i in range(min(n, len(ds)))))
    with torch.inference_mode():
        pixels = torch.from_numpy(np.stack(imgs)).to(device)
        latents = torch.cat([pipe._encode_image(pixels[i:i + 4]) for i in range(0, len(pixels), 4)])
        val = {"latents": latents.permute(0, 2, 3, 1).contiguous()}
        if xl:
            ctx, pooled = pipe.encode_prompt_xl(list(caps))
            val["context"] = ctx
            val["added_cond"] = {"text_embeds": pooled, "time_ids": pipe.add_time_ids(
                len(caps), original_size=(r, r), target_size=(r, r))}
        else:
            val["context"] = pipe.encode_prompt(list(caps))[1]
    return val


def train_config(args, cfg: UNetConfig) -> TrainConfig:
    return TrainConfig(
        learning_rate=args.learning_rate,
        lora_rank=args.lora_rank,
        remat=args.remat,
        lazy_lora=args.lazy_lora,
        bf16_moments=args.bf16_moments,
        skip_nonfinite=args.skip_nonfinite,
        discrete_w=tuple(float(w) for w in args.discrete_w.split(",")) or None,
        use_forward_preserve=not args.no_forward_preserve,
        use_reverse_preserve=not args.no_reverse_preserve,
        loss=LossConfig(
            num_ddim_timesteps=args.num_ddim_timesteps,
            loss_type=args.loss_type,
            huber_c=args.huber_c,
            embed_guidance=args.embed_guidance,
            w_embed_dim=cfg.time_cond_proj_dim or 0,
            forward_preserve_coef=args.forward_preserve_coef,
            reverse_preserve_coef=args.reverse_preserve_coef,
        ),
    )


def main(argv=None):
    """Train; returns the last step's metrics as floats (None if no step
    ran)."""
    args = parse_args(argv)
    if not (args.synthetic_data or args.data_root):
        raise SystemExit("train_icd: no data; pass --data_root (an image folder) or "
                         "--synthetic_data (seeded random latents and contexts)")
    initialize_distributed(device=args.device)
    mesh = make_mesh(fsdp=args.fsdp, device=torch.device(args.device).type)
    if args.batch_size % mesh.rows:
        raise SystemExit(
            f"--batch_size {args.batch_size} is not divisible by the {mesh.rows} ranks its rows "
            f"split over (dp={mesh.dp} x fsdp={mesh.fsdp}: under --fsdp the ranks that share "
            f"the weights take rows too). Pick a batch size that is a multiple of {mesh.rows}.")
    main_rank = is_main(mesh)
    say = print if main_rank else (lambda *a, **k: None)
    device = resolve_device(local_device(args.device))
    os.makedirs(args.output_dir, exist_ok=True)
    logger = MetricLogger(os.path.join(args.output_dir, "logs"), mesh)
    unet, cfg, base, latent_size = build_models(args, device)
    schedule = make_schedule(device=device)
    solver = make_train_solver(
        schedule.alphas_cumprod,
        num_ddim_timesteps=args.num_ddim_timesteps,
        num_endpoints=len(args.endpoints.split(",")),
        num_forward_endpoints=len(args.forward_endpoints.split(",")),
        endpoints=args.endpoints,
        forward_endpoints=args.forward_endpoints,
        device=device,
    )
    tcfg = train_config(args, cfg)
    ckpt_dir = os.path.join(args.output_dir, "checkpoints")

    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    state = init_train_state(gen, base, tcfg)
    if args.resume_from_checkpoint and latest_step(ckpt_dir) is not None:
        step = (None if args.resume_from_checkpoint == "latest"
                else int(args.resume_from_checkpoint))
        state = restore_checkpoint(ckpt_dir, state, step)
        say(f"resumed from step {state.step}")
    teacher = base if args.lazy_lora else unet.state_dict()
    step_fn = make_train_step(unet, base, teacher, solver, schedule, tcfg, mesh)
    if step_fn.weights is not None:
        # the step holds this rank's shards; the whole weights exist only
        # while a step or an eval runs
        del teacher
        base = None
        unet.to("meta")
    say(f"resident base weights: {step_fn.resident_bytes()} bytes per rank "
        f"(dp={mesh.dp}, fsdp={mesh.fsdp})")
    # the encoder pipeline (text encoder(s) + VAE, the training UNet as its
    # teacher) for real data and the eval, built once at first use
    pipes = []

    def encoder_pipe():
        if not pipes:
            pipes.append(build_encoder_pipe(args, device, unet))
        return pipes[0]

    data = batch_iterator(args, cfg, latent_size, device, start=state.step,
                          pipe=None if args.synthetic_data else encoder_pipe(), mesh=mesh)
    ev = Eval(args, cfg, latent_size, unet, base, tcfg, solver, encoder_pipe, mesh)
    fid_ready = bool(args.fid_stats and args.fid_prompts and args.inception_weights)

    @contextlib.contextmanager
    def whole_weights():
        """Under --fsdp, the base and the UNet's own (teacher) weights
        gathered for the eval, and freed after it."""
        if step_fn.weights is None:
            yield
            return
        ev.base, teacher_w = step_fn.gather()
        unet.load_state_dict(teacher_w, assign=True)
        try:
            yield
        finally:
            ev.base = None
            unet.to("meta")

    t0 = time.time()
    start = state.step
    last = None
    for i in range(start, args.max_steps):
        gen.manual_seed(args.seed * 7 + i)
        state, metrics = step_fn(state, next(data), gen)
        final = i + 1 == args.max_steps
        if (i + 1) % args.log_every == 0 or i == start or final:
            last = {k: float(v) for k, v in metrics.items()}  # waits for the device
            last["steps_per_sec"] = (i + 1 - start) / max(time.time() - t0, 1e-9)
            logger.log(i + 1, last, prefix="train/")
            say(f"step {i + 1}: " + " ".join(f"{k}={v:.5f}" for k, v in sorted(last.items())))
        fid_due = args.evaluation_steps and (i + 1) % args.evaluation_steps == 0 and fid_ready
        inversion_due = args.inversion_eval_steps and (i + 1) % args.inversion_eval_steps == 0
        panels_due = args.validation_steps and (i + 1) % args.validation_steps == 0
        if fid_due or inversion_due or panels_due:
            with whole_weights():
                if fid_due:
                    fid = ev.fid(state)
                    logger.log(i + 1, {"fid": fid}, prefix="eval/")
                    say(f"step {i + 1}: FID = {fid:.3f}")
                if inversion_due:
                    out = ev.inversion(state)
                    logger.log(i + 1, out, prefix="eval/")
                    say(f"step {i + 1}: " + " ".join(f"{k}={v:.5f}" for k, v in sorted(out.items())))
                if panels_due and main_rank:  # panels are rank 0's alone
                    ev.validation(logger, state, i + 1)
                    if args.inversion_validation_samples:
                        ev.inversion_panels(logger, state, i + 1)
        if (i + 1) % args.checkpointing_steps == 0 or final:
            save_checkpoint(ckpt_dir, state, keep=args.checkpoints_total_limit, mesh=mesh)
            export_inference(os.path.join(args.output_dir, f"export_{i + 1}"), state,
                             lora_alpha=tcfg.lora_alpha, mesh=mesh)
    logger.close()
    say("done")
    return last

if __name__ == "__main__":
    main()
