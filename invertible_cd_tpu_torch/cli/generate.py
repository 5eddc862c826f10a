"""Text-to-image generation entry point of the PyTorch port.

    python -m invertible_cd_tpu_torch.cli.generate --model sd15 \\
        --prompt "a photo of a corgi on the beach" --prompt "a red fox" --out runs/gen
    python -m invertible_cd_tpu_torch.cli.generate --model tiny --device cpu \\
        --prompt "a cat" --out runs/tiny
    python -m invertible_cd_tpu_torch.cli.generate --model tiny --device cpu \\
        --quantize int8_static --prompt "a cat" --out runs/tiny_int8

Counterpart of `cli/generate.py`: few-step consistency generation (reverse
CD), the 50-step DDIM teacher baseline (`--ddim_baseline`), benchmark CSV
sweeps (`--benchmark`, `--max_cnt`), and the invert/reconstruct mode
(`--image_root`: forward-CD inversion, or the 50-step DDIM inversion with
`--no-cons_inversion`, then generation from the inverted latent). Images
are written as JPEG files, `manifest.json` lists the prompts and files.

It runs on the CUDA device unless `--device cpu` is given (bf16 on the card,
fp32 on the CPU). Without checkpoint files the bundle has seeded synthetic
weights (seed 0); with them, the files must give the text encoder(s), the
VAE and the UNet (`pipelines.loading.load_bundle_params`). A batch runs at
its own size (the last one of a sweep is not padded): its rows share one
start latent drawn from `--seed + i` (i: the index of its first prompt), so
a row does not depend on the batch around it.

`--calc_metrics` scores with the scorer weights flags (`metrics.scores.
evaluators_from_weights`, on the same device, fp32): per batch the CLIP
image-text score and ImageReward of the images against their prompts, and
the FID of all images against `--fid_stats` with `--inception_weights`,
written to `metrics.json` under the JAX CLI's keys (None for a scorer whose
weights are not given); in the invert/reconstruct mode the inversion bundle
(DINOv2, PSNR, LPIPS) and recon-FID go to `reconstruction_metrics.json`.
A config file's `resolution`, `w_embed_dim`, `start_timestep`, `lora_rank`
and `lora_alpha` are flags too (`add_model_args`): they describe the model,
and each one given is checked against the bundle (`check_model_args`), which
they do not change. `--quantize int8|int8_vae|int8_static` runs the UNet
and/or the VAE in int8 (`pipelines.pipeline.QUANT_MODES`, kernel Q1 on the
card); `int8_static` first calibrates the bundle once
(`collect_quant_stats`). Not ported yet: host striding over several
processes.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

from . import apply_config_file
from ..data import load_benchmark
from ..diffusion.solver import make_solver_grid
from ..pipelines import sampler as S
from ..pipelines.pipeline import (
    QUANT_MODES, InvertibleCD, UNET_KEYS, load_512, resolve_device, to_uint8)

# grids of the released checkpoints: SD1.5, and iCD-SDXL (reference running/sdxl/README.md:4)
TIMESTEPS = {"sdxl": ([249, 499, 699, 999], [19, 249, 499, 699]),
             "sd15": ([259, 519, 779, 999], [19, 259, 519, 779])}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default=None, help="JSON config with flag defaults (configs/*.json)")
    p.add_argument("--model", default="sd15", choices=["sd15", "sdxl", "tiny"])
    p.add_argument("--prompt", action="append", default=None)
    p.add_argument("--benchmark", default=None, help="generation CSV (file_name, caption)")
    p.add_argument("--max_cnt", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--seed", type=int, default=150)
    p.add_argument("--guidance_scale", type=float, default=19.0)
    p.add_argument("--dynamic_guidance", action=argparse.BooleanOptionalAction, default=True,
                   help="--no-dynamic_guidance gives static CFG")
    p.add_argument("--tau1", type=float, default=0.8)
    p.add_argument("--tau2", type=float, default=0.8)
    add_grid_args(p)
    p.add_argument("--ddim_baseline", action="store_true",
                   help="50-step DDIM with the teacher instead of reverse CD")
    p.add_argument("--image_root", default=None,
                   help="real images for the generation CSV -> invert/reconstruct mode: saves "
                        "real_images/ + generated_images/ reconstruction pairs")
    p.add_argument("--cons_inversion", action=argparse.BooleanOptionalAction, default=True,
                   help="forward-CD inversion; --no-cons_inversion = 50-step DDIM inversion")
    p.add_argument("--inv_guidance_scale", type=float, default=0.0,
                   help="CFG scale during inversion")
    p.add_argument("--num_ddim_steps", type=int, default=50, help="DDIM grid size")
    add_quantize_arg(p)
    add_weights_args(p)
    add_model_args(p)
    p.add_argument("--calc_metrics", action="store_true")
    add_scorer_args(p)
    argv = apply_config_file(p, argv)
    return p.parse_args(argv)


def add_model_args(p):
    """The model keys of `configs/sd15_*.json` / `sdxl_*.json` (JAX's parsers
    drop them): facts of the bundle, not settings. Each one given is held
    against the bundle `build_pipeline` made (`check_model_args`)."""
    p.add_argument("--resolution", type=int, default=None,
                   help="the bundle's image side in pixels (512 SD1.5, 1024 SDXL, 32 tiny)")
    p.add_argument("--w_embed_dim", type=int, default=None,
                   help="the UNet's guidance-embedding width")
    p.add_argument("--start_timestep", type=int, default=None,
                   help="the timestep the forward chain starts from (the grid's: 19)")
    p.add_argument("--lora_rank", type=int, default=None,
                   help="the adapters' rank; checked against the seeded adapters' (a kohya "
                        "file carries its own)")
    p.add_argument("--lora_alpha", type=float, default=None,
                   help="the adapters' alpha; checked as --lora_rank is")


# (rank, alpha) of the seeded adapters: `pipeline.build_modules` at the
# constructors' `lora_rank` (`InvertibleCD.sd15`/`InvertibleCDXL.sdxl` 64,
# `testing.tiny_bundle` 4) and `models.lora.merge_lora`'s alpha
SEEDED_LORA = {"sd15": (64, 8.0), "sdxl": (64, 8.0), "tiny": (4, 8.0)}


def check_model_args(args, pipe) -> None:
    """Stop unless each model key given (`add_model_args`) is the bundle's."""
    pix = pipe.latent_size[0] * 2 ** (len(pipe.vae.cfg.block_out_channels) - 1)
    have = {"resolution": pix, "w_embed_dim": pipe.w_embed_dim,
            "start_timestep": int(pipe.grid.start_timestep)}
    if not (getattr(args, "reverse_lora", None) or getattr(args, "forward_lora", None)):
        have["lora_rank"], have["lora_alpha"] = SEEDED_LORA[args.model]
    for key, value in have.items():
        want = getattr(args, key, None)
        if want is not None and want != value:
            raise SystemExit(f"--{key} {want}: the {args.model} bundle's is {value}")


def add_scorer_args(p):
    """Scorer checkpoint flags (the torch artifacts the reference downloads
    through transformers / torch-hub / piq / image_reward,
    `utils/metrics.py:139-321`). A missing file leaves its metric None."""
    p.add_argument("--clip_vision_weights", default=None,
                   help="transformers CLIPVisionModel(WithProjection) state dict")
    p.add_argument("--clip_text_scorer_weights", default=None,
                   help="transformers CLIPTextModelWithProjection state dict")
    p.add_argument("--dino_weights", default=None, help="torch-hub dinov2_vitb14")
    p.add_argument("--vgg_weights", default=None, help="torchvision vgg16 features")
    p.add_argument("--lpips_heads_weights", default=None, help="LPIPS lin heads")
    p.add_argument("--image_reward_weights", default=None, help="ImageReward.pt")
    p.add_argument("--bert_vocab", default=None, help="BERT vocab.txt (ImageReward)")
    p.add_argument("--fid_stats", default=None,
                   help="reference-set FID stats npz with mu/sigma (the reference's "
                        "--path_to_fid_reference)")
    p.add_argument("--inception_weights", default=None,
                   help="pt_inception-2015-12-05 state dict (the FID variant)")


def build_evaluators(args, device):
    """The scorers of the flags on `device` (`evaluators_from_weights`; with
    `--model tiny`, checkpoints of the tiny scorer architectures)."""
    from ..metrics.scores import evaluators_from_weights

    return evaluators_from_weights(
        clip_vision_path=args.clip_vision_weights, clip_text_path=args.clip_text_scorer_weights,
        dino_path=args.dino_weights, vgg_path=args.vgg_weights,
        lpips_heads_path=args.lpips_heads_weights, image_reward_path=args.image_reward_weights,
        bert_vocab_path=args.bert_vocab, device=device, tiny=args.model == "tiny")


def build_fid_scorer(args, device):
    """The FID scorer of --inception_weights when --calc_metrics,
    --fid_stats and --inception_weights are given, else None."""
    if not (args.calc_metrics and args.fid_stats and args.inception_weights):
        return None
    from ..metrics import FIDScorer
    from ..models.convert import convert_inception_weights, load_torch_file

    return FIDScorer.from_state_dict(
        convert_inception_weights(load_torch_file(args.inception_weights)), device=device)


METRICS_NOTE = ("null metrics = scorer weights not provided; pass --clip_vision_weights/"
                "--clip_text_scorer_weights/--dino_weights/--vgg_weights/--lpips_heads_weights/"
                "--image_reward_weights/--bert_vocab to score with the reference protocol")


def mean_or_none(rows, key):
    """The mean of `key` over rows, or None if any row's is None."""
    vals = [r[key] for r in rows]
    return None if any(v is None for v in vals) else float(np.mean(vals))


def add_grid_args(p):
    """The consistency grid's endpoints (`build_pipeline`)."""
    p.add_argument("--reverse_timesteps", type=int, nargs="*", default=None,
                   help="default: 259 519 779 999 (SD1.5) / 249 499 699 999 (SDXL)")
    p.add_argument("--forward_timesteps", type=int, nargs="*", default=None,
                   help="default: 19 259 519 779 (SD1.5) / 19 249 499 699 (SDXL)")


def add_quantize_arg(p):
    """`--quantize` (the JAX CLIs' flag, same choices and default)."""
    p.add_argument("--quantize", default="off", choices=QUANT_MODES,
                   help="int8 inference (ops/quant.py, kernel Q1 on the card): int8 = UNet and "
                        "VAE, int8_vae = the VAE only, int8_static = int8 with calibrated conv "
                        "scales (runs collect_quant_stats once)")


def set_quantize(pipe, mode: str) -> None:
    """`pipe` in int8 mode `mode`; "int8_static" calibrates it first
    (`collect_quant_stats` with its defaults) unless it holds stats."""
    pipe.quantize = mode
    if mode == "int8_static" and not pipe.quant_stats:
        pipe.collect_quant_stats()


@contextlib.contextmanager
def quantized(pipe, mode: str):
    """`set_quantize(pipe, mode)` for the block; the pipe's previous mode
    is restored after it."""
    prev = pipe.quantize
    set_quantize(pipe, mode)
    try:
        yield pipe
    finally:
        pipe.quantize = prev


def add_weights_args(p):
    """Checkpoint file flags (`pipelines.loading.load_bundle_params`)."""
    p.add_argument("--reverse_lora", default=None, help="kohya safetensors")
    p.add_argument("--forward_lora", default=None)
    p.add_argument("--teacher_checkpoint", default=None)
    p.add_argument("--vae_checkpoint", default=None,
                   help="diffusers AutoencoderKL state dict (.pt/.safetensors)")
    p.add_argument("--text_checkpoint", default=None,
                   help="transformers CLIPTextModel state dict(s); for SDXL pass "
                        "'clip_l.safetensors,clip_bigg.safetensors'")


def build_pipeline(args):
    """The bundle the flags ask for, on `--device`, on the grid of
    `--num_ddim_steps`, `--reverse_timesteps` and `--forward_timesteps`, in
    the int8 mode of `--quantize` (`set_quantize`: "int8_static" calibrates
    once, on the loaded weights)."""
    from ..pipelines.sdxl import InvertibleCDXL
    from ..testing import tiny_bundle

    device = resolve_device(args.device)
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    rev, fwd = TIMESTEPS["sdxl" if args.model == "sdxl" else "sd15"]
    grid = make_solver_grid(
        n_steps=getattr(args, "num_ddim_steps", 50),
        reverse_timesteps=args.reverse_timesteps or rev,
        forward_timesteps=args.forward_timesteps or fwd,
    )
    if args.model == "tiny":
        # bf16 on the card: the tiny VAE's d = 32 head takes kernel B1, which is bf16 only
        pipe = tiny_bundle(None, dtype=dtype, device=device)
        pipe.grid = grid
    else:
        params = _load_weights(args) or None
        build = InvertibleCDXL.sdxl if args.model == "sdxl" else InvertibleCD.sd15
        pipe = build(params=params, grid=grid, dtype=dtype, device=device)
    check_model_args(args, pipe)
    set_quantize(pipe, getattr(args, "quantize", "off"))
    return pipe


def _load_weights(args) -> dict:
    """State dicts from the checkpoint flags ({} without any). A bundle is
    loaded whole: the text encoder(s) (SDXL: 'clip_l,clip_bigg'), the VAE
    and a UNet, or none of them (seeded weights)."""
    from ..pipelines.loading import load_bundle_params

    text = args.text_checkpoint.split(",") if args.text_checkpoint else []
    params = load_bundle_params(
        teacher=args.teacher_checkpoint, vae=args.vae_checkpoint,
        text=text[0] if text else None, text_2=text[1] if len(text) > 1 else None,
        reverse_lora=args.reverse_lora, forward_lora=args.forward_lora,
    )
    need = ["text", "vae"] + (["text_2"] if args.model == "sdxl" else [])
    missing = [k for k in need if k not in params] + (
        [] if any(k in params for k in UNET_KEYS) else ["a UNet"])
    if params and missing:
        raise SystemExit(f"the checkpoint flags give no {', '.join(missing)}: pass --teacher_checkpoint, "
                         "--vae_checkpoint and --text_checkpoint together, or none of them")
    return params


def save_image(image: np.ndarray, path: str) -> None:
    """(H, W, 3) uint8 to an image file (JPEG for a .jpg path), by PIL."""
    from PIL import Image

    Image.fromarray(image).save(path)


def _generator(pipe, seed: int) -> torch.Generator:
    return torch.Generator(device=pipe.device).manual_seed(seed)


def reconstruct_images(pipe, args, g):
    """Invert/reconstruct mode: invert each real benchmark image under its
    caption (forward CD at --inv_guidance_scale, its noise from `--seed + i`,
    or the 50-step DDIM inversion with --no-cons_inversion), regenerate
    from the inverted latent with the generation settings, and save
    real_images/ + generated_images/ pairs and reconstruction_metrics.json
    (with --calc_metrics: the inversion bundle's DINOv2, PSNR and LPIPS
    averaged over batches, and `recon_fid` against --fid_stats)."""
    rows = load_benchmark(args.benchmark, kind="generation", max_count=args.max_cnt,
                          with_files=True)
    pix = pipe.latent_size[0] * 2 ** (len(pipe.vae.cfg.block_out_channels) - 1)
    real_dir = os.path.join(args.out, "real_images")
    rec_dir = os.path.join(args.out, "generated_images")
    os.makedirs(real_dir, exist_ok=True)
    os.makedirs(rec_dir, exist_ok=True)
    evals = build_evaluators(args, pipe.device) if args.calc_metrics else None
    fid_scorer = build_fid_scorer(args, pipe.device)
    bundles, fid_images, n_done = [], [], 0
    for i in range(0, len(rows), args.batch_size):
        batch = rows[i:i + args.batch_size]
        caps = [caption for _, caption in batch]
        reals = np.stack([load_512(os.path.join(args.image_root, name), size=pix)
                          for name, _ in batch])
        if args.cons_inversion:
            inv_g = pipe.default_guidance(guidance_scale=args.inv_guidance_scale)
            lat, _ = pipe.invert(reals, caps, guidance=inv_g, generator=_generator(pipe, args.seed + i))
            imgs, _ = pipe.generate(caps, latent=lat, guidance=g)
        else:
            inv_g = S.GuidanceConfig(guidance_scale=args.inv_guidance_scale or 1.0, w_embed_dim=0)
            traj, _ = pipe.ddim_invert(reals, caps, guidance=inv_g)
            imgs, _ = pipe.ddim_generate(caps, latent=traj[-1])
        recs = to_uint8(imgs)
        for j, (real, rec) in enumerate(zip(reals, recs)):
            save_image(real, os.path.join(real_dir, f"{i + j:06d}.jpg"))
            save_image(rec, os.path.join(rec_dir, f"{i + j:06d}.jpg"))
        if fid_scorer is not None:
            fid_images.extend(list(recs))
        if evals is not None:
            bundles.append(evals.calc_inversion(reals.astype(np.float32) / 255.0,
                                                recs.astype(np.float32) / 255.0))
        n_done += len(batch)
        print(f"[{n_done}/{len(rows)}] reconstructed")
    summary = {"n_images": n_done}
    if bundles:
        summary.update({k: mean_or_none(bundles, k) for k in bundles[0]})
    if fid_images:
        summary["recon_fid"] = float(fid_scorer.fid(fid_images,
                                                    reference_stats_path=args.fid_stats))
    with open(os.path.join(args.out, "reconstruction_metrics.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print("reconstruction:", summary)


def main(argv=None, _pipe=None):
    """Generate; `_pipe` (a bundle) replaces the one the flags would build
    (in `--quantize`'s mode for the run, its own restored after)."""
    args = parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    pipe = _pipe if _pipe is not None else build_pipeline(args)
    with quantized(pipe, args.quantize):
        return run(args, pipe)


def run(args, pipe):
    """The generate CLI's work on a built bundle."""
    if args.benchmark:
        prompts = load_benchmark(args.benchmark, kind="generation", max_count=args.max_cnt)
    else:
        prompts = args.prompt or ["a photo of a corgi on the beach"]
    g = pipe.default_guidance(guidance_scale=args.guidance_scale,
                              dynamic_guidance=args.dynamic_guidance, tau1=args.tau1, tau2=args.tau2)
    if args.image_root is not None:
        if not args.benchmark:
            sys.exit("--image_root needs --benchmark (a generation CSV with file_name + caption "
                     "columns)")
        return reconstruct_images(pipe, args, g)

    evals = build_evaluators(args, pipe.device) if args.calc_metrics else None
    fid_scorer = build_fid_scorer(args, pipe.device)
    clip_scores, ir_scores, fid_images = [], [], []  # uint8 frames for FID stay on the host
    saved = []
    for i in range(0, len(prompts), args.batch_size):
        batch = prompts[i:i + args.batch_size]
        t0 = time.perf_counter()
        if args.ddim_baseline:
            imgs, _ = pipe.ddim_generate(batch, generator=_generator(pipe, args.seed + i))
        else:
            imgs, _ = pipe.generate(batch, generator=_generator(pipe, args.seed + i), guidance=g)
        images = to_uint8(imgs)  # waits for the device
        print(f"[{i + len(batch)}/{len(prompts)}] generated {len(batch)} in "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        for j, img in enumerate(images):
            path = os.path.join(args.out, f"{i + j:06d}.jpg")
            save_image(img, path)
            saved.append(path)
        if fid_scorer is not None:
            fid_images.extend(list(images))
        if evals is not None:
            # the reference's generation eval: CLIP image-text score and
            # ImageReward over the prompts (`generate.py:404-425`), per batch
            s = evals.clip_image_text(imgs, batch)
            if s is not None:
                clip_scores.extend([s] * len(batch))
            r = evals.image_reward(imgs, batch)
            if r is not None:
                ir_scores.extend([r] * len(batch))
    print(f"saved {len(saved)} images to {args.out}")
    if args.calc_metrics:
        metrics = {"clip_score": float(np.mean(clip_scores)) if clip_scores else None,
                   "image_reward": float(np.mean(ir_scores)) if ir_scores else None,
                   "n_images": len(saved)}
        if metrics["clip_score"] is None or metrics["image_reward"] is None:
            metrics["metrics_note"] = METRICS_NOTE
        if fid_images:
            metrics["fid"] = float(fid_scorer.fid(fid_images, reference_stats_path=args.fid_stats))
        with open(os.path.join(args.out, "metrics.json"), "w") as f:
            json.dump(metrics, f, indent=2)
        print("metrics:", metrics)
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump({"prompts": prompts, "files": saved}, f, indent=2)


if __name__ == "__main__":
    main()
