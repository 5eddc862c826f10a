"""Text-to-image generation entry point of the PyTorch port.

    python -m invertible_cd_tpu_torch.cli.generate --model sd15 \\
        --prompt "a photo of a corgi on the beach" --prompt "a red fox" --out runs/gen
    python -m invertible_cd_tpu_torch.cli.generate --model tiny --device cpu \\
        --prompt "a cat" --out runs/tiny

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
a row does not depend on the batch around it. Not ported yet: `--quantize`,
host striding over several processes, and `--calc_metrics` with the scorer
weights flags.
"""
from __future__ import annotations

import argparse
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
from ..pipelines.pipeline import InvertibleCD, UNET_KEYS, load_512, resolve_device, to_uint8

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
    add_weights_args(p)
    argv = apply_config_file(p, argv)
    return p.parse_args(argv)


def add_grid_args(p):
    """The consistency grid's endpoints (`build_pipeline`)."""
    p.add_argument("--reverse_timesteps", type=int, nargs="*", default=None,
                   help="default: 259 519 779 999 (SD1.5) / 249 499 699 999 (SDXL)")
    p.add_argument("--forward_timesteps", type=int, nargs="*", default=None,
                   help="default: 19 259 519 779 (SD1.5) / 19 249 499 699 (SDXL)")


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
    `--num_ddim_steps`, `--reverse_timesteps` and `--forward_timesteps`."""
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
        return pipe
    params = _load_weights(args) or None
    if args.model == "sdxl":
        return InvertibleCDXL.sdxl(params=params, grid=grid, dtype=dtype, device=device)
    return InvertibleCD.sd15(params=params, grid=grid, dtype=dtype, device=device)


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
    real_images/ + generated_images/ pairs and reconstruction_metrics.json."""
    rows = load_benchmark(args.benchmark, kind="generation", max_count=args.max_cnt,
                          with_files=True)
    pix = pipe.latent_size[0] * 2 ** (len(pipe.vae.cfg.block_out_channels) - 1)
    real_dir = os.path.join(args.out, "real_images")
    rec_dir = os.path.join(args.out, "generated_images")
    os.makedirs(real_dir, exist_ok=True)
    os.makedirs(rec_dir, exist_ok=True)
    n_done = 0
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
        for j, (real, rec) in enumerate(zip(reals, to_uint8(imgs))):
            save_image(real, os.path.join(real_dir, f"{i + j:06d}.jpg"))
            save_image(rec, os.path.join(rec_dir, f"{i + j:06d}.jpg"))
        n_done += len(batch)
        print(f"[{n_done}/{len(rows)}] reconstructed")
    summary = {"n_images": n_done}
    with open(os.path.join(args.out, "reconstruction_metrics.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print("reconstruction:", summary)


def main(argv=None, _pipe=None):
    """Generate; `_pipe` (a bundle) replaces the one the flags would build."""
    args = parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    pipe = _pipe if _pipe is not None else build_pipeline(args)
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
    print(f"saved {len(saved)} images to {args.out}")
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump({"prompts": prompts, "files": saved}, f, indent=2)


if __name__ == "__main__":
    main()
