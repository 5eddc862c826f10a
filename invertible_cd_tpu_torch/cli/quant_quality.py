"""Fidelity cost of int8 inference in the PyTorch port: "off" against a
quantised mode, from the same seeds.

    python -m invertible_cd_tpu_torch.cli.quant_quality --quantize int8 --n 16 \\
        --teacher_checkpoint sd15.safetensors --vae_checkpoint vae.safetensors \\
        --text_checkpoint clip_l.safetensors --reverse_lora icd_reverse.safetensors \\
        --forward_lora icd_forward.safetensors --vgg_weights vgg16.pt --lpips_heads_weights lpips.pt
    python -m invertible_cd_tpu_torch.cli.quant_quality --model tiny --device cpu --n 2

Counterpart of `tools/quant_quality.py`: for N prompts it generates with
quantize="off" and with `--quantize` (int8, int8_vae or int8_static, which
calibrates first on the first batch's prompts) from the same seeds
(`--seed + i` for the batch starting at prompt i), and reports the PSNR
and, with `--vgg_weights` and `--lpips_heads_weights`, the LPIPS
(`metrics.scores`, the port's VGG16 + LPIPS heads) between the two sets;
then the same pair for an invert -> reconstruct round trip of the "off"
images (`invert` under "", then `generate` at w = 0 from the inverted
latent) under each mode, unless `--generate_only`. Prints one JSON line:

    {"quantize": "int8", "n": 16, "psnr_generate": ..., "lpips_generate": ...,
     "psnr_roundtrip": ..., "lpips_roundtrip": ...}

The bundle is `cli.generate.build_pipeline`'s (seeded synthetic weights
without checkpoint files), on `--device` (default cuda). With seeded weights
(`--model tiny`, or no checkpoints) this is a check of the mechanism; the
numbers mean something only on the published checkpoints and LPIPS weights.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .generate import add_weights_args, build_pipeline
from ..metrics.basic import psnr

PROMPTS = [
    "a photo of a corgi on the beach",
    "an oil painting of a lighthouse in a storm",
    "a bowl of ramen, studio lighting",
    "a red bicycle leaning on a brick wall",
    "an astronaut riding a horse on mars",
    "a macro photo of a dragonfly on a leaf",
    "a cozy cabin in snowy woods at dusk",
    "a street market in marrakesh",
]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--quantize", default="int8", choices=["int8", "int8_vae", "int8_static"])
    p.add_argument("--model", default="sd15", choices=["sd15", "tiny"])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--n", type=int, default=16, help="number of prompts")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--seed", type=int, default=150)
    p.add_argument("--benchmark", default=None, help="generation CSV for prompts (default: built-ins)")
    add_weights_args(p)
    p.add_argument("--vgg_weights", default=None)
    p.add_argument("--lpips_heads_weights", default=None)
    p.add_argument("--generate_only", action="store_true",
                   help="skip the invert -> reconstruct round trip")
    return p.parse_args(argv)


def main(argv=None, _pipe=None) -> dict:
    """Run the comparison and print its JSON line (also returned). `_pipe`
    (a bundle) replaces the one the flags would build; its own mode is
    restored after."""
    args = parse_args(argv)
    if _pipe is None:  # the bundle in "off": this tool sets each mode itself
        pipe = build_pipeline(argparse.Namespace(**{
            **vars(args), "quantize": "off", "reverse_timesteps": None, "forward_timesteps": None}))
    else:
        pipe = _pipe
    if args.benchmark:
        from ..data import load_benchmark

        prompts = load_benchmark(args.benchmark, kind="generation", max_count=args.n)
    else:
        prompts = (PROMPTS * (args.n // len(PROMPTS) + 1))[: args.n]
    lpips = None
    if args.vgg_weights and args.lpips_heads_weights:
        from ..metrics.scores import evaluators_from_weights

        lpips = evaluators_from_weights(vgg_path=args.vgg_weights,
                                        lpips_heads_path=args.lpips_heads_weights, device=pipe.device)
    t0 = time.monotonic()

    def stage(msg):
        print(f"[quant_quality +{time.monotonic() - t0:.0f}s] {msg}", file=sys.stderr, flush=True)

    def sweep(mode):
        pipe.quantize = mode
        out = []
        for i in range(0, len(prompts), args.batch_size):
            gen = torch.Generator(device=pipe.device).manual_seed(args.seed + i)
            imgs, _ = pipe.generate(prompts[i:i + args.batch_size], generator=gen)
            out.append(imgs.float().cpu().numpy())
        return np.concatenate(out)

    def roundtrip(mode, images01):
        pipe.quantize = mode
        out = []
        for i in range(0, images01.shape[0], args.batch_size):
            chunk = images01[i:i + args.batch_size] * 255.0
            inv, _ = pipe.invert(chunk, prompt="")
            imgs, _ = pipe.generate([""] * chunk.shape[0], latent=inv,
                                    guidance=pipe.default_guidance(guidance_scale=0.0))
            out.append(imgs.float().cpu().numpy())
        return np.concatenate(out)

    prev = pipe.quantize
    try:
        stage("generating the off set")
        ref = sweep("off")
        if args.quantize == "int8_static":
            stage("calibrating static scales")
            pipe.collect_quant_stats(prompts[: args.batch_size])
        stage(f"generating the {args.quantize} set")
        qnt = sweep(args.quantize)
        out = {"quantize": args.quantize, "n": len(prompts),
               "psnr_generate": psnr(ref * 255, qnt * 255)}
        if lpips is not None:
            out["lpips_generate"] = lpips.lpips_distance(ref, qnt)
        if not args.generate_only:
            stage("off invert -> reconstruct")
            rt_ref = roundtrip("off", ref)
            stage(f"{args.quantize} invert -> reconstruct")
            rt_qnt = roundtrip(args.quantize, ref)
            out["psnr_roundtrip"] = psnr(rt_ref * 255, rt_qnt * 255)
            if lpips is not None:
                out["lpips_roundtrip"] = lpips.lpips_distance(rt_ref, rt_qnt)
    finally:
        pipe.quantize = prev
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
