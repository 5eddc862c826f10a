"""iCD LoRA training entry point of the PyTorch port.

    python -m invertible_cd_tpu_torch.cli.train_icd --model sd15 \\
        --synthetic_data --batch_size 2 --max_steps 3 --output_dir runs/smoke
    python -m invertible_cd_tpu_torch.cli.train_icd --model sdxl --lazy_lora --remat \\
        --resolution 1024 --data_root images/ --batch_size 2 --output_dir runs/xl

Counterpart of `cli/train_icd.py`: one step trains both students (reverse +
forward LoRA) with all four losses; metrics go to
`<output_dir>/logs/metrics.jsonl`; checkpoints rotate under
`<output_dir>/checkpoints`, and every checkpoint also writes both students'
adapters in kohya's format under `<output_dir>/export_<step>/`. It runs on
the CUDA device unless `--device cpu` is given. The UNet (base = teacher) is
seeded from `--seed`. Batches are seeded random latents and contexts with
`--synthetic_data`, or images and captions from
`--data_root` (`<root>/<data_subset>.csv`), encoded per batch by the VAE and
the text encoder(s) of a pipeline built from `--vae_checkpoint` /
`--text_checkpoint` or, without them, seeded. JAX's `--split_step` has no
counterpart (an eager step has no program to split); `--fsdp`, validation
panels, FID and `--base_params` wait for later slices.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from . import apply_config_file
from ..diffusion.schedule import make_schedule
from ..diffusion.solver import make_train_solver
from ..models.clip import CLIPTextConfig, CLIPTextModel
from ..models.layers import cast_compute_weights, fan_in_init_
from ..models.unet2d import UNet2DCondition, UNetConfig
from ..models.vae import AutoencoderKL, VAEConfig
from ..pipelines.loading import load_bundle_params
from ..pipelines.pipeline import InvertibleCD, resolve_device
from ..pipelines.sdxl import InvertibleCDXL
from ..training import LossConfig, TrainConfig, init_train_state, make_train_step
from ..training.checkpoint import (
    export_inference, latest_step, restore_checkpoint, save_checkpoint)
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
    p.add_argument("--discrete_w", default="0,7,11,15,19")
    p.add_argument("--checkpointing_steps", type=int, default=500)
    p.add_argument("--checkpoints_total_limit", type=int, default=5)
    p.add_argument("--resume_from_checkpoint", default=None, help='"latest" or a step number')
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--seed", type=int, default=0)
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
    weights in the compute dtype (bf16; fp32 for the tiny model), seeded
    from --seed on `device`, and the base state dict the adapters apply to:
    with --lazy_lora the UNet's own tensors (base and teacher are one set of
    weights), else an fp32 copy (bf16 with --bf16_params)."""
    cfg = unet_config(args.model)
    latent, dtype = (8, torch.float32) if args.model == "tiny" else (
        args.resolution // 8, torch.bfloat16)
    with torch.device(device):
        unet = UNet2DCondition(cfg)
    fan_in_init_(unet, torch.Generator(device=device).manual_seed(args.seed))
    store = torch.bfloat16 if args.bf16_params else torch.float32
    base = None if args.lazy_lora else {
        k: v.detach().to(store, copy=True) for k, v in unet.state_dict().items()}
    cast_compute_weights(unet, dtype).eval().requires_grad_(False)
    return unet, cfg, unet.state_dict() if base is None else base, latent


def build_encoder_pipe(args, device):
    """The VAE and text encoder(s) of --model, without UNets, for the
    --data_root path: `InvertibleCD` (SD1.5, the tiny bundle) or
    `InvertibleCDXL` (SDXL: ViT-L + bigG, fp32 VAE) at --resolution, from
    --vae_checkpoint / --text_checkpoint where given, the rest seeded from
    --seed + 2 (ViT-L, bigG, VAE in that order)."""
    if args.model == "tiny":
        from ..testing import tiny_bundle

        return tiny_bundle(None, device=device)
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
        return InvertibleCDXL.sdxl(params=params, device=device, latent_size=lat,
                                   default_resolution=args.resolution)
    return InvertibleCD.sd15(params=params, device=device, latent_size=lat)


def batch_iterator(args, cfg, latent_size, device, start: int = 0, pipe=None):
    """Training batches on `device`. Synthetic (--synthetic_data):
    unit-normal latents (B, h, w, 4) and contexts at scale 0.1, batch i from
    seed `seed * 100003 + i`, beginning with batch `start` (a resumed run
    goes on where the saved one stopped); an SDXL config adds
    `added_cond` (pooled text embeds at scale 0.1 and time ids [r, r, 0, 0,
    r, r] at r = --resolution). Real data: `make_train_iterator` over
    --data_root (rank 0 of 1, seeded; a resumed run starts the image stream
    anew, as the JAX CLI does), each batch's pixels encoded by `pipe`'s VAE
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
                yield batch
                i += 1
        return synth()

    from ..data.dataset import ImageCaptionDataset, make_train_iterator

    ds = ImageCaptionDataset(args.data_root, args.data_subset, args.resolution)
    raw = make_train_iterator(ds, args.batch_size, rank=0, num_replicas=1, seed=args.seed)
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
    device = resolve_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    logger = MetricLogger(os.path.join(args.output_dir, "logs"))
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
        print(f"resumed from step {state.step}")
    teacher = base if args.lazy_lora else unet.state_dict()
    step_fn = make_train_step(unet, base, teacher, solver, schedule, tcfg)
    pipe = None if args.synthetic_data else build_encoder_pipe(args, device)
    data = batch_iterator(args, cfg, latent_size, device, start=state.step, pipe=pipe)

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
            print(f"step {i + 1}: " + " ".join(f"{k}={v:.5f}" for k, v in sorted(last.items())))
        if (i + 1) % args.checkpointing_steps == 0 or final:
            save_checkpoint(ckpt_dir, state, keep=args.checkpoints_total_limit)
            export_inference(os.path.join(args.output_dir, f"export_{i + 1}"), state,
                             lora_alpha=tcfg.lora_alpha)
    logger.close()
    print("done")
    return last


if __name__ == "__main__":
    main()
