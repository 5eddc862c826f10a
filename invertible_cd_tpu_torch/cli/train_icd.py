"""iCD LoRA training entry point of the PyTorch port.

    python -m invertible_cd_tpu_torch.cli.train_icd --model sd15 \\
        --synthetic_data --batch_size 2 --max_steps 3 --output_dir runs/smoke

Counterpart of `cli/train_icd.py`: one step trains both students (reverse +
forward LoRA) with all four losses; metrics go to
`<output_dir>/logs/metrics.jsonl`; checkpoints rotate under
`<output_dir>/checkpoints`. It runs on the CUDA device unless `--device cpu`
is given. Without converted SD1.5 weights and an image-folder reader in this
package, only `--synthetic_data` is available: seeded full-width weights
(base = teacher) and seeded random latents and contexts.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from . import apply_config_file
from ..diffusion.schedule import make_schedule
from ..diffusion.solver import make_train_solver
from ..models.layers import cast_compute_weights, fan_in_init_
from ..models.unet2d import UNet2DCondition, UNetConfig
from ..pipelines.pipeline import resolve_device
from ..training import LossConfig, TrainConfig, init_train_state, make_train_step
from ..training.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from ..utils.logging import MetricLogger


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default=None, help="JSON config with flag defaults (configs/*.json)")
    p.add_argument("--model", default="sd15", choices=["sd15", "tiny"])
    p.add_argument("--output_dir", required=True)
    p.add_argument("--synthetic_data", action="store_true",
                   help="random latents/contexts and seeded weights (no dataset)")
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--max_steps", type=int, default=6000)
    p.add_argument("--learning_rate", type=float, default=8e-6)
    p.add_argument("--lora_rank", type=int, default=64)
    p.add_argument("--loss_type", default="huber", choices=["huber", "l2"])
    p.add_argument("--huber_c", type=float, default=0.001)
    p.add_argument("--num_ddim_timesteps", type=int, default=50)
    p.add_argument("--endpoints", default="0,259,519,779")
    p.add_argument("--forward_endpoints", default="259,519,779,999")
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
    p.add_argument("--bf16_moments", action="store_true",
                   help="store Adam's first moment in bf16")
    p.add_argument("--skip_nonfinite", action="store_true",
                   help="skip optimizer updates whose gradients contain NaN/Inf instead "
                        "of poisoning the adapters; after 100 consecutive bad steps the "
                        "NaN surfaces")
    p.add_argument("--log_every", type=int, default=10)
    argv = apply_config_file(p, argv)
    return p.parse_args(argv)


def build_models(args, device):
    """(unet, cfg, base, latent_size): the UNet module holding the teacher
    weights in the compute dtype (bf16; fp32 for the tiny model), and the
    base state dict in fp32 (bf16 with --bf16_params), both seeded from
    --seed on `device`. Base and teacher are the same weights."""
    if args.model == "tiny":
        cfg, latent, dtype = UNetConfig.tiny(), 8, torch.float32
    else:
        cfg, latent, dtype = UNetConfig.sd15(), args.resolution // 8, torch.bfloat16
    with torch.device(device):
        unet = UNet2DCondition(cfg)
    fan_in_init_(unet, torch.Generator(device=device).manual_seed(args.seed))
    store = torch.bfloat16 if args.bf16_params else torch.float32
    base = {k: v.detach().to(store, copy=True) for k, v in unet.state_dict().items()}
    cast_compute_weights(unet, dtype).eval().requires_grad_(False)
    return unet, cfg, base, latent


def batch_iterator(args, cfg, latent_size, device, start: int = 0):
    """Seeded synthetic batches: unit-normal latents (B, h, w, 4) and
    contexts at scale 0.1, batch i from seed `seed * 100003 + i`, beginning
    with batch `start` (a resumed run goes on where the saved one stopped)."""
    if not args.synthetic_data:
        raise SystemExit(
            "train_icd: real-data training needs converted VAE and CLIP weights and the "
            "image-folder reader, neither of which this package has yet; "
            "pass --synthetic_data")

    def synth():
        gen = torch.Generator(device=device)
        i = start
        while True:
            gen.manual_seed(args.seed * 100003 + i)
            yield {
                "latents": torch.randn((args.batch_size, latent_size, latent_size, 4),
                                       generator=gen, device=device),
                "context": 0.1 * torch.randn((args.batch_size, 77, cfg.cross_attention_dim),
                                             generator=gen, device=device),
            }
            i += 1
    return synth()


def train_config(args, cfg: UNetConfig) -> TrainConfig:
    return TrainConfig(
        learning_rate=args.learning_rate,
        lora_rank=args.lora_rank,
        remat=args.remat,
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
    device = resolve_device(args.device)
    batch_iterator(args, UNetConfig.tiny(), 8, device)  # stops here if the data is missing
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
    step_fn = make_train_step(unet, base, unet.state_dict(), solver, schedule, tcfg)
    data = batch_iterator(args, cfg, latent_size, device, start=state.step)

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
    logger.close()
    print("done")
    return last


if __name__ == "__main__":
    main()
