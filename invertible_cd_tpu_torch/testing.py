"""Tiny bundles for tests: the real module code paths at miniature configs.

`tiny_configs()` and `tiny_configs_xl()` are the counterparts of the JAX
package's `invertible_cd_tpu.testing.tiny_bundle` and `tiny_bundle_xl`
configs, and `tiny_bundle` / `tiny_bundle_xl` build the PyTorch pipelines
from state dicts (for instance the JAX tiny bundles' params passed through
`models.convert.bundle_state_dicts_from_flax`).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .diffusion.solver import make_solver_grid
from .models.clip import CLIPTextConfig
from .models.unet2d import UNetConfig
from .models.vae import VAEConfig
from .pipelines.pipeline import InvertibleCD
from .pipelines.sdxl import InvertibleCDXL
from .utils.tokenizer import HashTokenizer


def tiny_configs() -> Tuple[UNetConfig, CLIPTextConfig, VAEConfig]:
    return UNetConfig.tiny(), CLIPTextConfig.tiny(), VAEConfig.tiny()


def tiny_bundle(
    state_dicts: Optional[Dict[str, Dict[str, torch.Tensor]]],
    latent_size: Tuple[int, int] = (16, 16),
    dtype=torch.float32,
    device="cpu",
) -> InvertibleCD:
    """A miniature InvertibleCD from state dicts keyed "text", "vae" and
    any of "teacher", "reverse", "forward", or, for None, from seeded
    weights (seed 0, rank-4 LoRAs; `InvertibleCD.sd15`). Pixels are 32x32
    (the tiny VAE downsamples 2x); the tokenizer is the hash tokenizer over
    the tiny CLIP vocabulary."""
    unet_cfg, clip_cfg, vae_cfg = tiny_configs()
    return InvertibleCD.sd15(
        params=state_dicts,
        lora_rank=4,
        tokenizer=HashTokenizer(vocab_size=clip_cfg.vocab_size),
        dtype=dtype,
        device=device,
        unet_cfg=unet_cfg,
        clip_cfg=clip_cfg,
        vae_cfg=vae_cfg,
        latent_size=latent_size,
    )


def tiny_configs_xl() -> Tuple[UNetConfig, CLIPTextConfig, CLIPTextConfig, VAEConfig]:
    """(UNet, text encoder 1, text encoder 2, VAE) of the JAX tiny SDXL
    bundle: SDXL's structure (no attention at level 0, transformer depth 2,
    linear projections, added conditioning from a 16-wide projected pooled
    embedding and 8-wide time-id features) at tiny widths."""
    unet_cfg = UNetConfig(
        block_out_channels=(32, 64),
        cross_attn_blocks=(False, True),
        layers_per_block=1,
        num_heads=(2, 2),
        transformer_depth=(1, 2),
        cross_attention_dim=64,
        use_linear_projection=True,
        time_cond_proj_dim=8,
        addition_embed_dim=16 + 6 * 8,
        addition_time_embed_dim=8,
    )
    clip2_cfg = CLIPTextConfig(
        vocab_size=1000, hidden_size=32, num_layers=2, num_heads=2,
        intermediate_size=64, projection_dim=16,
    )
    return unet_cfg, CLIPTextConfig.tiny(), clip2_cfg, VAEConfig.tiny()


def tiny_bundle_xl(
    state_dicts: Optional[Dict[str, Dict[str, torch.Tensor]]],
    latent_size: Tuple[int, int] = (16, 16),
    dtype=torch.float32,
    device="cpu",
) -> InvertibleCDXL:
    """A miniature InvertibleCDXL from state dicts keyed "text", "text_2",
    "vae" and any of "teacher", "reverse", "forward", or, for None, from
    seeded weights (seed 0, rank-4 LoRAs), with the JAX tiny bundle's
    settings: the VAE in `dtype` too, SD1.5's 4-hop grid, time ids at a
    32-pixel resolution, the hash tokenizer for both encoders."""
    unet_cfg, clip_cfg, clip2_cfg, vae_cfg = tiny_configs_xl()
    tok = HashTokenizer(vocab_size=clip_cfg.vocab_size)
    return InvertibleCDXL.sdxl(
        params=state_dicts, lora_rank=4, tokenizer=tok, tokenizer_2=tok, dtype=dtype, vae_dtype=dtype,
        device=device, unet_cfg=unet_cfg, clip_cfg=clip_cfg, clip2_cfg=clip2_cfg,
        vae_cfg=vae_cfg, latent_size=latent_size, default_resolution=32,
        grid=make_solver_grid(reverse_timesteps=[259, 519, 779, 999],
                              forward_timesteps=[19, 259, 519, 779]),
    )
