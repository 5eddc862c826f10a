"""Tiny bundles for tests: the real module code paths at miniature configs.

`tiny_configs()` are the counterparts of the JAX package's
`invertible_cd_tpu.testing.tiny_bundle` configs, and `tiny_bundle` builds
the PyTorch pipeline from state dicts (for instance the JAX tiny bundle's
params passed through `models.convert`).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .models.clip import CLIPTextConfig
from .models.unet2d import UNetConfig
from .models.vae import VAEConfig
from .pipelines.pipeline import InvertibleCD
from .utils.tokenizer import HashTokenizer


def tiny_configs() -> Tuple[UNetConfig, CLIPTextConfig, VAEConfig]:
    return UNetConfig.tiny(), CLIPTextConfig.tiny(), VAEConfig.tiny()


def tiny_bundle(
    state_dicts: Dict[str, Dict[str, torch.Tensor]],
    latent_size: Tuple[int, int] = (16, 16),
    dtype=torch.float32,
    device="cpu",
) -> InvertibleCD:
    """A miniature InvertibleCD from state dicts keyed "text", "vae" and
    any of "teacher", "reverse", "forward". Pixels are 32x32 (the tiny VAE
    downsamples 2x); the tokenizer is the hash tokenizer over the tiny
    CLIP vocabulary."""
    unet_cfg, clip_cfg, vae_cfg = tiny_configs()
    return InvertibleCD.sd15(
        params=state_dicts,
        tokenizer=HashTokenizer(vocab_size=clip_cfg.vocab_size),
        dtype=dtype,
        device=device,
        unet_cfg=unet_cfg,
        clip_cfg=clip_cfg,
        vae_cfg=vae_cfg,
        latent_size=latent_size,
    )
