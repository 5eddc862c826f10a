from .attention import AttnMeta
from .clip import CLIPTextConfig, CLIPTextModel
from .lora import (
    DEFAULT_TARGET_PATTERNS,
    find_lora_targets,
    init_lora,
    lora_delta,
    merge_lora,
)
from .unet2d import UNet2DCondition, UNetConfig, count_attention_layers
from .vae import AutoencoderKL, VAEConfig

__all__ = [
    "AttnMeta",
    "AutoencoderKL",
    "CLIPTextConfig",
    "CLIPTextModel",
    "DEFAULT_TARGET_PATTERNS",
    "UNet2DCondition",
    "UNetConfig",
    "VAEConfig",
    "count_attention_layers",
    "find_lora_targets",
    "init_lora",
    "lora_delta",
    "merge_lora",
]
