"""AutoencoderKL (SD VAE) in PyTorch — latent codec, NCHW, diffusers naming.

PyTorch counterpart of `invertible_cd_tpu/models/vae.py`. `encode_mean`
returns the posterior mean (never a sample); the 0.18215 / 0.13025 scaling
lives in the pipeline. The VAE computes in the dtype of its weights: bf16
for SD1.5, fp32 by default for SDXL (bf16 as an opt-in). The mid-block's
single-head attention goes through `fused_attention`: at the SD width
(d=512) that is kernel B2 on the card, in the bf16 or the fp32 build.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .attention import fused_attention
from .layers import Downsample2D, GroupNorm32, QConv2d, QLinear, ResnetBlock2D, Upsample2D


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    scaling_factor: float = 0.18215

    @staticmethod
    def sd() -> "VAEConfig":
        return VAEConfig()

    @staticmethod
    def sdxl() -> "VAEConfig":
        return VAEConfig(scaling_factor=0.13025)

    @staticmethod
    def tiny() -> "VAEConfig":
        return VAEConfig(block_out_channels=(32, 32), layers_per_block=1)


class VAEAttention(nn.Module):
    """Single-head self-attention over the bottleneck feature map."""

    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = GroupNorm32(channels, eps=1e-6)
        self.to_q = QLinear(channels, channels)
        self.to_k = QLinear(channels, channels)
        self.to_v = QLinear(channels, channels)
        self.to_out = nn.ModuleList([QLinear(channels, channels)])

    def forward(self, x):
        b, c, h, w = x.shape
        hidden = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q = self.to_q(hidden).view(b, h * w, 1, c)
        k = self.to_k(hidden).view(b, h * w, 1, c)
        v = self.to_v(hidden).view(b, h * w, 1, c)
        out = self.to_out[0](fused_attention(q, k, v).view(b, h * w, c))
        return out.reshape(b, h, w, c).permute(0, 3, 1, 2) + x


class DownEncoderBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int, add_downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(in_channels if i == 0 else out_channels, out_channels, eps=1e-6)
             for i in range(num_layers)]
        )
        self.downsamplers = nn.ModuleList([Downsample2D(out_channels)]) if add_downsample else None

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
        return x


class UpDecoderBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int, add_upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(in_channels if i == 0 else out_channels, out_channels, eps=1e-6)
             for i in range(num_layers)]
        )
        self.upsamplers = nn.ModuleList([Upsample2D(out_channels)]) if add_upsample else None

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class MidBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(channels, channels, eps=1e-6), ResnetBlock2D(channels, channels, eps=1e-6)]
        )
        self.attentions = nn.ModuleList([VAEAttention(channels)])

    def forward(self, x):
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chs = cfg.block_out_channels
        self.conv_in = QConv2d(cfg.in_channels, chs[0], 3, padding=1)
        self.down_blocks = nn.ModuleList(
            [DownEncoderBlock(chs[max(i - 1, 0)], ch, cfg.layers_per_block,
                              add_downsample=i < len(chs) - 1)
             for i, ch in enumerate(chs)]
        )
        self.mid_block = MidBlock(chs[-1])
        self.conv_norm_out = GroupNorm32(chs[-1], eps=1e-6)
        self.conv_out = QConv2d(chs[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chs = tuple(reversed(cfg.block_out_channels))
        self.conv_in = QConv2d(cfg.latent_channels, chs[0], 3, padding=1)
        self.mid_block = MidBlock(chs[0])
        self.up_blocks = nn.ModuleList(
            [UpDecoderBlock(chs[max(i - 1, 0)], ch, cfg.layers_per_block + 1,
                            add_upsample=i < len(chs) - 1)
             for i, ch in enumerate(chs)]
        )
        self.conv_norm_out = GroupNorm32(chs[-1], eps=1e-6)
        self.conv_out = QConv2d(chs[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    """VAE with `encode_mean` (posterior mean) and `decode` entry points.
    The compute dtype is that of the convolution weights."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = QConv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)
        self.post_quant_conv = QConv2d(cfg.latent_channels, cfg.latent_channels, 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.quant_conv.weight.dtype

    def encode_moments(self, pixels: torch.Tensor):
        """pixels (B,3,H,W) in [-1,1] -> (mean, logvar), each (B,4,H/8,W/8)."""
        moments = self.quant_conv(self.encoder(pixels.to(self.dtype)))
        mean, logvar = moments.chunk(2, dim=1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def encode_mean(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.encode_moments(pixels)[0]

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """latents (B,4,h,w), *unscaled* -> pixels (B,3,H,W) in [-1,1]-ish."""
        return self.decoder(self.post_quant_conv(latents.to(self.dtype)))
