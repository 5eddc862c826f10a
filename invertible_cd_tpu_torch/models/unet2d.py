"""UNet2DCondition in PyTorch — the SD1.5 and SDXL denoiser, NCHW, diffusers naming.

PyTorch counterpart of `invertible_cd_tpu/models/unet2d.py`: epsilon
prediction conditioned on timestep + CLIP text context, with the iCD
guidance w-embedding on `cond_proj`, SDXL's added conditioning (pooled text
embeds + micro-conditioning time ids through `add_embedding`) and the
controller hook on every attention layer. One config-driven module family
serves SD1.5 (320/640/1280/1280, 8 heads, conv projections) and SDXL
(320/640/1280, 5/10/20 heads, transformer depths 1/2/10, linear projections).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import spatial
from .attention import AttnHook, Transformer2D
from .layers import (
    Downsample2D,
    GroupNorm32,
    QConv2d,
    ResnetBlock2D,
    TimestepEmbedding,
    Upsample2D,
    sinusoidal_timestep_embedding,
)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Static architecture description."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    # True where the down block at that level has cross-attention transformers.
    cross_attn_blocks: Tuple[bool, ...] = (True, True, True, False)
    layers_per_block: int = 2
    num_heads: Tuple[int, ...] = (8, 8, 8, 8)
    transformer_depth: Tuple[int, ...] = (1, 1, 1, 1)
    cross_attention_dim: int = 768
    use_linear_projection: bool = False
    time_cond_proj_dim: Optional[int] = None  # 512 for iCD w-embedding models
    # SDXL added conditioning: micro-conditioning time_ids + pooled text.
    addition_embed_dim: Optional[int] = None  # 2816 for SDXL
    addition_time_embed_dim: Optional[int] = None  # 256 for SDXL
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @staticmethod
    def sd15(w_embed_dim: Optional[int] = 512) -> "UNetConfig":
        return UNetConfig(time_cond_proj_dim=w_embed_dim)

    @staticmethod
    def sdxl(w_embed_dim: Optional[int] = 512) -> "UNetConfig":
        return UNetConfig(
            block_out_channels=(320, 640, 1280),
            cross_attn_blocks=(False, True, True),
            num_heads=(5, 10, 20),
            transformer_depth=(1, 2, 10),
            cross_attention_dim=2048,
            use_linear_projection=True,
            time_cond_proj_dim=w_embed_dim,
            addition_embed_dim=2816,
            addition_time_embed_dim=256,
        )

    @staticmethod
    def tiny(cross_attention_dim: int = 32, w_embed_dim: Optional[int] = 8) -> "UNetConfig":
        """Miniature config for tests."""
        return UNetConfig(
            block_out_channels=(32, 64),
            cross_attn_blocks=(True, False),
            layers_per_block=1,
            num_heads=(2, 2),
            transformer_depth=(1, 1),
            cross_attention_dim=cross_attention_dim,
            time_cond_proj_dim=w_embed_dim,
        )


def _transformer(cfg: UNetConfig, level: int, channels: int) -> Transformer2D:
    return Transformer2D(
        channels, cfg.num_heads[level], cfg.cross_attention_dim,
        depth=cfg.transformer_depth[level],
        use_linear_projection=cfg.use_linear_projection,
    )


class CrossAttnDownBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, level: int, in_channels: int, add_downsample: bool):
        super().__init__()
        out_ch = cfg.block_out_channels[level]
        self.resnets = nn.ModuleList()
        self.attentions = nn.ModuleList() if cfg.cross_attn_blocks[level] else None
        ch = in_channels
        for _ in range(cfg.layers_per_block):
            self.resnets.append(ResnetBlock2D(ch, out_ch, cfg.time_embed_dim))
            ch = out_ch
            if self.attentions is not None:
                self.attentions.append(_transformer(cfg, level, out_ch))
        self.downsamplers = nn.ModuleList([Downsample2D(out_ch)]) if add_downsample else None

    def forward(self, x, temb, context, layer_counter, hook):
        skips = []
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if self.attentions is not None:
                x = self.attentions[i](x, context, "down", layer_counter, hook)
            skips.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            skips.append(x)
        return x, skips


class UNetMidBlock(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        ch = cfg.block_out_channels[-1]
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(ch, ch, cfg.time_embed_dim), ResnetBlock2D(ch, ch, cfg.time_embed_dim)]
        )
        self.attentions = nn.ModuleList([_transformer(cfg, len(cfg.block_out_channels) - 1, ch)])

    def forward(self, x, temb, context, layer_counter, hook):
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x, context, "mid", layer_counter, hook)
        return self.resnets[1](x, temb)


class CrossAttnUpBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, level: int, in_channels: int, skip_channels,
                 add_upsample: bool):
        super().__init__()
        out_ch = cfg.block_out_channels[level]
        self.resnets = nn.ModuleList()
        self.attentions = nn.ModuleList() if cfg.cross_attn_blocks[level] else None
        ch = in_channels
        for i in range(cfg.layers_per_block + 1):
            self.resnets.append(ResnetBlock2D(ch + skip_channels[i], out_ch, cfg.time_embed_dim))
            ch = out_ch
            if self.attentions is not None:
                self.attentions.append(_transformer(cfg, level, out_ch))
        self.upsamplers = nn.ModuleList([Upsample2D(out_ch)]) if add_upsample else None

    def forward(self, x, skips, temb, context, layer_counter, hook):
        for i, resnet in enumerate(self.resnets):
            x = torch.cat([x, skips.pop()], dim=1)  # LIFO skips, [x, skip]
            x = resnet(x, temb)
            if self.attentions is not None:
                x = self.attentions[i](x, context, "up", layer_counter, hook)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class UNet2DCondition(nn.Module):
    """The full conditional UNet.

    forward args:
      sample: (B, C, H, W) noisy latents (NCHW).
      timesteps: (B,) int tensor or a python int.
      encoder_hidden_states: (B, S, cross_attention_dim) text context.
      w_cond: optional (B, time_cond_proj_dim) guidance embedding.
      added_cond: SDXL's {"text_embeds": (B, P), "time_ids": (B, 6)}; required
        when the config has `addition_embed_dim`.
      attn_hook: optional controller hook (see attention.AttnHook).
    Returns the (B, out_channels, H, W) epsilon prediction in fp32; the
    compute dtype is that of the convolution weights.

    Inside `parallel.spatial` `sample` holds this rank's rows of the
    latent's height and so does the result; the whole height must split
    into sp blocks whose rows halve at every downsampling level (checked
    before any collective). Skip connections concatenate channels, so they
    stay on the rank.
    """

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        c0 = cfg.block_out_channels[0]
        self.time_embedding = TimestepEmbedding(c0, cfg.time_embed_dim, cfg.time_cond_proj_dim)
        if cfg.addition_embed_dim is not None:
            self.add_embedding = TimestepEmbedding(cfg.addition_embed_dim, cfg.time_embed_dim)
        self.conv_in = QConv2d(cfg.in_channels, c0, 3, padding=1)

        n = len(cfg.block_out_channels)
        self.down_blocks = nn.ModuleList()
        ch = c0
        skip_chs = [c0]
        for level in range(n):
            self.down_blocks.append(
                CrossAttnDownBlock(cfg, level, ch, add_downsample=level < n - 1)
            )
            ch = cfg.block_out_channels[level]
            skip_chs.extend([ch] * cfg.layers_per_block)
            if level < n - 1:
                skip_chs.append(ch)
        self.mid_block = UNetMidBlock(cfg)
        self.up_blocks = nn.ModuleList()
        for i, level in enumerate(reversed(range(n))):
            skips_here = [skip_chs.pop() for _ in range(cfg.layers_per_block + 1)]
            self.up_blocks.append(
                CrossAttnUpBlock(cfg, level, ch, skips_here, add_upsample=i < n - 1)
            )
            ch = cfg.block_out_channels[level]
        self.conv_norm_out = GroupNorm32(c0, eps=1e-5)
        self.conv_out = QConv2d(c0, cfg.out_channels, 3, padding=1)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def forward(
        self,
        sample: torch.Tensor,
        timesteps,
        encoder_hidden_states: torch.Tensor,
        w_cond: Optional[torch.Tensor] = None,
        added_cond: Optional[dict] = None,
        attn_hook: Optional[AttnHook] = None,
    ) -> torch.Tensor:
        cfg = self.cfg
        dtype = self.dtype
        b = sample.shape[0]
        mesh = spatial.active()
        if mesh is not None:
            spatial.check_height(sample.shape[2] * mesh.sp, mesh.sp, len(cfg.block_out_channels))
        timesteps = torch.as_tensor(timesteps, device=sample.device).expand(b)

        t_feat = sinusoidal_timestep_embedding(
            timesteps, cfg.block_out_channels[0],
            flip_sin_to_cos=cfg.flip_sin_to_cos, downscale_freq_shift=cfg.freq_shift,
            dtype=dtype,
        )
        temb = self.time_embedding(t_feat, w_cond.to(dtype) if w_cond is not None else None)
        if cfg.addition_embed_dim is not None:
            if added_cond is None:
                raise ValueError("this UNet config needs added_cond (text_embeds, time_ids)")
            tid_emb = sinusoidal_timestep_embedding(
                added_cond["time_ids"].reshape(-1), cfg.addition_time_embed_dim,
                flip_sin_to_cos=cfg.flip_sin_to_cos, downscale_freq_shift=cfg.freq_shift,
                dtype=dtype,
            ).reshape(b, -1)
            add_feat = torch.cat([added_cond["text_embeds"].to(dtype), tid_emb], dim=-1)
            temb = temb + self.add_embedding(add_feat)

        context = encoder_hidden_states.to(dtype)
        layer_counter = [0]
        x = self.conv_in(sample.to(dtype))

        skips = [x]
        for block in self.down_blocks:
            x, new_skips = block(x, temb, context, layer_counter, attn_hook)
            skips.extend(new_skips)
        x = self.mid_block(x, temb, context, layer_counter, attn_hook)
        for block in self.up_blocks:
            x = block(x, skips, temb, context, layer_counter, attn_hook)

        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return x.float()


def count_attention_layers(cfg: UNetConfig) -> int:
    """Total attention layers (self + cross) in traversal order."""
    n = 0
    levels = len(cfg.block_out_channels)
    for level in range(levels):
        if cfg.cross_attn_blocks[level]:
            n += cfg.layers_per_block * cfg.transformer_depth[level] * 2
    n += cfg.transformer_depth[-1] * 2  # mid
    for level in range(levels):
        if cfg.cross_attn_blocks[level]:
            n += (cfg.layers_per_block + 1) * cfg.transformer_depth[level] * 2
    return n
