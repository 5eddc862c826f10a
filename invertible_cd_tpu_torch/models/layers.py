"""Shared building blocks for the SD UNet and VAE (NCHW, diffusers naming).

PyTorch counterpart of `invertible_cd_tpu/models/layers.py`. Parameter
names follow diffusers, so `state_dict()` keys are the diffusers keys.

Precision: weights of linear and convolution layers are held in the
compute dtype (bf16 on the card: the JAX package casts its fp32 params to
bf16 at every use, which rounds identically), while GroupNorm and LayerNorm
keep fp32 parameters and compute their statistics in fp32
(`cast_compute_weights`).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..ops import quant
from ..parallel import spatial
from ..parallel.mesh import all_reduce, to_tp


class QLinear(nn.Linear):
    """`nn.Linear` that runs int8 (`ops.quant.int8_linear`: per-token
    activation and per-output-feature weight scales, kernels Q2 and Q1, the
    weight's codes cached on the layer) inside an int8 `quant_scope`, and is
    exactly `nn.Linear` outside one or on non-float input (JAX `QDense`).
    CLIP keeps plain `nn.Linear`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if quant.current_quant_mode() in quant.INT8_MODES and x.is_floating_point():
            return quant.int8_linear(x, self.weight, self.bias, quant.weight_codes(self))
        return super().forward(x)

    def _apply(self, fn, *args, **kwargs):  # .to() / .cuda() / .float(): the codes go with the weight
        self.__dict__.pop("_int8_weight_codes", None)
        return super()._apply(fn, *args, **kwargs)


class QConv2d(nn.Conv2d):
    """`nn.Conv2d` that runs int8 (`ops.quant.int8_conv2d`: one activation
    scale per tensor, or its calibrated amax under "int8_static"; one weight
    scale per output channel; kernels Q2 and Q1, the weight's codes cached on
    the layer) inside an int8 `quant_scope`, records its input's amax inside
    a "calibrate" scope, and is exactly `nn.Conv2d` otherwise (JAX `QConv`).
    Grouped, dilated or non-zero-padded convolutions and non-float input
    stay float in every mode.

    Inside `parallel.spatial` (x holds this rank's rows of the height) a
    3x3 convolution with padding 1 takes one halo row from each
    neighbouring rank and pads the width alone, and an int8 convolution's
    dynamic amax is the sp group's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mesh = spatial.active()
        padding = self.padding
        if mesh is not None and self.kernel_size == (3, 3) and padding == (1, 1):
            x, padding = spatial.halo(x, mesh), (0, 1)
        mode = quant.current_quant_mode()
        if mode == "calibrate":
            quant.record_amax(self, x)
        elif (mode in quant.INT8_MODES and x.is_floating_point() and self.groups == 1
              and self.dilation == (1, 1) and self.padding_mode == "zeros"
              and not isinstance(padding, str)):
            amax = quant.static_amax(self)
            if amax is None and mesh is not None:
                amax = all_reduce(quant.tensor_amax(x), mesh, "sp", dist.ReduceOp.MAX)
            return quant.int8_conv2d(x, self.weight, self.bias, self.stride, padding,
                                     amax, quant.weight_codes(self))
        if padding is not self.padding:
            return F.conv2d(x, self.weight, self.bias, self.stride, padding, self.dilation, self.groups)
        return super().forward(x)

    def _apply(self, fn, *args, **kwargs):
        self.__dict__.pop("_int8_weight_codes", None)
        return super()._apply(fn, *args, **kwargs)


def sinusoidal_timestep_embedding(
    timesteps: torch.Tensor,
    dim: int,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    max_period: float = 10000.0,
    dtype=torch.float32,
) -> torch.Tensor:
    """Sinusoidal timestep features (diffusers `Timesteps`; SD uses
    flip_sin_to_cos=True, shift=0). timesteps (B,) -> (B, dim)."""
    half_dim = dim // 2
    exponent = -np.log(max_period) * torch.arange(
        half_dim, dtype=torch.float32, device=timesteps.device
    )
    exponent = exponent / (half_dim - downscale_freq_shift)
    freqs = torch.exp(exponent)
    args = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half_dim:], emb[:, :half_dim]], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb.to(dtype)


class GroupNorm32(nn.Module):
    """GroupNorm with float32 statistics, cast back to the input dtype.

    Variance is E[x^2] - E[x]^2 in fp32 (clamped at 0), as in the JAX
    package. When the channel count does not divide `num_groups`, the
    group count falls back to the largest divisor <= num_groups (the tiny
    test configs need this). Inside `parallel.spatial` the statistics are
    those of the sp group's whole height (`spatial.group_moments`)."""

    def __init__(self, num_channels: int, eps: float = 1e-5, num_groups: int = 32):
        super().__init__()
        groups = num_groups
        while num_channels % groups != 0:
            groups -= 1
        self.num_groups = groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        xf = x.float()
        grouped = xf.reshape(b, self.num_groups, -1)
        mesh = spatial.active()
        if mesh is None:
            mean = grouped.mean(-1)
            var = (grouped.square().mean(-1) - mean.square()).clamp_min(0.0)
        else:
            mean, var = spatial.group_moments(grouped, mesh)
        inv = torch.rsqrt(var + self.eps)
        gc = c // self.num_groups
        a = inv.repeat_interleave(gc, dim=1) * self.weight.float()[None, :]
        bb = self.bias.float()[None, :] - mean.repeat_interleave(gc, dim=1) * a
        shape = (b, c) + (1,) * (x.dim() - 2)
        return (xf * a.reshape(shape) + bb.reshape(shape)).to(x.dtype)


class LayerNorm32(nn.LayerNorm):
    """LayerNorm computed in fp32 over fp32 parameters, cast back to the
    input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight.float(),
            self.bias.float(), self.eps,
        ).to(x.dtype)


def cast_compute_weights(module: nn.Module, dtype) -> nn.Module:
    """Cast every parameter to `dtype` except those of the normalisation
    layers, which stay fp32. In place; returns `module`."""
    for m in module.modules():
        if isinstance(m, (GroupNorm32, LayerNorm32)):
            continue
        for name, p in m.named_parameters(recurse=False):
            p.data = p.data.to(dtype)
    return module


class TimestepEmbedding(nn.Module):
    """Two-layer MLP over timestep features, with the optional guidance
    conditioning projection (`cond_proj`) of iCD's w-embedding."""

    def __init__(self, in_dim: int, embed_dim: int, cond_proj_dim: Optional[int] = None):
        super().__init__()
        self.linear_1 = QLinear(in_dim, embed_dim)
        self.linear_2 = QLinear(embed_dim, embed_dim)
        self.cond_proj = (
            QLinear(cond_proj_dim, in_dim, bias=False) if cond_proj_dim else None
        )

    def forward(self, sample: torch.Tensor, condition: Optional[torch.Tensor] = None):
        if condition is not None:
            if self.cond_proj is None:
                raise ValueError("w-embedding passed but cond_proj_dim is unset")
            sample = sample + self.cond_proj(condition)
        return self.linear_2(F.silu(self.linear_1(sample)))


class ResnetBlock2D(nn.Module):
    """GN -> silu -> conv3x3 -> (+time bias) -> GN -> silu -> conv3x3 + skip.

    eps: 1e-5 in the diffusers UNet, 1e-6 in the diffusers VAE."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int] = None, eps: float = 1e-5):
        super().__init__()
        self.norm1 = GroupNorm32(in_channels, eps)
        self.conv1 = QConv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = (
            QLinear(temb_channels, out_channels) if temb_channels else None
        )
        self.norm2 = GroupNorm32(out_channels, eps)
        self.conv2 = QConv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (
            QConv2d(in_channels, out_channels, 1) if in_channels != out_channels else None
        )

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        residual = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return h + residual


class Downsample2D(nn.Module):
    """Asymmetric (0,1,0,1) pad, then a stride-2 VALID conv3x3. Inside
    `parallel.spatial` the row below this rank's comes from the next rank
    (zeros below the last), so each rank's (even) row count halves."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = QConv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x):
        mesh = spatial.active()
        if mesh is not None:
            return self.conv(F.pad(spatial.halo(x, mesh, above=0, below=1), (0, 1)))
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample2D(nn.Module):
    """Nearest x2 upsample, then conv3x3 (which takes its halo inside
    `parallel.spatial`)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = QConv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class GEGLU(nn.Module):
    """Gated GELU input projection: first half is h, second half the gate,
    exact (erf) gelu."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.proj = QLinear(dim, dim_out * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    """GEGLU -> Linear; `net.1` is the (parameter-free) dropout slot of
    diffusers, kept so the keys read `net.0.proj` and `net.2`. `parallel.tp`
    may leave it this rank's features and set `tp_mesh`; its input then
    passes through `to_tp`, which sums its gradient over the tp group."""

    tp_mesh = None

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(), QLinear(dim * mult, dim)])

    def forward(self, x):
        if self.tp_mesh is not None:
            x = to_tp(x, self.tp_mesh)
        return self.net[2](self.net[0](x))


def fan_in_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded synthetic weights: every tensor of 2 or more dims ~
    N(0, 1/fan_in) with fan_in = prod(shape[1:]); 1-D weights ~ 1 + 0.05 N,
    biases ~ 0.05 N (the rule of tools/make_synthetic_pack.py). Drawn on
    the parameters' device from `generator`. In place; returns `module`."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            noise = torch.randn(p.shape, generator=generator, device=p.device, dtype=torch.float32)
            if p.dim() >= 2:
                fan_in = int(np.prod(p.shape[1:]))
                p.copy_(noise / math.sqrt(max(fan_in, 1)))
            elif name.endswith("bias"):
                p.copy_(0.05 * noise)
            else:
                p.copy_(1.0 + 0.05 * noise)
    return module
