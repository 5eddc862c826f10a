"""Vision transformers for the metric suite (CLIP ViT-L/14, DINOv2 ViT-B/14).

PyTorch counterpart of `invertible_cd_tpu/metrics/vit.py`. The reference
scores images with transformers' `CLIPModel` vision tower
(`utils/metrics.py:211-280`) and torch-hub DINOv2 (`metrics.py:176-207`);
one configurable ViT covers both:
  * CLIP vision: class token, an embedding pre-LN, quick-gelu, the patch
    embedding without bias, post-LN on the class token, a linear projection;
  * DINOv2: gelu (exact), LayerScale (`ls1`, `ls2`) on both residual
    branches, eps 1e-6, no projection: the CLS feature of the final norm.
The position embedding is sliced to the token count, not interpolated.

Attention is plain softmax(QK^T / sqrt(d)) V in fp32: the JAX package calls
`jax.nn.dot_product_attention`, which never reached a Pallas kernel, so
none of the port's attention kernels stands in for it.

Module names mirror the JAX package's (`patch_embed`, `blocks.N.q_proj`,
`post_layernorm`, ...); `models.convert` maps the published checkpoints and
the JAX param trees onto them. Layout NCHW for images.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .precision import fp32_products
from .resize import resize


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    hidden_act: str = "quick_gelu"  # "gelu" for DINOv2
    projection_dim: Optional[int] = 768  # None for DINOv2
    layer_scale_init: Optional[float] = None  # 1e-5 for DINOv2
    pre_ln: bool = True  # CLIP has an embedding pre-LN; DINOv2 doesn't
    norm_eps: float = 1e-5  # CLIP; timm-style ViTs (DINOv2, BLIP) use 1e-6

    @staticmethod
    def clip_vit_l14() -> "ViTConfig":
        return ViTConfig()

    @staticmethod
    def dinov2_vit_b14() -> "ViTConfig":
        return ViTConfig(
            patch_size=14, hidden_size=768, num_layers=12, num_heads=12,
            intermediate_size=3072, hidden_act="gelu", projection_dim=None,
            layer_scale_init=1e-5, pre_ln=False, norm_eps=1e-6,
        )

    @staticmethod
    def blip_vit_l16() -> "ViTConfig":
        """BLIP ViT-L/16 image encoder (the ImageReward-v1.0 backbone)."""
        return ViTConfig(
            image_size=224, patch_size=16, hidden_size=1024, num_layers=24,
            num_heads=16, intermediate_size=4096, hidden_act="gelu",
            projection_dim=None, pre_ln=False, norm_eps=1e-6,
        )

    @staticmethod
    def tiny() -> "ViTConfig":
        return ViTConfig(
            image_size=28, patch_size=14, hidden_size=32, num_layers=2,
            num_heads=2, intermediate_size=64, projection_dim=16,
        )


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(QK^T / sqrt(d)) V with fp32 logits; q (B, Sq, D), k and v
    (B, Sk, D), D split into `heads`; `mask` (B, Sk) bool marks the keys
    that may be attended (the others get logit -1e30)."""
    b, sq, dim = q.shape
    sk, hd = k.shape[1], dim // heads
    q = q.reshape(b, sq, heads, hd)
    k = k.reshape(b, sk, heads, hd)
    v = v.reshape(b, sk, heads, hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * hd**-0.5
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None, None, :], -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, sq, dim)


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x)  # exact (erf)


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        self.norm1 = nn.LayerNorm(d, eps=cfg.norm_eps)
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)
        self.norm2 = nn.LayerNorm(d, eps=cfg.norm_eps)
        self.fc1 = nn.Linear(d, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, d)
        if cfg.layer_scale_init is not None:
            self.ls1 = nn.Parameter(torch.full((d,), cfg.layer_scale_init))
            self.ls2 = nn.Parameter(torch.full((d,), cfg.layer_scale_init))

    def forward(self, x):
        c = self.cfg
        h = self.norm1(x)
        attn = self.out_proj(attention(self.q_proj(h), self.k_proj(h), self.v_proj(h), c.num_heads))
        if c.layer_scale_init is not None:
            attn = attn * self.ls1
        x = x + attn
        h = self.fc2(_act(c.hidden_act, self.fc1(self.norm2(x))))
        if c.layer_scale_init is not None:
            h = h * self.ls2
        return x + h


class ViTTrunk(nn.Module):
    """Patch embedding, class token, sliced position embedding, optional
    pre-LN, the blocks and the final LayerNorm: images (B, 3, H, W) ->
    tokens (B, N+1, D)."""

    def __init__(self, cfg: ViTConfig, pre_ln: bool, patch_bias: bool):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        self.patch_embed = nn.Conv2d(3, d, cfg.patch_size, stride=cfg.patch_size, bias=patch_bias)
        self.class_embedding = nn.Parameter(torch.zeros(d))
        n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.position_embedding = nn.Parameter(torch.zeros(n_pos, d))
        if pre_ln:
            self.pre_layernorm = nn.LayerNorm(d, eps=1e-5)
        self.blocks = nn.ModuleList([ViTBlock(cfg) for _ in range(cfg.num_layers)])
        self.post_layernorm = nn.LayerNorm(d, eps=cfg.norm_eps)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        b = images.shape[0]
        x = self.patch_embed(images.to(self.patch_embed.weight.dtype))
        x = x.flatten(2).transpose(1, 2)  # (B, N, D), row-major patches as JAX's reshape
        cls = self.class_embedding.to(x.dtype).expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1)
        x = x + self.position_embedding[None, : x.shape[1]].to(x.dtype)
        if hasattr(self, "pre_layernorm"):
            x = self.pre_layernorm(x)
        for block in self.blocks:
            x = block(x)
        return self.post_layernorm(x)


class ViTEncoder(ViTTrunk):
    """images (B, 3, H, W), already normalised -> (B, D') fp32 embedding:
    the CLS token, through the projection when the config has one."""

    def __init__(self, cfg: ViTConfig):
        super().__init__(cfg, pre_ln=cfg.pre_ln, patch_bias=not cfg.pre_ln)
        if cfg.projection_dim is not None:
            self.projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)

    @fp32_products()
    def forward(self, images: torch.Tensor) -> torch.Tensor:
        feat = super().forward(images)[:, 0]
        if self.cfg.projection_dim is not None:
            feat = self.projection(feat)
        return feat.float()


CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def preprocess_for(images: torch.Tensor, size: int, mean, std) -> torch.Tensor:
    """float [0, 1] (B, 3, H, W) any size -> normalised (B, 3, size, size)
    (JAX's antialiased cubic resize, `metrics.resize`)."""
    x = resize(images.float(), (size, size), "cubic")
    mean = torch.tensor(mean, device=x.device, dtype=x.dtype)[None, :, None, None]
    std = torch.tensor(std, device=x.device, dtype=x.dtype)[None, :, None, None]
    return (x - mean) / std
