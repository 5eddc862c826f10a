"""Attention blocks with functional controller hook points.

PyTorch counterpart of `invertible_cd_tpu/models/attention.py`. The UNet
threads an optional `attn_hook(probs, meta) -> probs` callable into every
attention layer; a layer the hook applies to materialises its probabilities
(`explicit_attention`), every other layer takes `fused_attention`, which on
the card is always a hand-written kernel:

  * head dim <= 256 (every UNet self- and cross-attention): kernel B1;
  * head dim > 256 (the VAE's single d=512 head): kernel B2.

On the CPU both wrappers compute the plain version.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn as nn

from ..ops.flash_attention import flash_attention, flash_attention_streamed
from .layers import FeedForward, GroupNorm32, LayerNorm32


@dataclasses.dataclass(frozen=True)
class AttnMeta:
    """Static metadata identifying one attention layer (hook dispatch key).

    `store_key` addresses the layer in the p2p attention store, one list
    per `{place}_{kind}` in model traversal order.
    """

    place: str  # "down" | "mid" | "up"
    is_cross: bool
    layer_index: int  # global attention layer index in traversal order
    query_len: int
    key_len: int
    heads: int

    @property
    def kind(self) -> str:
        return "cross" if self.is_cross else "self"

    @property
    def store_key(self) -> str:
        return f"{self.place}_{self.kind}"


AttnHook = Callable[[torch.Tensor, AttnMeta], torch.Tensor]


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Softmax attention on (B, S, H, D) tensors without materialised
    probabilities: kernel B1 for head dims <= 256, B2 above."""
    if q.shape[-1] <= 256:
        return flash_attention(q, k, v)
    return flash_attention_streamed(q, k, v)


def routes_to_explicit(hook: Optional[AttnHook], meta: Optional[AttnMeta]) -> bool:
    """True when this layer must materialise probabilities for the hook.

    A hook may carry an `applies(meta)` predicate saying it is the identity
    on this layer; such layers keep the fused path."""
    if hook is None:
        return False
    applies = getattr(hook, "applies", None)
    return applies is None or bool(applies(meta))


def explicit_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, hook: AttnHook, meta: AttnMeta
) -> torch.Tensor:
    """Attention with materialised probabilities fed through the controller.

    q/k/v are (B, S, H, D); the hook sees fp32 probabilities (B, H, Sq, Sk)."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = hook(torch.softmax(logits, dim=-1), meta)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


class CrossAttention(nn.Module):
    """Multi-head attention (self when no context is given)."""

    def __init__(self, dim: int, heads: int, context_dim: Optional[int] = None):
        super().__init__()
        ctx = dim if context_dim is None else context_dim
        self.heads = heads
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(ctx, dim, bias=False)
        self.to_v = nn.Linear(ctx, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, x, context=None, hook: Optional[AttnHook] = None,
                meta: Optional[AttnMeta] = None):
        ctx = x if context is None else context
        b, sq, dim = x.shape
        sk = ctx.shape[1]
        d = dim // self.heads
        q = self.to_q(x).view(b, sq, self.heads, d)
        k = self.to_k(ctx).view(b, sk, self.heads, d)
        v = self.to_v(ctx).view(b, sk, self.heads, d)
        if routes_to_explicit(hook, meta):
            out = explicit_attention(q, k, v, hook, meta)
        else:
            out = fused_attention(q, k, v)
        return self.to_out[0](out.reshape(b, sq, dim))


class BasicTransformerBlock(nn.Module):
    """LN -> self-attn -> LN -> cross-attn -> LN -> GEGLU FF, all residual."""

    def __init__(self, dim: int, heads: int, context_dim: int):
        super().__init__()
        self.heads = heads
        self.norm1 = LayerNorm32(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, heads)
        self.norm2 = LayerNorm32(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, heads, context_dim=context_dim)
        self.norm3 = LayerNorm32(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, context, place: str, layer_counter: list, hook=None):
        meta_self = _next_meta(layer_counter, place, False, x.shape[1], x.shape[1], self.heads)
        x = x + self.attn1(self.norm1(x), None, hook, meta_self)
        meta_cross = _next_meta(layer_counter, place, True, x.shape[1], context.shape[1], self.heads)
        x = x + self.attn2(self.norm2(x), context, hook, meta_cross)
        return x + self.ff(self.norm3(x))


def _next_meta(counter: list, place: str, is_cross: bool, sq: int, sk: int, heads: int):
    meta = AttnMeta(
        place=place, is_cross=is_cross, layer_index=counter[0],
        query_len=sq, key_len=sk, heads=heads,
    )
    counter[0] += 1
    return meta


class Transformer2D(nn.Module):
    """Spatial transformer: GN(eps 1e-6) -> 1x1 conv proj_in -> depth x
    block -> 1x1 conv proj_out, + residual (SD1.5; SDXL's linear
    projections come with the SDXL slice). Tokens are the NHWC row-major
    flattening (b, h*w, c) of the feature map, as in the JAX package."""

    def __init__(self, dim: int, heads: int, context_dim: int, depth: int = 1):
        super().__init__()
        self.norm = GroupNorm32(dim, eps=1e-6)
        self.proj_in = nn.Conv2d(dim, dim, 1)
        self.proj_out = nn.Conv2d(dim, dim, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(dim, heads, context_dim) for _ in range(depth)]
        )

    def forward(self, x, context, place: str, layer_counter: list, hook=None):
        b, c, h, w = x.shape
        hidden = self.proj_in(self.norm(x)).permute(0, 2, 3, 1).reshape(b, h * w, c)
        for block in self.transformer_blocks:
            hidden = block(hidden, context, place, layer_counter, hook)
        return self.proj_out(hidden.reshape(b, h, w, c).permute(0, 3, 1, 2)) + x
