"""Attention blocks with functional controller hook points.

PyTorch counterpart of `invertible_cd_tpu/models/attention.py`. The UNet
threads an optional `attn_hook(probs, meta) -> probs` callable into every
attention layer; a layer the hook applies to materialises its probabilities
(`explicit_attention`), every other layer takes `fused_attention`, which on
the card is always a hand-written kernel:

  * head dim <= 256 (every UNet self- and cross-attention): kernel B1, and
    under a gradient its backward kernels B3 (dQ) and B4 (dK, dV);
  * head dim > 256 (the VAE's single d=512 head): kernel B2, whose backward
    is plain PyTorch chunked over key tiles.

On the CPU both wrappers compute the plain versions, forward and backward.

Inside `parallel.spatial` a self-attention layer holds the queries of its
rank's rows and gathers K and V over the sp group (Sk = the whole height's
tokens). A layer that a hook applies to raises there, and on a layer that
`parallel.tp` split over heads, because the controllers read whole query
rows of the probabilities, of every head.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn as nn

from ..ops.flash_attention import flash_attention, flash_attention_streamed
from ..parallel import spatial
from ..parallel.mesh import gather_rows, to_tp
from .layers import FeedForward, GroupNorm32, LayerNorm32, QConv2d, QLinear


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
    probabilities, differentiable: kernel B1 for head dims <= 256, B2
    above."""
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


def gather_kv(k: torch.Tensor, v: torch.Tensor, mesh):
    """K and V (B, S_local, H, D) of this rank's rows -> those of the sp
    group's whole height (the tokens are the row-major flattening of the
    feature map), in one gather."""
    kv = gather_rows(torch.cat([k, v], dim=-1), mesh, 1)
    return (t.contiguous() for t in kv.chunk(2, dim=-1))


class CrossAttention(nn.Module):
    """Multi-head attention (self when no context is given). `parallel.tp`
    may leave it this rank's heads (`heads`, the projections' widths) and
    set `tp_mesh`; the inputs of q/k/v then pass through `to_tp`, which
    sums their gradients over the tp group."""

    tp_mesh = None

    def __init__(self, dim: int, heads: int, context_dim: Optional[int] = None):
        super().__init__()
        ctx = dim if context_dim is None else context_dim
        self.heads = heads
        self.to_q = QLinear(dim, dim, bias=False)
        self.to_k = QLinear(ctx, dim, bias=False)
        self.to_v = QLinear(ctx, dim, bias=False)
        self.to_out = nn.ModuleList([QLinear(dim, dim)])

    def forward(self, x, context=None, hook: Optional[AttnHook] = None,
                meta: Optional[AttnMeta] = None):
        if self.tp_mesh is not None:
            x = to_tp(x, self.tp_mesh)
            context = None if context is None else to_tp(context, self.tp_mesh)
        ctx = x if context is None else context
        b, sq = x.shape[:2]
        sk = ctx.shape[1]
        inner = self.to_q.out_features  # dim, or this rank's heads' share under tp
        d = inner // self.heads
        q = self.to_q(x).view(b, sq, self.heads, d)
        k = self.to_k(ctx).view(b, sk, self.heads, d)
        v = self.to_v(ctx).view(b, sk, self.heads, d)
        mesh = spatial.active()
        if mesh is not None and context is None:
            k, v = gather_kv(k, v, mesh)
        if routes_to_explicit(hook, meta):
            if mesh is not None or self.tp_mesh is not None:
                raise ValueError(
                    "attention hooks (prompt-to-prompt controllers) are refused under sp and tp: a "
                    "controller reads the probabilities of whole query rows and of every head, and "
                    "an sp rank holds only its rows, a tp rank only its heads")
            out = explicit_attention(q, k, v, hook, meta)
        else:
            out = fused_attention(q, k, v)
        return self.to_out[0](out.reshape(b, sq, inner))


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
    """Spatial transformer: GN(eps 1e-6) -> proj_in -> depth x block ->
    proj_out, + residual. The projections are 1x1 convolutions (SD1.5) or,
    with `use_linear_projection`, linear layers over the tokens (SDXL).
    Tokens are the NHWC row-major flattening (b, h*w, c) of the feature map,
    as in the JAX package."""

    def __init__(self, dim: int, heads: int, context_dim: int, depth: int = 1,
                 use_linear_projection: bool = False):
        super().__init__()
        self.use_linear_projection = use_linear_projection
        self.norm = GroupNorm32(dim, eps=1e-6)
        proj = QLinear if use_linear_projection else (lambda i, o: QConv2d(i, o, 1))
        self.proj_in = proj(dim, dim)
        self.proj_out = proj(dim, dim)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(dim, heads, context_dim) for _ in range(depth)]
        )

    def forward(self, x, context, place: str, layer_counter: list, hook=None):
        b, c, h, w = x.shape
        hidden = self.norm(x)
        if self.use_linear_projection:
            hidden = self.proj_in(hidden.permute(0, 2, 3, 1).reshape(b, h * w, c))
        else:
            hidden = self.proj_in(hidden).permute(0, 2, 3, 1).reshape(b, h * w, c)
        for block in self.transformer_blocks:
            hidden = block(hidden, context, place, layer_counter, hook)
        if self.use_linear_projection:
            hidden = self.proj_out(hidden)
            return hidden.reshape(b, h, w, c).permute(0, 3, 1, 2) + x
        return self.proj_out(hidden.reshape(b, h, w, c).permute(0, 3, 1, 2)) + x
