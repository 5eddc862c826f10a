"""CLIP text encoders in PyTorch (ViT-L, and SDXL's OpenCLIP bigG), transformers naming.

PyTorch counterpart of `invertible_cd_tpu/models/clip.py`. Module names
follow transformers' `CLIPTextModel`, so `state_dict()` keys read
`text_model.embeddings.token_embedding.weight`,
`text_model.encoder.layers.N.self_attn.q_proj.weight`, ... and, for
bigG (transformers' `CLIPTextModelWithProjection`), `text_projection.weight`
beside them. The causal
attention is plain tensor code, as in the JAX package (it never reached a
Pallas kernel there).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import LayerNorm32


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    intermediate_size: int = 3072
    hidden_act: str = "quick_gelu"  # OpenCLIP bigG uses "gelu"
    projection_dim: Optional[int] = None
    eos_token_id: int = 49407

    @staticmethod
    def vit_l() -> "CLIPTextConfig":
        return CLIPTextConfig()

    @staticmethod
    def open_clip_big_g() -> "CLIPTextConfig":
        return CLIPTextConfig(
            hidden_size=1280, num_layers=32, num_heads=20,
            intermediate_size=5120, hidden_act="gelu", projection_dim=1280,
        )

    @staticmethod
    def tiny(vocab_size: int = 1000) -> "CLIPTextConfig":
        return CLIPTextConfig(
            vocab_size=vocab_size, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64,
        )


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.hidden_size
        self.q_proj = nn.Linear(c, c)
        self.k_proj = nn.Linear(c, c)
        self.v_proj = nn.Linear(c, c)
        self.out_proj = nn.Linear(c, c)

    def forward(self, x, causal_mask):
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.hidden_size // cfg.num_heads
        q = self.q_proj(x).view(b, s, cfg.num_heads, hd)
        k = self.k_proj(x).view(b, s, cfg.num_heads, hd)
        v = self.v_proj(x).view(b, s, cfg.num_heads, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (hd**-0.5)
        logits = logits.masked_fill(~causal_mask, torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, cfg.hidden_size)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        if cfg.hidden_act not in ("quick_gelu", "gelu"):
            raise ValueError(f"hidden_act {cfg.hidden_act!r}")
        self.quick = cfg.hidden_act == "quick_gelu"
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        h = self.fc1(x)
        # quick_gelu, or the exact (erf) gelu
        return self.fc2(h * torch.sigmoid(1.702 * h) if self.quick else F.gelu(h))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm1 = LayerNorm32(cfg.hidden_size, eps=1e-5)
        self.mlp = CLIPMLP(cfg)
        self.layer_norm2 = LayerNorm32(cfg.hidden_size, eps=1e-5)

    def forward(self, x, causal_mask):
        x = x + self.self_attn(self.layer_norm1(x), causal_mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)

    def forward(self, input_ids):
        s = input_ids.shape[1]
        return self.token_embedding(input_ids) + self.position_embedding.weight[None, :s]


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg) for _ in range(cfg.num_layers)])


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPTextEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = LayerNorm32(cfg.hidden_size, eps=1e-5)


class CLIPTextModel(nn.Module):
    """forward(input_ids (B, S) int) -> dict(last_hidden_state,
    penultimate_hidden_state, pooled_output), plus projected_pooled (the
    pooled output through `text_projection`) when the config has a
    `projection_dim`."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.text_model = CLIPTextTransformer(cfg)
        if cfg.projection_dim is not None:
            self.text_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)

    def forward(self, input_ids: torch.Tensor):
        tm = self.text_model
        s = input_ids.shape[1]
        x = tm.embeddings(input_ids)
        causal = torch.ones(s, s, dtype=torch.bool, device=input_ids.device).tril()
        penultimate = None
        for i, layer in enumerate(tm.encoder.layers):
            if i == len(tm.encoder.layers) - 1:
                penultimate = x
            x = layer(x, causal)
        last = tm.final_layer_norm(x)
        # pooled output at the first EOS token (argmax of the EOS indicator)
        eos_pos = (input_ids == self.cfg.eos_token_id).int().argmax(dim=-1)
        pooled = last[torch.arange(last.shape[0], device=last.device), eos_pos]
        out = {
            "last_hidden_state": last,
            "penultimate_hidden_state": penultimate,
            "pooled_output": pooled,
        }
        if self.cfg.projection_dim is not None:
            out["projected_pooled"] = self.text_projection(pooled)
        return out
