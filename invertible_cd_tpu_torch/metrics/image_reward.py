"""ImageReward scorer (BLIP backbone + reward MLP) in PyTorch.

PyTorch counterpart of `invertible_cd_tpu/metrics/image_reward.py`, the
twin of the reference's `calc_ir` (`utils/metrics.py:283-293`, the
`image_reward` package's `ImageReward-v1.0`):
  * BLIP ViT-L/16 image encoder returning every token (224^2, patch 16),
  * BLIP's text encoder, BERT-base in multimodal mode: each layer runs
    self-attention over the text (masked to the prompt's tokens), then
    cross-attention over the image tokens, then the MLP,
  * the reward head: five plain Linears 768 -> 1024 -> 128 -> 64 -> 16 -> 1
    on the CLS feature (upstream's activations are commented out), with the
    published mean/std normalisation.

Attention is the explicit softmax of JAX :71-78 (fp32 logits, masked keys
at -1e30), `metrics.vit.attention`. Module names mirror the JAX package's
(`visual_encoder`, `text_encoder.layer.N.crossattention.query`, `mlp.fc1`,
...); `models.convert.convert_image_reward_weights` maps the published
checkpoint onto them.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .precision import fp32_products
from .vit import ViTConfig, ViTTrunk, attention, preprocess_for

# published normalisation of ImageReward-v1.0 raw scores
IR_MEAN = 0.16717362830052426
IR_STD = 1.0333394966054072

BLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
BLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30524  # bert-base + BLIP special tokens
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    encoder_width: int = 1024  # image feature dim for cross-attention

    @staticmethod
    def tiny(encoder_width: int = 16) -> "BertConfig":
        return BertConfig(
            vocab_size=1000, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, encoder_width=encoder_width,
        )


class BertAttention(nn.Module):
    """Self- or cross-attention, the output projection and the residual
    LayerNorm (eps 1e-12)."""

    def __init__(self, cfg: BertConfig, kv_width: int):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_heads
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(kv_width, d)
        self.value = nn.Linear(kv_width, d)
        self.output = nn.Linear(d, d)
        self.norm = nn.LayerNorm(d, eps=1e-12)

    def forward(self, x, kv, mask=None):
        out = attention(self.query(x), self.key(kv), self.value(kv), self.heads, mask)
        return self.norm(self.output(out) + x)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attention = BertAttention(cfg, cfg.hidden_size)
        self.crossattention = BertAttention(cfg, cfg.encoder_width)
        self.intermediate = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.norm = nn.LayerNorm(cfg.hidden_size, eps=1e-12)

    def forward(self, x, image_embeds, text_mask):
        x = self.attention(x, x, text_mask)
        x = self.crossattention(x, image_embeds)
        h = self.output(F.gelu(self.intermediate(x)))
        return self.norm(h + x)


class BlipTextEncoder(nn.Module):
    """BERT in BLIP multimodal mode: text self-attention + image cross-attention."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Parameter(
            torch.zeros(cfg.max_position_embeddings, cfg.hidden_size))
        self.embed_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-12)
        self.layer = nn.ModuleList([BertLayer(cfg) for _ in range(cfg.num_layers)])

    def forward(self, input_ids, image_embeds, text_mask=None):
        x = self.word_embeddings(input_ids) + self.position_embeddings[None, : input_ids.shape[1]]
        x = self.embed_norm(x)
        for layer in self.layer:
            x = layer(x, image_embeds, text_mask)
        return x


class RewardHead(nn.Module):
    """hidden -> 1024 -> 128 -> 64 -> 16 -> 1, Linears only (JAX :128-146)."""

    def __init__(self, hidden: int):
        super().__init__()
        widths = (hidden, 1024, 128, 64, 16, 1)
        for i in range(5):
            self.add_module(f"fc{i + 1}", nn.Linear(widths[i], widths[i + 1]))

    def forward(self, feat):
        for i in range(5):
            feat = getattr(self, f"fc{i + 1}")(feat)
        return feat[..., 0]


class ImageReward(nn.Module):
    """forward(images01 (B, 3, H, W), input_ids (B, S), text_mask (B, S)
    bool or None) -> (B,) normalised reward, fp32."""

    def __init__(self, vit_cfg: ViTConfig, bert_cfg: BertConfig):
        super().__init__()
        self.vit_cfg = vit_cfg
        # BLIP's ViT: patch embedding with bias, no pre-LN (JAX `PatchSequenceViT`)
        self.visual_encoder = ViTTrunk(vit_cfg, pre_ln=False, patch_bias=True)
        self.text_encoder = BlipTextEncoder(bert_cfg)
        self.mlp = RewardHead(bert_cfg.hidden_size)

    @fp32_products()
    def forward(self, images01, input_ids, text_mask=None):
        x = preprocess_for(images01, self.vit_cfg.image_size, BLIP_IMAGE_MEAN, BLIP_IMAGE_STD)
        image_embeds = self.visual_encoder(x).float()
        txt = self.text_encoder(input_ids, image_embeds, text_mask)
        raw = self.mlp(txt[:, 0])
        return ((raw - IR_MEAN) / IR_STD).float()


def _text_mask_from_ids(ids: np.ndarray, tokenizer) -> np.ndarray:
    """Attention mask over the padded token ids (JAX :209-232).

    The reference scores with the HF tokenizer's `attention_mask`, so [PAD]
    positions must not be attended. BERT's pad id is 0, which can collide
    with a real id in reduced test vocabs, so when the tokenizer exposes
    `sep_id` the position of the last [SEP] defines the valid span (BLIP pads
    strictly after [SEP]); without [SEP] in a row the whole row is valid."""
    pos = np.arange(ids.shape[1])[None, :]
    sep = getattr(tokenizer, "sep_id", None)
    if sep is not None:
        is_sep = ids == sep
        last = np.where(is_sep.any(axis=1), (is_sep * pos).max(axis=1), ids.shape[1] - 1)
        return pos <= last[:, None]
    pad = getattr(tokenizer, "pad_id", getattr(tokenizer, "pad_token_id", None))
    if pad is None:
        return np.ones(ids.shape, bool)
    mask = ids != pad
    mask[:, 0] = True  # CLS is always valid even if its id equals pad
    return mask


def make_image_reward_fn(module: ImageReward, tokenizer):
    """The `Evaluators.image_reward_fn` callable: (images01 (B, H, W, 3)
    float in [0, 1], numpy or a tensor, prompts) -> (B,) numpy scores,
    computed on the module's device."""
    device = module.mlp.fc1.weight.device

    @torch.inference_mode()
    def fn(images01, prompts: Sequence[str]):
        ids = np.asarray(tokenizer(list(prompts)))
        mask = torch.as_tensor(_text_mask_from_ids(ids, tokenizer), device=device)
        if not isinstance(images01, torch.Tensor):  # numpy, or a tensor on any device
            images01 = torch.from_numpy(np.ascontiguousarray(images01, np.float32))
        images = images01.to(device=device, dtype=torch.float32).permute(0, 3, 1, 2)
        ids_t = torch.as_tensor(ids, dtype=torch.long, device=device)
        return module(images, ids_t, mask).cpu().numpy()

    return fn
