"""LoRA adapters on PyTorch state dicts.

PyTorch counterpart of `lora_delta` / `merge_lora` in
`invertible_cd_tpu/models/lora.py`. An adapter set is a dict keyed by the
state-dict key of the adapted weight, e.g.
`"down_blocks.0.resnets.0.conv1.weight"`, each entry {"down": A, "up": B}
in torch (kohya) layout:

  * linear weight (out, in):        down (r, in),        up (out, r);
  * conv weight (out, in, kh, kw):  down (r, in, kh, kw), up (out, r).

Merging gives W' = W + (alpha / r) * up∘down.
"""
from __future__ import annotations

import re
from typing import Dict, Sequence, Tuple

import torch

# Modules that receive adapters, in state-dict naming: attention q/k/v/out,
# transformer proj_in/out, GEGLU + FF output, resnet convs + shortcut,
# up/downsamplers and time_emb_proj.
DEFAULT_TARGET_PATTERNS: Tuple[str, ...] = (
    r"\bto_q$", r"\bto_k$", r"\bto_v$", r"\bto_out\.0$",
    r"\bproj_in$", r"\bproj_out$",
    r"\bff\.net\.0\.proj$", r"\bff\.net\.2$",
    r"\bconv1$", r"\bconv2$", r"\bconv_shortcut$",
    r"\bdownsamplers\.0\.conv$", r"\bupsamplers\.0\.conv$",
    r"\btime_emb_proj$",
)


def find_lora_targets(
    state_dict: Dict[str, torch.Tensor], patterns: Sequence[str] = DEFAULT_TARGET_PATTERNS
) -> list:
    """State-dict keys of the weights whose owning module matches a pattern."""
    regs = [re.compile(p) for p in patterns]
    return [
        key for key in state_dict
        if key.endswith(".weight") and any(r.search(key[: -len(".weight")]) for r in regs)
    ]


def seeded_lora(
    state_dict: Dict[str, torch.Tensor], generator: torch.Generator, rank: int = 64,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Synthetic adapters for every target weight, drawn from `generator`
    on the weights' device with the fan-in rule: down ~ N(0, 1/(in*kh*kw)),
    up ~ N(0, 1/rank). Unlike a training init (up = 0), the merged model
    differs from the base, so a merge is visible in the output."""
    lora = {}
    for key in find_lora_targets(state_dict):
        w = state_dict[key]
        fan_in = w[0].numel()
        down = torch.randn((rank,) + tuple(w.shape[1:]), generator=generator,
                           device=w.device, dtype=torch.float32) / fan_in**0.5
        up = torch.randn((w.shape[0], rank), generator=generator,
                         device=w.device, dtype=torch.float32) / rank**0.5
        lora[key] = {"down": down, "up": up}
    return lora


def lora_delta(down: torch.Tensor, up: torch.Tensor, scale) -> torch.Tensor:
    """Densified adapter delta with the shape of the base weight."""
    if down.dim() == 2:
        return scale * (up @ down)
    return scale * torch.einsum("or,rihw->oihw", up.reshape(up.shape[0], -1), down)


def merge_lora(
    state_dict: Dict[str, torch.Tensor], lora: Dict[str, Dict[str, torch.Tensor]],
    alpha: float = 8.0, rank: int = 64,
) -> Dict[str, torch.Tensor]:
    """Return a new state dict with the adapters fused in:
    W' = W + (alpha/rank) * up∘down. Weights not in `lora` are passed
    through unchanged (same tensors)."""
    scale = alpha / rank
    out = dict(state_dict)
    for key, ab in lora.items():
        base = state_dict[key]
        delta = lora_delta(ab["down"].to(base.device), ab["up"].to(base.device), scale)
        out[key] = base + delta.to(base.dtype)
    return out
