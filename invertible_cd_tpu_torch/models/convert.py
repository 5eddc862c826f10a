"""Weights bridge: the JAX package's Flax param trees -> this package's state dicts.

Each function is the exact inverse of a converter in
`invertible_cd_tpu/models/convert.py` (`convert_unet_from_diffusers`,
`convert_vae_from_diffusers`, `convert_clip_text_from_transformers`): it
takes a Flax param tree whose leaves are numpy arrays (with or without the
outer {"params": ...} level) and returns a {key: torch.Tensor} state dict in
diffusers / transformers naming:

  * conv kernels HWIO -> OIHW, dense kernels (in, out) -> (out, in),
    norm `scale` -> `weight`, `embedding` -> `weight`;
  * the `GroupNorm_0` wrapper level is dropped;
  * indexed module names `name_N` -> `name.N` (`to_out_0` -> `to_out.0`);
  * the VAE's `downsamplers_0` conv -> `downsamplers.0.conv`;
  * CLIP's `token_embedding/embedding` -> `text_model.embeddings.token_embedding.weight`.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

# Flax module names that stand for an index into a diffusers ModuleList.
_INDEXED = (
    "down_blocks", "up_blocks", "resnets", "attentions", "transformer_blocks",
    "downsamplers", "upsamplers", "to_out", "net", "layers",
)


def _leaves(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _params(tree):
    return tree["params"] if "params" in tree else tree


def _module_name(part: str) -> str:
    head, _, idx = part.rpartition("_")
    if head in _INDEXED and idx.isdigit():
        return f"{head}.{idx}"
    return part


def _tensor(leaf: str, value: np.ndarray) -> Tuple[str, torch.Tensor]:
    if leaf == "kernel":
        # conv HWIO -> OIHW, dense (in, out) -> (out, in)
        value = np.transpose(value, (3, 2, 0, 1)) if value.ndim == 4 else value.T
    name = "weight" if leaf in ("kernel", "scale", "embedding") else leaf
    return name, torch.tensor(value)


def _diffusers_state_dict(tree, vae: bool) -> Dict[str, torch.Tensor]:
    out = {}
    for path, value in _leaves(_params(tree)):
        mods = [p for p in path[:-1] if p != "GroupNorm_0"]
        names = [_module_name(p) for p in mods]
        if vae and mods and mods[-1] == "downsamplers_0":
            names.append("conv")
        leaf, tensor = _tensor(path[-1], value)
        out[".".join(names + [leaf])] = tensor
    return out


def unet_state_dict_from_flax(tree) -> Dict[str, torch.Tensor]:
    """Flax UNet2DCondition params -> diffusers UNet2DConditionModel keys."""
    return _diffusers_state_dict(tree, vae=False)


def vae_state_dict_from_flax(tree) -> Dict[str, torch.Tensor]:
    """Flax AutoencoderKL params -> diffusers AutoencoderKL keys."""
    return _diffusers_state_dict(tree, vae=True)


def clip_state_dict_from_flax(tree) -> Dict[str, torch.Tensor]:
    """Flax CLIPTextModel params -> transformers CLIPTextModel keys."""
    out = {}
    for path, value in _leaves(_params(tree)):
        if path == ("position_embedding",):
            out["text_model.embeddings.position_embedding.weight"] = torch.tensor(value)
            continue
        leaf, tensor = _tensor(path[-1], value)
        head = path[0]
        if head == "token_embedding":
            key = "text_model.embeddings.token_embedding"
        elif head == "text_projection":
            key = "text_projection"
        elif head == "final_layer_norm":
            key = "text_model.final_layer_norm"
        else:  # layers_N/...
            layer = "text_model.encoder.layers." + head.rpartition("_")[2]
            sub = path[1:-1]
            if sub[0] == "self_attn":
                key = f"{layer}.self_attn.{sub[1]}"
            elif sub[0] in ("fc1", "fc2"):
                key = f"{layer}.mlp.{sub[0]}"
            else:  # layer_norm1 / layer_norm2
                key = f"{layer}.{sub[0]}"
        out[f"{key}.{leaf}"] = tensor
    return out
