"""Checkpoint loading for the full pipeline bundle.

PyTorch counterpart of `invertible_cd_tpu/pipelines/loading.py`. It fills
the state dicts that `InvertibleCD.sd15(params=...)` takes from torch
artifacts on disk:

  * teacher UNet: a diffusers state dict (`.pt` / `.safetensors`, the
    guidance-distilled teacher);
  * VAE / CLIP text encoders (SDXL's second one, bigG with its
    `text_projection`, under "text_2"): diffusers / transformers state
    dicts;
  * reverse / forward students: kohya LoRA files fused into the teacher's
    weights at the file's alpha and rank.

The port's modules use diffusers / transformers key names, so the state
dicts load as they are; only the transformers `position_ids` buffer is
dropped. Everything stays on the CPU; the pipeline moves it to its device.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..models.convert import convert_lora_from_kohya, load_torch_file
from ..models.lora import merge_lora

StateDict = Dict[str, torch.Tensor]


def _fuse_lora_file(base: StateDict, lora_path: str) -> StateDict:
    """`base` with the kohya LoRA in `lora_path` merged in at the file's
    alpha and rank (JAX `pipelines/loading.py:35`)."""
    adapters, alphas = convert_lora_from_kohya(load_torch_file(lora_path))
    if not adapters:
        raise ValueError(f"no kohya LoRA tensors found in {lora_path}")
    alpha = next(iter(alphas.values()), 8.0)
    rank = next(iter(adapters.values()))["down"].shape[0]
    return merge_lora(base, adapters, alpha=alpha, rank=rank)


def load_bundle_params(
    teacher: Optional[str] = None,
    vae: Optional[str] = None,
    text: Optional[str] = None,
    text_2: Optional[str] = None,
    reverse_lora: Optional[str] = None,
    forward_lora: Optional[str] = None,
    params: Optional[Dict[str, StateDict]] = None,
    dtype: Optional[torch.dtype] = None,
) -> Dict[str, StateDict]:
    """A bundle's state dicts from torch checkpoint files (JAX
    `pipelines/loading.py:44`).

    `params` (an existing dict) supplies anything not given a file. A
    student fuses its LoRA into the teacher; without a LoRA file it shares
    the teacher's weights (the same tensors). A LoRA without a teacher
    raises. `text_2` is SDXL's second text encoder (bigG, transformers'
    `CLIPTextModelWithProjection` keys). `dtype` casts every floating
    tensor."""
    out = dict(params or {})
    if teacher:
        base = load_torch_file(teacher)
        out["teacher"] = out["reverse"] = out["forward"] = base
    if vae:
        out["vae"] = load_torch_file(vae)
    for name, path in (("text", text), ("text_2", text_2)):
        if path:
            out[name] = {k: v for k, v in load_torch_file(path).items() if "position_ids" not in k}
    for name, path in (("reverse", reverse_lora), ("forward", forward_lora)):
        if path:
            if "teacher" not in out:
                raise ValueError("LoRA given without a teacher checkpoint")
            out[name] = _fuse_lora_file(out["teacher"], path)
    if dtype is None:
        return out
    return {
        name: {k: v.to(dtype) if v.is_floating_point() else v for k, v in sd.items()}
        for name, sd in out.items()
    }
