"""Checkpoint / resume with rotation.

PyTorch counterpart of `save_checkpoint`, `latest_step` and
`restore_checkpoint` in `invertible_cd_tpu/training/checkpoint.py`: every
save writes both students' LoRA, both optimizer states and the step as one
file `<ckpt_dir>/<step>/state.pt` (`torch.save` of plain dicts of tensors,
ints and bools), and rotation keeps the newest `keep` checkpoints.
`export_inference` / `load_inference_lora` write and read both students'
adapters in kohya's safetensors format, the reference's inference artifact
(written by the `safetensors` package, read by `models.convert`'s reader).
Under a mesh (`parallel.make_mesh`) rank 0 writes and every rank waits for
it at a barrier, so each rank may restore right after.
"""
from __future__ import annotations

import dataclasses
import os
import re
import shutil
from typing import Dict, List, Optional

import torch

from ..models.convert import convert_lora_from_kohya, export_lora_to_kohya, load_torch_file
from ..parallel import barrier, is_main
from .trainer import ICDTrainState

_FILE = "state.pt"


def _steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(
        int(name) for name in os.listdir(ckpt_dir)
        if re.fullmatch(r"\d+", name) and os.path.exists(os.path.join(ckpt_dir, name, _FILE))
    )


def _as_dict(state: ICDTrainState) -> dict:
    """The state's fields by name (no copy of the tensors)."""
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}


def save_checkpoint(ckpt_dir: str, state: ICDTrainState, keep: Optional[int] = 5,
                    mesh=None) -> int:
    """Write a checkpoint at the state's step; rotate old ones. The file
    appears under its final name only when it is complete. With `mesh`, on
    rank 0 only, and every rank returns once it is written."""
    step = int(state.step)
    if is_main(mesh):
        _write_checkpoint(ckpt_dir, state, keep)
    barrier(mesh)
    return step


def _write_checkpoint(ckpt_dir: str, state: ICDTrainState, keep: Optional[int]) -> None:
    step = int(state.step)
    step_dir = os.path.join(os.path.abspath(ckpt_dir), str(step))
    os.makedirs(step_dir, exist_ok=True)
    tmp = os.path.join(step_dir, f"{_FILE}.{os.getpid()}.tmp")
    torch.save(_as_dict(state), tmp)
    os.replace(tmp, os.path.join(step_dir, _FILE))
    if keep is not None:
        for old in _steps(ckpt_dir)[:-keep]:
            shutil.rmtree(os.path.join(ckpt_dir, str(old)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest checkpoint step under `ckpt_dir`."""
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def _check_like(path: str, got, want) -> None:
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise ValueError(f"checkpoint entry {path or '<root>'} does not match the template")
        for key in want:
            _check_like(f"{path}/{key}", got[key], want[key])
    elif isinstance(want, torch.Tensor):
        if not isinstance(got, torch.Tensor) or got.shape != want.shape or got.dtype != want.dtype:
            raise ValueError(f"checkpoint tensor {path} does not match the template")


def restore_checkpoint(
    ckpt_dir: str, template: ICDTrainState, step: Optional[int] = None
) -> ICDTrainState:
    """Restore the checkpoint at `step` (the newest when None) onto the
    device of `template`, whose structure, shapes and dtypes it must match."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, str(step), _FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint at step {step} under {ckpt_dir}")
    device = next(iter(template.lora_reverse.values()))["down"].device
    tree = torch.load(path, map_location=device, weights_only=True)
    _check_like("", tree, _as_dict(template))
    return ICDTrainState(**tree)


def export_inference(out_dir: str, state: ICDTrainState, lora_alpha: float = 8.0,
                     mesh=None) -> Dict[str, str]:
    """Write both students' adapters as kohya-format LoRA safetensors:
    `<out_dir>/unet_lora/lora_weights.safetensors` (reverse) and
    `<out_dir>/forward_unet_lora/lora_weights.safetensors` (forward), the
    JAX package's layout and keys. Returns name -> path. With `mesh`, rank 0
    writes and every rank returns once the files are there."""
    from safetensors.torch import save_file

    paths = {}
    for name, lora in (("unet_lora", state.lora_reverse), ("forward_unet_lora", state.lora_forward)):
        d = os.path.join(out_dir, name)
        path = paths[name] = os.path.join(d, "lora_weights.safetensors")
        if is_main(mesh):
            os.makedirs(d, exist_ok=True)
            # the file holds each tensor's storage: a view must be made contiguous
            flat = {k: v.contiguous() for k, v in export_lora_to_kohya(lora, alpha=lora_alpha).items()}
            save_file(flat, path)
    barrier(mesh)
    return paths


def load_inference_lora(path: str):
    """A kohya LoRA safetensors file back into (adapters, {key: alpha}), CPU
    tensors (`models.convert.convert_lora_from_kohya`)."""
    return convert_lora_from_kohya(load_torch_file(path))
