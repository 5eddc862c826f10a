"""Flash-attention forward kernels B1 and B2 for Hopper, with their plain versions.

PyTorch counterpart of `invertible_cd_tpu/ops/flash_attention.py`'s two
forward kernels (the backward kernels come with training):

  * B1 `flash_attention`: head dim <= 256, every UNet self- and
    cross-attention (source `csrc/flash_fwd.cu`, replaces `_fwd_kernel`);
  * B2 `flash_attention_streamed`: 256 < head dim <= 512, the VAE mid-block
    head (source `csrc/flash_fwd_streamed.cu`, replaces
    `_fwd_kernel_streamed`).

Both take q (B, Sq, H, D) and k/v (B, Sk, H, D), bf16 and contiguous — the
layout the attention projections produce — and return (B, Sq, H, D).

Each kernel is CUDA C++ for sm_90a with a plain C interface: it is compiled
with nvcc into `build/kernels/` at first use (seconds; the library name
carries a hash of the sources, so an edited source rebuilds) and bound with
ctypes. A wrapper given CPU tensors computes the plain version instead; given
CUDA tensors it launches its kernel or raises. `LAUNCH_SHAPES` counts
kernel launches per (kernel, Sq, Sk, D); `launches(name)` sums them per
kernel.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, Iterable

import torch

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO, "build", "kernels")

#: kernel name -> (source file, C entry point)
KERNELS: Dict[str, tuple] = {
    "flash_fwd": ("flash_fwd.cu", "icd_flash_fwd"),
    "flash_fwd_streamed": ("flash_fwd_streamed.cu", "icd_flash_fwd_streamed"),
}
_HEADERS = ("flash_common.cuh",)

LAUNCH_SHAPES: collections.Counter = collections.Counter()

_libs: Dict[str, ctypes.CDLL] = {}
_build_lock = threading.Lock()


def reset_launch_counts() -> None:
    LAUNCH_SHAPES.clear()


def launches(name: str) -> int:
    """Kernel launches of `name` since the last reset."""
    return sum(n for key, n in LAUNCH_SHAPES.items() if key[0] == name)


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------
def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found at {path}; set CUDA_HOME")
    return path


def library_path(name: str) -> str:
    """Path of the built library for `name`; the hash covers its sources."""
    src, _ = KERNELS[name]
    h = hashlib.sha256()
    for f in (src,) + _HEADERS:
        with open(os.path.join(_CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _nvcc_command(name: str, out: str) -> list:
    src, _ = KERNELS[name]
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", out, os.path.join(_CSRC, src),
    ]


def build(names: Iterable[str] = tuple(KERNELS)) -> Dict[str, str]:
    """Compile every kernel in `names` that is not built yet, one nvcc
    process per source, all started together. Returns name -> nvcc's
    output (the -Xptxas -v register and shared-memory report)."""
    with _build_lock:
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = {}
        for name in names:
            path = library_path(name)
            if os.path.exists(path):
                continue
            tmp = f"{path}.{os.getpid()}.tmp"
            procs[name] = (
                subprocess.Popen(
                    _nvcc_command(name, tmp),
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                ),
                tmp, path,
            )
        reports = {}
        failed = []
        for name, (proc, tmp, path) in procs.items():
            out, _ = proc.communicate()
            reports[name] = out
            if proc.returncode != 0:
                failed.append(f"{name}:\n{out}")
                continue
            os.replace(tmp, path)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return reports


def _lib(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is not None:
        return lib
    path = library_path(name)
    if not os.path.exists(path):
        build([name])
    lib = ctypes.CDLL(path)
    fn = getattr(lib, KERNELS[name][1])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    _libs[name] = lib
    return lib


# ---------------------------------------------------------------------------
# plain version (the kernels' reference, and the CPU path)
# ---------------------------------------------------------------------------
def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v in fp32 on the (B, S, H, D) layout,
    returned in q's dtype."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------
def _check(q, k, v, max_d: int, min_d: int):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; all of q, k, v must be on one CUDA device")
        if t.device != q.device:
            raise ValueError("q, k, v lie on different devices")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes bfloat16")
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, S, H, D), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if not (min_d < d <= max_d) or d % 8:
        raise ValueError(f"head dim {d} outside ({min_d}, {max_d}] or not a multiple of 8")
    if sq == 0 or k.shape[1] == 0 or b * h > 65535:
        raise ValueError(f"unsupported shape q {tuple(q.shape)} k {tuple(k.shape)}")


def _launch(name: str, q, k, v) -> torch.Tensor:
    b, sq, h, d = q.shape
    sk = k.shape[1]
    o = torch.empty_like(q)
    fn = getattr(_lib(name), KERNELS[name][1])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                b, h, sq, sk, d, float(d) ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")
    LAUNCH_SHAPES[(name, sq, sk, d)] += 1
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Kernel B1 (head dim <= 256). CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    _check(q, k, v, max_d=256, min_d=0)
    return _launch("flash_fwd", q, k, v)


def flash_attention_streamed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Kernel B2 (256 < head dim <= 512). CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    _check(q, k, v, max_d=512, min_d=256)
    return _launch("flash_fwd_streamed", q, k, v)
