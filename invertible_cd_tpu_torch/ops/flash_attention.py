"""Flash-attention kernels B1-B4 for Hopper, with their plain versions.

PyTorch counterpart of `invertible_cd_tpu/ops/flash_attention.py`:

  * B1 `flash_attention`: head dim <= 256, every UNet self- and
    cross-attention (source `csrc/flash_fwd.cu`, replaces `_fwd_kernel`);
    differentiable through
  * B3 `flash_backward_dq` (`csrc/flash_bwd_dq.cu`, replaces `_dq_kernel`) and
  * B4 `flash_backward_dkdv` (`csrc/flash_bwd_dkdv.cu`, replaces
    `_dkdv_kernel`), tied together by `FlashAttentionFn`;
  * B2 `flash_attention_streamed`: 256 < head dim <= 512, the VAE mid-block
    head (replaces `_fwd_kernel_streamed`), in two builds routed by dtype:
    bf16 (source `csrc/flash_fwd_streamed.cu`; where its grid would leave
    SMs idle it splits the key range and merges the splits in a second
    pass, which counts as the same launch) and fp32 for SDXL's fp32 VAE
    (`csrc/flash_fwd_streamed_f32.cu`, kernel name `flash_fwd_streamed_f32`,
    TF32 tensor-core products with fp32 accumulation); its backward is plain
    PyTorch chunked over key tiles (`attention_backward_chunked`), as the
    reference's is plain XLA.

All take q (B, Sq, H, D) and k/v (B, Sk, H, D), contiguous — the layout the
attention projections produce — bf16 (B2 also fp32), and return
(B, Sq, H, D) in the input dtype. The
row logsumexp that the backward recomputes the probabilities from is fp32
(B, H, Sq), natural log; a forward writes it only when a gradient is needed.

Each kernel is CUDA C++ for sm_90a with a plain C interface: it is compiled
with nvcc into `build/kernels/` at first use (seconds; the library name
carries a hash of the sources, so an edited source rebuilds) and bound with
ctypes. A wrapper given CPU tensors computes the plain version instead (the
backward wrappers the plain explicit backward, not autograd's); given CUDA
tensors it launches its kernel or raises. `LAUNCH_SHAPES` counts kernel
launches per (kernel, Sq, Sk, D); `launches(name)` sums them per kernel.
The logsumexp variants of B1 and B2 count under their kernel's name.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, Iterable, Tuple

import torch

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO, "build", "kernels")

#: kernel name -> (source file, C entry point)
KERNELS: Dict[str, tuple] = {
    "flash_fwd": ("flash_fwd.cu", "icd_flash_fwd"),
    "flash_fwd_streamed": ("flash_fwd_streamed.cu", "icd_flash_fwd_streamed"),
    "flash_fwd_streamed_f32": ("flash_fwd_streamed_f32.cu", "icd_flash_fwd_streamed_f32"),
    "flash_bwd_dq": ("flash_bwd_dq.cu", "icd_flash_bwd_dq"),
    "flash_bwd_dkdv": ("flash_bwd_dkdv.cu", "icd_flash_bwd_dkdv"),
    # B5, the softmax-variant harness: wrapper and plain version in
    # `flash_variant.py`, one entry point per variant
    "flash_variant": ("flash_variant.cu", "icd_flash_variant_base"),
}
#: every library `build` compiles: the attention kernels above and Q1, the
#: int8 implicit GEMM of the int8 layers (wrappers, argument types and plain
#: version in `quant.py`)
LIBRARIES: Dict[str, tuple] = {**KERNELS, "int8_gemm": ("int8_gemm.cu", "icd_int8_gemm")}
_HEADERS = ("flash_common.cuh", "flash_mma.cuh", "flash_wgmma.cuh", "hopper.cuh")
#: C entry point -> number of leading pointer arguments; every entry point is
#: (pointers..., batch, heads, sq, sk, d, scale, stream) -> CUDA error code
_ENTRY_POINTERS: Dict[str, int] = {
    "icd_flash_fwd": 4,                 # q k v o
    "icd_flash_fwd_lse": 5,             # q k v o lse
    "icd_flash_fwd_streamed": 5,        # q k v o workspace
    "icd_flash_fwd_streamed_lse": 6,    # q k v o lse workspace
    "icd_flash_fwd_streamed_f32": 4,    # q k v o
    "icd_flash_fwd_streamed_f32_lse": 5,  # q k v o lse
    "icd_flash_bwd_dq": 7,              # q k v o do lse dq
    "icd_flash_bwd_dkdv": 9,            # q k v o do lse dk dv workspace
}  # B5's entry points are registered by `flash_variant.py`

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
    src, _ = LIBRARIES[name]
    h = hashlib.sha256()
    for f in (src,) + _HEADERS:
        with open(os.path.join(_CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _nvcc_command(name: str, out: str) -> list:
    src, _ = LIBRARIES[name]
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", out, os.path.join(_CSRC, src),
    ]


def build(names: Iterable[str] = tuple(LIBRARIES)) -> Dict[str, str]:
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
    _libs[name] = lib
    return lib


def _entry(name: str, entry: str):
    """The C function `entry` of kernel `name`'s library, with its argument
    types set (a pointer passed without them would be cut to 32 bits)."""
    fn = getattr(_lib(name), entry)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * _ENTRY_POINTERS[entry] + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


# ---------------------------------------------------------------------------
# plain versions (the kernels' references, and the CPU path)
# ---------------------------------------------------------------------------
def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v in fp32 on the (B, S, H, D) layout,
    returned in q's dtype."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 `x` rounded to TF32 (10 mantissa bits) as B2's fp32 build rounds
    its operands (cvt.rna.tf32.f32: to nearest, ties away from zero); the
    plain versions on rounded inputs model its products."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def attention_plain_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`attention_plain` and the fp32 row logsumexp of the scaled logits,
    (B, H, Sq), natural log."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None])
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype), lse


def attention_backward_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The explicit flash backward in fp32, as B3 and B4 compute it: P is
    recomputed from `lse`, delta = rowsum(dO * O), dS = P * (dP - delta),
    dQ = scale dS K, dK = scale dS^T Q, dV = P^T dO. Returns (dq, dk, dv) in
    the dtypes of q, k, v."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    probs = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale - lse[..., None])
    delta = (dof * o.float()).sum(-1).permute(0, 2, 1)  # (B, H, Sq)
    dprobs = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = probs * (dprobs - delta[..., None])
    dq = scale * torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", probs, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_backward_chunked(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, block_k: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The same backward, one key tile at a time, so that only (B, H, Sq,
    block_k) fp32 intermediates exist at once: B2's backward (counterpart of
    `_streamed_backward_xla`; the large-head shapes are not under grad on any
    hot path, so this favours bounded memory over speed). dS and P are
    rounded to the input dtype before their products, as there."""
    scale = q.shape[-1] ** -0.5
    qf, dof = q.float(), do.float()
    delta = (dof * o.float()).sum(-1).permute(0, 2, 1)[..., None]  # (B, H, Sq, 1)
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for start in range(0, k.shape[1], block_k):
        k_t = k[:, start:start + block_k].float()
        v_t = v[:, start:start + block_k].float()
        probs = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qf, k_t) * scale - lse[..., None])
        dprobs = torch.einsum("bqhd,bkhd->bhqk", dof, v_t)
        ds = (probs * (dprobs - delta) * scale).to(q.dtype).float()
        dq += torch.einsum("bhqk,bkhd->bqhd", ds, k_t)
        dks.append(torch.einsum("bhqk,bqhd->bkhd", ds, qf).to(k.dtype))
        dvs.append(torch.einsum("bhqk,bqhd->bkhd", probs.to(do.dtype).float(), dof).to(v.dtype))
    return dq.to(q.dtype), torch.cat(dks, dim=1), torch.cat(dvs, dim=1)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _check_tensor(name: str, t: torch.Tensor, like: torch.Tensor, dtype=torch.bfloat16):
    if t.device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}; every tensor must be on one CUDA device")
    if t.device != like.device:
        raise ValueError(f"{name} lies on another device than q")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}; the kernel takes {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check(q, k, v, max_d: int, min_d: int, dtype=torch.bfloat16):
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_tensor(name, t, q, dtype)
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, S, H, D), got {tuple(t.shape)}")
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if not (min_d < d <= max_d) or d % 8:
        raise ValueError(f"head dim {d} outside ({min_d}, {max_d}] or not a multiple of 8")
    if sq == 0 or k.shape[1] == 0 or b * h > 65535:
        raise ValueError(f"unsupported shape q {tuple(q.shape)} k {tuple(k.shape)}")


def _check_backward(q, k, v, o, lse, do):
    _check(q, k, v, max_d=256, min_d=0)
    for name, t in (("o", o), ("do", do)):
        _check_tensor(name, t, q)
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} must have q's shape {tuple(q.shape)}")
    _check_tensor("lse", lse, q, dtype=torch.float32)
    b, sq, h, _ = q.shape
    if tuple(lse.shape) != (b, h, sq):
        raise ValueError(f"lse {tuple(lse.shape)} must be (B, H, Sq) = {(b, h, sq)}")


def _launch(name: str, entry: str, q, k, pointers) -> None:
    """Launch `entry` of kernel `name` on q's device and current stream and
    count it; raises if the launch is refused."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    fn = _entry(name, entry)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = fn(*(t.data_ptr() for t in pointers), b, h, sq, sk, d, float(d) ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed with CUDA error {rc}")
    LAUNCH_SHAPES[(name, sq, sk, d)] += 1


def _forward(name: str, q, k, v, with_lse: bool):
    """Kernel B1 on checked CUDA tensors -> (o, lse or None)."""
    o = torch.empty_like(q)
    entry = KERNELS[name][1]
    if not with_lse:
        _launch(name, entry, q, k, (q, k, v, o))
        return o, None
    b, sq, h, _ = q.shape
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _launch(name, entry + "_lse", q, k, (q, k, v, o, lse))
    return o, lse


def pad_rows(t: torch.Tensor, multiple: int) -> torch.Tensor:
    """(B, S, H, D) `t` with S zero-padded up to a multiple of `multiple`
    (`t` itself when it is one already)."""
    extra = -t.shape[1] % multiple
    return t if extra == 0 else torch.nn.functional.pad(t, (0, 0, 0, 0, 0, extra))


def _forward_streamed(q, k, v, with_lse: bool):
    """Kernel B2 on checked CUDA tensors -> (o, lse or None). Its TMA copies
    read K and V in whole groups of 8 rows, so a ragged Sk is zero-padded
    here (a copy of K and V, never at the VAE's 4096 tokens); the count of
    keys the kernel attends to stays Sk."""
    k8, v8 = pad_rows(k, 8), pad_rows(v, 8)
    o = torch.empty_like(q)
    entry = KERNELS["flash_fwd_streamed"][1]
    work = _workspace("flash_fwd_streamed", q, k)
    if not with_lse:
        _launch("flash_fwd_streamed", entry, q, k, (q, k8, v8, o, work))
        return o, None
    b, sq, h, _ = q.shape
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _launch("flash_fwd_streamed", entry + "_lse", q, k, (q, k8, v8, o, lse, work))
    return o, lse


def _forward_streamed_f32(q, k, v, with_lse: bool):
    """Kernel B2's fp32 build on checked CUDA tensors -> (o, lse or None).
    Its copies bound-check every row, so a ragged Sk needs no padding."""
    o = torch.empty_like(q)
    name = "flash_fwd_streamed_f32"
    if not with_lse:
        _launch(name, KERNELS[name][1], q, k, (q, k, v, o))
        return o, None
    b, sq, h, _ = q.shape
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _launch(name, KERNELS[name][1] + "_lse", q, k, (q, k, v, o, lse))
    return o, lse


def flash_forward_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Kernel B1 writing the logsumexp as well -> (o, lse (B, H, Sq) fp32).
    CPU tensors take `attention_plain_lse`."""
    if q.device.type == "cpu":
        return attention_plain_lse(q, k, v)
    _check(q, k, v, max_d=256, min_d=0)
    return _forward("flash_fwd", q, k, v, with_lse=True)


def flash_backward_dq(q, k, v, o, lse, do) -> torch.Tensor:
    """Kernel B3: dQ of softmax(q k^T / sqrt(d)) v given o, lse and dO.
    CPU tensors take `attention_backward_plain`."""
    if q.device.type == "cpu":
        return attention_backward_plain(q, k, v, o, lse, do)[0]
    _check_backward(q, k, v, o, lse, do)
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq", KERNELS["flash_bwd_dq"][1], q, k, (q, k, v, o, do, lse, dq))
    return dq


def _workspace(name: str, q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Kernel `name`'s scratch on q's device, sized by the kernel's own plan
    (its C function `<entry>_workspace`): B4's per query row (lse * log2 e,
    delta) and, where the query tiles are split, fp32 partial dK and dV;
    B2's fp32 partial outputs and (m, l) where the key tiles are split
    (none otherwise)."""
    fn = getattr(_lib(name), KERNELS[name][1] + "_workspace")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 5
        fn.restype = ctypes.c_size_t
    b, sq, h, d = q.shape
    with torch.cuda.device(q.device):
        nbytes = fn(b, h, sq, k.shape[1], d)
    return torch.empty(nbytes, dtype=torch.uint8, device=q.device)


def flash_backward_dkdv(q, k, v, o, lse, do) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B4: (dK, dV) of the same function (its row pre-pass and, for
    split query tiles, its summing pass included: one launch). CPU tensors
    take `attention_backward_plain`."""
    if q.device.type == "cpu":
        return attention_backward_plain(q, k, v, o, lse, do)[1:]
    _check_backward(q, k, v, o, lse, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    work = _workspace("flash_bwd_dkdv", q, k)
    _launch("flash_bwd_dkdv", KERNELS["flash_bwd_dkdv"][1], q, k,
            (q, k, v, o, do, lse, dk, dv, work))
    return dk, dv


def _needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether a backward can follow this call (inside a Function's forward
    grad mode is always off, so this is decided before `apply`)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class FlashAttentionFn(torch.autograd.Function):
    """B1 forward (with the logsumexp only when a gradient is needed), B3
    and B4 backward. On CPU tensors the plain forward and the plain explicit
    backward run through the same Function."""

    @staticmethod
    def forward(ctx, q, k, v, need_grad: bool):
        if q.device.type == "cpu":
            o, lse = attention_plain_lse(q, k, v) if need_grad else (attention_plain(q, k, v), None)
        else:
            _check(q, k, v, max_d=256, min_d=0)
            o, lse = _forward("flash_fwd", q, k, v, with_lse=need_grad)
        if need_grad:
            ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        dq = flash_backward_dq(q, k, v, o, lse, do)
        dk, dv = flash_backward_dkdv(q, k, v, o, lse, do)
        return dq, dk, dv, None


class FlashAttentionStreamedFn(torch.autograd.Function):
    """B2 forward, its bf16 or fp32 build by the inputs' dtype (any other
    dtype raises); the backward is `attention_backward_chunked`."""

    @staticmethod
    def forward(ctx, q, k, v, need_grad: bool):
        if q.device.type == "cpu":
            o, lse = attention_plain_lse(q, k, v) if need_grad else (attention_plain(q, k, v), None)
        elif q.dtype == torch.float32:
            _check(q, k, v, max_d=512, min_d=256, dtype=torch.float32)
            o, lse = _forward_streamed_f32(q, k, v, with_lse=need_grad)
        else:
            _check(q, k, v, max_d=512, min_d=256)
            o, lse = _forward_streamed(q, k, v, with_lse=need_grad)
        if need_grad:
            ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*attention_backward_chunked(q, k, v, o, lse, do.to(q.dtype)), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Kernel B1 (head dim <= 256), differentiable through B3 and B4. CPU
    tensors take the plain versions."""
    return FlashAttentionFn.apply(q, k, v, _needs_grad(q, k, v))


def flash_attention_streamed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Kernel B2 (256 < head dim <= 512; bf16, or fp32 through its fp32
    build), differentiable through the chunked plain backward. CPU tensors
    take the plain versions."""
    return FlashAttentionStreamedFn.apply(q, k, v, _needs_grad(q, k, v))
