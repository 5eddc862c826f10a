"""Int8 W8A8 inference: the quantisation scope, the quantisers and kernels Q1 and Q2.

PyTorch counterpart of `invertible_cd_tpu/ops/quant.py`. Enablement is a
scope read when a layer RUNS (the port is eager; the JAX package reads it
when a program is traced):

    with quant_scope("int8"):
        eps = unet(latent, t, context)     # QLinear / QConv2d run int8

`models.layers.QLinear` / `QConv2d` subclass `nn.Linear` / `nn.Conv2d`
(same state-dict keys, same LoRA paths) and check `current_quant_mode()`
on every call; outside an int8 scope they are exactly their base class.

  * weights: symmetric per-output-feature int8 (scale = amax / 127 over the
    input dims). JAX re-quantises them inside its program on every call;
    the port quantises a weight once and keeps the codes on its layer until
    the weight changes (`weight_codes`), the same codes bit for bit;
  * activations: dynamic symmetric int8, one scale per row (token) for a
    dense layer, one per tensor (batch included) for a convolution; under
    "int8_static" a convolution with a calibrated amax uses it instead.
    Kernel Q2 (`csrc/int8_quantize.cu`, `quantize_activation`) writes the
    codes in the layout Q1 reads: (rows, K) for a dense layer, NHWC for a
    convolution, the last dim padded to a multiple of 16 with zero codes;
  * the product: kernel Q1 (`csrc/int8_gemm.cu`), an int8 implicit GEMM with
    exact int32 accumulation and the epilogue fused: the dequantising
    `float(acc) * (s_row * s_col)` (the scales multiplied first, as in
    JAX), the cast to the layer's dtype, and the bias added in that dtype,
    as flax's Dense and Conv add it.

On the card a Q-layer call is Q2 (one launch; a convolution's dynamic amax
and its codes in one cooperative launch with a grid barrier), the output's
allocation and Q1. Neither kernel replaces a TPU
kernel: JAX leaves the quantisers and the int8 products to XLA
(`lax.dot_general` / `lax.conv_general_dilated` at int32), and PyTorch has
no int8 convolution on CUDA. Given CUDA tensors, `int8_gemm` and
`quantize_activation` launch their kernels or raise (a failed build is an
error); given CPU tensors they compute `int8_gemm_plain` (the same products
in float64, exact for |acc| < 2^53, rounded back to int32, then the same
epilogue) and `quantize_activation_plain`. Launches count in
`flash_attention.LAUNCH_SHAPES` under ("int8_gemm", batch, H, W, C, N, kh,
kw, stride, padding, output dtype) and ("int8_quantize", form, shape...,
input dtype) (form "rows", "rows_amax", "tensor", "static", or "amax" for
`tensor_amax`); weight quantisations in `WEIGHT_QUANTIZATIONS`.

The quantisers (amax, multiply by the precomputed reciprocal, round half to
even, clip, int8) take JAX's IEEE steps: on fp32 input their codes and
scales equal those of JAX's compiled programs bit for bit.

Modes:
  off          bit-identical to the plain layers, no Q1 launch;
  int8         dynamic scales (per-token dense, per-tensor conv);
  int8_static  like int8, but a convolution whose name is in the scope's
               stats uses max(amax, 1e-12) as its activation amax; dense
               layers stay dynamic; convolutions without stats stay dynamic;
  calibrate    float maths; each QConv2d's running max of |input| (fp32) is
               recorded into the scope's stats dict under its module name.

INFERENCE ONLY: the int8 path is a `torch.autograd.Function` whose backward
returns zeros for the input and the weight (JAX's round has zero gradient;
the only other path there, through the amax's argmax element, is dropped).
The trainer never enters a scope.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import ctypes
import dataclasses
import weakref
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import flash_attention as fa

#: Modes understood by `quant_scope` and the Q-layers.
MODES = ("off", "int8", "int8_static", "calibrate")
INT8_MODES = ("int8", "int8_static")

# Q1's entry points: (a, b, s_row, s_col, out, batch, h, w, c, n, kh, kw,
# stride_h, stride_w, pad_h, pad_w, row_scale_stride, out_kind, stream) and
# (a, b, out, batch, ..., pad_w, stream) for the int32 accumulators
_OUT_KIND = {torch.float32: 1, torch.bfloat16: 2}


@dataclasses.dataclass(frozen=True)
class _Scope:
    mode: str
    stats: Optional[Dict[str, torch.Tensor]]
    names: Optional[Dict[torch.nn.Module, str]]


_SCOPE: contextvars.ContextVar = contextvars.ContextVar(
    "icd_torch_quant_scope", default=_Scope("off", None, None))


def current_quant_mode() -> str:
    """The quantisation mode of the innermost active scope ("off" outside)."""
    return _SCOPE.get().mode


@contextlib.contextmanager
def quant_scope(mode: str, stats: Optional[Dict[str, torch.Tensor]] = None,
                root: Optional[torch.nn.Module] = None):
    """Activate a quantisation mode for the layers run inside the block.

    `stats` ({module name under `root`: amax}) is what "int8_static" reads
    and what "calibrate" writes into (in place); `root` is the model those
    names are relative to. The scope nests and is reset on an exception."""
    if mode not in MODES:
        raise ValueError(f"unknown quant mode {mode!r}; expected one of {MODES}")
    if mode == "calibrate" and stats is None:
        raise ValueError("quant_scope('calibrate') needs a stats dict to record into")
    names = None
    if root is not None and mode in ("calibrate", "int8_static"):
        names = {m: n for n, m in root.named_modules()}  # submodule -> its state-dict prefix
    token = _SCOPE.set(_Scope(mode, stats, names))
    try:
        yield
    finally:
        _SCOPE.reset(token)


def _layer_name(layer: torch.nn.Module) -> Optional[str]:
    scope = _SCOPE.get()
    return None if scope.names is None else scope.names.get(layer)


def record_amax(layer: torch.nn.Module, x: torch.Tensor) -> None:
    """Calibration: fold max|x| (fp32) into the scope's stats under the
    layer's name (running max over calls)."""
    scope = _SCOPE.get()
    name = _layer_name(layer)
    if name is None:
        raise ValueError("quant_scope('calibrate') needs the root model (`root=`) that holds this layer")
    amax = x.detach().float().abs().amax()
    old = scope.stats.get(name)
    scope.stats[name] = amax if old is None else torch.maximum(old, amax)


def static_amax(layer: torch.nn.Module) -> Optional[torch.Tensor]:
    """The calibrated activation amax of `layer` under "int8_static", or
    None (the layer then quantises dynamically)."""
    scope = _SCOPE.get()
    if scope.mode != "int8_static" or scope.stats is None:
        return None
    name = _layer_name(layer)
    return None if name is None else scope.stats.get(name)


# ---------------------------------------------------------------------------
# quantisers (plain PyTorch, JAX's IEEE steps)
# ---------------------------------------------------------------------------
def _amax(x: torch.Tensor, axes: Optional[Sequence[int]] = None) -> torch.Tensor:
    xf = x.float().abs()
    a = xf.amax() if axes is None else xf.amax(dim=tuple(axes))
    # an all-zero slice would give scale 0 and inf/nan on dequant; 1.0 keeps q = 0
    return torch.where(a > 0, a, torch.ones_like(a))


def tensor_amax_plain(x: torch.Tensor) -> torch.Tensor:
    """`tensor_amax`'s plain version: max |x| in fp32, 1.0 for an all-zero
    tensor, shape (1,)."""
    return _amax(x).reshape(1)


def _quantize_with(x: torch.Tensor, amax: torch.Tensor, axes: Optional[Sequence[int]]) -> torch.Tensor:
    # a PRECOMPUTED reciprocal multiply, not a divide (JAX `quant.py:188-198`)
    r = 127.0 / amax
    if axes is not None:
        shape = [1 if d in [a % x.dim() for a in axes] else s for d, s in enumerate(x.shape)]
        r = r.reshape(shape)
    q = torch.round(x.float() * r)  # half to even, as jnp.round
    return q.clamp_(-127, 127).to(torch.int8)


def _scale(amax: torch.Tensor) -> torch.Tensor:
    # JAX writes amax / 127.0; XLA rewrites a division by a constant into a
    # multiply by its fp32 reciprocal in every compiled program (the
    # pipelines' and the models' applies), so the scales of JAX as it runs
    # are amax * f32(1/127) (eager JAX divides: 1 ulp apart on ~4% of values)
    return amax * (1.0 / 127.0)


def quantize_int8(
    x: torch.Tensor, axes: Optional[Sequence[int]] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantisation: (q int8, scale fp32) with x ~= q * scale.

    `axes`: the dims the amax reduces over. None -> one scalar scale;
    otherwise one scale per remaining index (axes=(1, 2, 3) on an OIHW conv
    weight gives per-output-channel scales)."""
    amax = _amax(x, axes)
    return _quantize_with(x, amax, axes), _scale(amax)


# ---------------------------------------------------------------------------
# kernel Q2, the quantising pass, and its plain version
# ---------------------------------------------------------------------------
#: Q1 reads the reduction's innermost dim (C of a convolution, K of a dense
#: layer) in 16-byte vectors: Q2 and the weight codes pad it with zero codes
PAD = 16
_IN_KIND = {torch.float32: 1, torch.bfloat16: 2}


def padded(c: int) -> int:
    """`c` rounded up to a multiple of `PAD`."""
    return -(-c // PAD) * PAD


def _pad_last(q: torch.Tensor) -> torch.Tensor:
    c = q.shape[-1]
    return (F.pad(q, (0, padded(c) - c)) if c % PAD else q).contiguous()


def quantize_activation_plain(x: torch.Tensor, per_row: bool,
                              amax: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Q2's plain version. per_row (a dense layer's input (..., K)): codes
    (rows, Kp) and one scale a row, from each row's amax or from `amax`
    (rows,), the amax of rows whose features are split over ranks (an
    all-zero row's 0 taken as 1.0, as the dynamic path does). Otherwise (a
    convolution's NCHW input):
    codes (B, H, W, Cp), NHWC, and one scale (1,), from the tensor's amax or,
    under "int8_static", the calibrated `amax` floored at 1e-12. Kp and Cp
    are K and C padded to a multiple of 16 with zero codes; the codes and
    scales are `quantize_int8`'s bit for bit."""
    if per_row:
        rows = x.reshape(-1, x.shape[-1])
        if amax is None:
            q, s = quantize_int8(rows, axes=(1,))
        else:
            amax = amax.to(device=x.device, dtype=torch.float32).reshape(-1)
            amax = torch.where(amax > 0, amax, torch.ones_like(amax))
            q, s = _quantize_with(rows, amax, (1,)), _scale(amax)
        return _pad_last(q), s
    if amax is None:
        q, s = quantize_int8(x)
    else:
        amax = torch.clamp_min(amax.to(device=x.device, dtype=torch.float32), 1e-12)
        q, s = _quantize_with(x, amax, None), _scale(amax)
    return _pad_last(q.permute(0, 2, 3, 1)), s.reshape(1)


_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRIES: Dict[str, object] = {}
_DTYPE_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.int32: "int32"}


def _entry(lib: str, name: str, argtypes, restype=ctypes.c_int):
    """A kernel library's C entry point, argument types set once."""
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = getattr(fa._lib(lib), name)
        fn.argtypes, fn.restype = argtypes, restype
        _ENTRIES[name] = fn
    return fn


def _launch(device: torch.device, fn, *args) -> None:
    """fn(*args, stream) on `device`'s current stream (the device made
    current for the call where it is not); raises on a CUDA error."""
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return _launch(device, fn, *args)
    rc = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed with CUDA error {rc}")


# (x, x_kind, q, scale, rows, k, kp, stream); the same with the rows' amax
# after scale; (x, x_kind, channels_last, q, scale, amax, workspace, batch,
# c, h, w, cp, stream); (x, x_kind, out, workspace, n, stream)
_ROWS_ARGS = [_P, _I, _P, _P, ctypes.c_longlong, _I, _I, _P]
_ROWS_AMAX_ARGS = [_P, _I, _P, _P, _P, ctypes.c_longlong, _I, _I, _P]
_TENSOR_ARGS = [_P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
_AMAX_ARGS = [_P, _I, _P, _P, ctypes.c_longlong, _P]


def _workspace(device: torch.device) -> torch.Tensor:
    """Q2's workspace: the blocks' partial amaxes, read after its grid
    barrier."""
    return torch.empty(_entry("int8_quantize", "icd_quantize_workspace_floats", [])(), dtype=torch.float32,
                       device=device)


def _dense(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """x as it lies in memory for Q2's tensor form: (x, 0) when contiguous,
    (x, 1) when channels-last, else (a contiguous copy, 0)."""
    if x.is_contiguous():
        return x, 0
    if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
        return x, 1
    return x.contiguous(), 0


def tensor_amax(x: torch.Tensor) -> torch.Tensor:
    """A convolution's dynamic activation amax (one fp32 value, 1.0 for an
    all-zero tensor), for a caller that reduces it over ranks and passes it
    on as the `amax` of `int8_conv2d`, which then quantises with it as the
    dynamic path would. On CUDA Q2's amax pass alone (one launch, counted
    under ("int8_quantize", "amax", shape..., dtype)); CPU tensors take
    `tensor_amax_plain`."""
    if x.device.type == "cpu":
        return tensor_amax_plain(x)
    if x.dtype not in _IN_KIND:
        raise TypeError(f"Q2 reads bf16 or fp32, not {x.dtype}")
    x, _ = _dense(x)
    out = torch.empty(1, dtype=torch.float32, device=x.device)
    _launch(x.device, _entry("int8_quantize", "icd_quantize_tensor_amax", _AMAX_ARGS), x.data_ptr(),
            _IN_KIND[x.dtype], out.data_ptr(), _workspace(x.device).data_ptr(), x.numel())
    fa.LAUNCH_SHAPES[("int8_quantize", "amax", *x.shape, _DTYPE_NAME[x.dtype])] += 1
    return out


def quantize_key(x: torch.Tensor, per_row: bool, static: bool = False) -> tuple:
    """The `LAUNCH_SHAPES` key of one Q2 launch."""
    if per_row:
        return ("int8_quantize", "rows_amax" if static else "rows", x.numel() // x.shape[-1],
                x.shape[-1], _DTYPE_NAME[x.dtype])
    return ("int8_quantize", "static" if static else "tensor", *x.shape, _DTYPE_NAME[x.dtype])


def quantize_activation(x: torch.Tensor, per_row: bool,
                        amax: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel Q2 (`csrc/int8_quantize.cu`): `quantize_activation_plain`'s
    codes and scales, bit for bit, in one kernel launch (dense, with each
    row's amax or with the rows' `amax` read on the device; a convolution
    with its dynamic amax, or with a calibrated `amax`). CPU tensors take
    the plain version."""
    if x.device.type == "cpu":
        return quantize_activation_plain(x, per_row, amax)
    if x.dtype not in _IN_KIND:
        raise TypeError(f"Q2 reads bf16 or fp32, not {x.dtype}")
    dev = x.device
    if per_row:
        k = x.shape[-1]
        rows = x.reshape(-1, k)
        if not rows.is_contiguous():
            rows = rows.contiguous()
        m = rows.shape[0]
        q = torch.empty((m, padded(k)), dtype=torch.int8, device=dev)
        s = torch.empty(m, dtype=torch.float32, device=dev)
        if amax is None:
            _launch(dev, _entry("int8_quantize", "icd_quantize_rows", _ROWS_ARGS), rows.data_ptr(),
                    _IN_KIND[x.dtype], q.data_ptr(), s.data_ptr(), m, k, q.shape[1])
        else:
            amax = amax.to(device=dev, dtype=torch.float32).reshape(-1).contiguous()
            if amax.numel() != m:
                raise ValueError(f"{amax.numel()} row amaxes for {m} rows")
            _launch(dev, _entry("int8_quantize", "icd_quantize_rows_amax", _ROWS_AMAX_ARGS),
                    rows.data_ptr(), _IN_KIND[x.dtype], q.data_ptr(), s.data_ptr(), amax.data_ptr(),
                    m, k, q.shape[1])
        fa.LAUNCH_SHAPES[quantize_key(x, True, amax is not None)] += 1
        return q, s
    if x.dim() != 4:
        raise ValueError(f"Q2 takes a (B, C, H, W) activation, not {tuple(x.shape)}")
    x, channels_last = _dense(x)
    b, c, h, w = x.shape
    q = torch.empty((b, h, w, padded(c)), dtype=torch.int8, device=dev)
    s = torch.empty(1, dtype=torch.float32, device=dev)
    if amax is None:
        amax_ptr, ws_ptr = None, _workspace(dev).data_ptr()
    else:
        amax = amax.to(device=dev, dtype=torch.float32).reshape(1)
        amax_ptr, ws_ptr = amax.data_ptr(), None
    _launch(dev, _entry("int8_quantize", "icd_quantize_tensor", _TENSOR_ARGS), x.data_ptr(),
            _IN_KIND[x.dtype], channels_last, q.data_ptr(), s.data_ptr(), amax_ptr, ws_ptr, b, c, h, w,
            q.shape[3])
    fa.LAUNCH_SHAPES[quantize_key(x, False, amax is not None)] += 1
    return q, s


# ---------------------------------------------------------------------------
# the weight codes, quantised once a weight
# ---------------------------------------------------------------------------
#: weight quantisations per (weight shape, dtype); `weight_quantizations` sums them
WEIGHT_QUANTIZATIONS = collections.Counter()


def quantize_weight(weight: torch.Tensor, amax: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A Q-layer's weight codes as Q1 reads them: per-output-feature codes
    (N, 1, 1, Kp) of a dense (N, K) weight, (N, kh, kw, Cp) of an OIHW conv
    weight (K and C padded to a multiple of 16 with zero codes), and the
    fp32 scales (N,): `quantize_int8(weight, axes=...)` bit for bit, laid
    out. `amax` (N,): a dense weight's per-output amax to quantise with
    instead of its own (a slice of in-features takes the whole weight's, so
    its codes are the whole weight's codes, sliced). Plain PyTorch: it runs
    once a weight."""
    with torch.no_grad():
        if weight.dim() == 2:
            if amax is None:
                q, s = quantize_int8(weight, axes=(1,))
            else:
                amax = amax.to(device=weight.device, dtype=torch.float32)
                amax = torch.where(amax > 0, amax, torch.ones_like(amax))
                q, s = _quantize_with(weight, amax, (1,)), _scale(amax)
            codes = _pad_last(q).view(q.shape[0], 1, 1, -1)
        else:
            q, s = quantize_int8(weight, axes=(1, 2, 3))
            codes = _pad_last(q.permute(0, 2, 3, 1))
    WEIGHT_QUANTIZATIONS[(tuple(weight.shape), weight.dtype)] += 1
    return codes, s


def weight_quantizations() -> int:
    return sum(WEIGHT_QUANTIZATIONS.values())


def weight_codes(layer: torch.nn.Module) -> Tuple[torch.Tensor, torch.Tensor]:
    """`quantize_weight(layer.weight)`, kept on the layer until the weight
    changes: the cache is keyed on the weight's identity, data_ptr,
    `_version`, dtype and device, so `load_state_dict` (an in-place copy),
    `load_state_dict(assign=True)` (a new tensor), an in-place op on the
    weight and `.to()` all miss. A write through `weight.data` is invisible
    to `_version` (PyTorch gives `.data` a fresh version counter), and an
    inference tensor (a weight made under `torch.inference_mode`) has no
    version counter: call `forget_weight_codes` after an in-place write to
    either. The codes are a plain attribute, not a buffer, so `state_dict()`
    never holds them. A layer with a `weight_amax` (a tp slice of a dense
    weight's in-features) is quantised with it."""
    w = layer.weight
    key = (w.data_ptr(), None if w.is_inference() else w._version, w.dtype, w.device)
    cached = layer.__dict__.get("_int8_weight_codes")
    if cached is not None and cached[0]() is w and cached[1] == key:
        return cached[2]
    codes = quantize_weight(w, getattr(layer, "weight_amax", None))
    layer.__dict__["_int8_weight_codes"] = (weakref.ref(w), key, codes)
    return codes


def forget_weight_codes(model: torch.nn.Module) -> None:
    """Drop the cached weight codes of every layer under `model`."""
    for m in model.modules():
        m.__dict__.pop("_int8_weight_codes", None)


# ---------------------------------------------------------------------------
# kernel Q1 and its plain version
# ---------------------------------------------------------------------------
def _out_hw(h: int, w: int, kh: int, kw: int, stride, padding) -> Tuple[int, int]:
    return ((h + 2 * padding[0] - kh) // stride[0] + 1, (w + 2 * padding[1] - kw) // stride[1] + 1)


def int8_gemm_acc_plain(a: torch.Tensor, b: torch.Tensor, stride=(1, 1), padding=(0, 0)) -> torch.Tensor:
    """Q1's int32 accumulators: a (B, H, W, C) int8 NHWC, b (N, kh, kw, C)
    int8 -> (B, Ho, Wo, N) int32, by a float64 convolution of the codes
    (exact: every partial sum is an integer below 2^53) rounded back."""
    acc = F.conv2d(a.permute(0, 3, 1, 2).double(), b.permute(0, 3, 1, 2).double(),
                   stride=tuple(stride), padding=tuple(padding))
    return torch.round(acc).to(torch.int32).permute(0, 2, 3, 1)


def dequantize(acc: torch.Tensor, s_row: torch.Tensor, s_col: torch.Tensor,
               out_dtype: torch.dtype) -> torch.Tensor:
    """Q1's epilogue on (B, Ho, Wo, N) int32 accumulators: float(acc) *
    (s_row * s_col) in fp32, then cast. `s_row` has one element (a
    convolution's per-tensor scale) or one per output row (B * Ho * Wo)."""
    if s_row.numel() == 1:
        scale = s_row.reshape(()) * s_col
    else:
        scale = s_row.reshape(acc.shape[:-1] + (1,)) * s_col
    return (acc.float() * scale).to(out_dtype)


def int8_gemm_plain(a, b, s_row, s_col, stride=(1, 1), padding=(0, 0),
                    out_dtype=torch.float32, bias=None) -> torch.Tensor:
    """Q1's plain version: `int8_gemm_acc_plain`, then `dequantize`, then
    the bias added in the output dtype (as the eager layers add it)."""
    y = dequantize(int8_gemm_acc_plain(a, b, stride, padding), s_row, s_col, out_dtype)
    return y if bias is None else y + bias.to(out_dtype)


def _check_gemm(a, b, s_row, s_col, bias, stride, padding):
    for name, t, dtype in (("a", a, torch.int8), ("b", b, torch.int8),
                           ("s_row", s_row, torch.float32), ("s_col", s_col, torch.float32),
                           ("bias", bias, None)):
        if t is None:
            continue
        if t.device != a.device:
            raise ValueError(f"{name} lies on {t.device}, a on {a.device}")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}; Q1 takes {dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if a.dim() != 4 or b.dim() != 4 or a.shape[3] != b.shape[3]:
        raise ValueError(f"a {tuple(a.shape)} must be (B, H, W, C), b {tuple(b.shape)} (N, kh, kw, C)")
    ho, wo = _out_hw(a.shape[1], a.shape[2], b.shape[1], b.shape[2], stride, padding)
    if ho <= 0 or wo <= 0 or min(stride) < 1 or min(padding) < 0:
        raise ValueError(f"no output for a {tuple(a.shape)}, b {tuple(b.shape)}, stride {stride}, padding {padding}")
    if s_col is not None and s_col.numel() != b.shape[0]:
        raise ValueError(f"s_col has {s_col.numel()} scales for {b.shape[0]} outputs")
    if bias is not None and bias.numel() != b.shape[0]:
        raise ValueError(f"bias has {bias.numel()} values for {b.shape[0]} outputs")
    m = a.shape[0] * ho * wo
    if s_row is not None and s_row.numel() not in (1, m):
        raise ValueError(f"s_row has {s_row.numel()} scales for {m} rows")
    if a.numel() >= 2**31 or m >= 2**31 or max(a.shape[1], a.shape[2]) >= 2**14:
        raise ValueError("Q1 takes fewer than 2^31 activation bytes and rows, H and W below 2^14")
    return ho, wo


# (a, b, s_row, s_col, bias, out, workspace, batch, h, w, c, n, kh, kw, stride_h,
# stride_w, pad_h, pad_w, row_scale_stride, out_kind, stream); (a, b, out,
# batch .. pad_w, stream) for the int32 accumulators; the workspace's bytes
_GEMM_ARGS = [_P] * 7 + [_I] * 13 + [_P]
_ACC_ARGS = [_P] * 3 + [_I] * 11 + [_P]
_WS_ARGS = [_I] * 11


def _pad_channels(a, b):
    c = a.shape[3]
    if c % PAD == 0:
        return a, b
    return F.pad(a, (0, padded(c) - c)).contiguous(), F.pad(b, (0, padded(c) - c)).contiguous()


def _geometry(a, b, stride, padding) -> tuple:
    bsz, h, w, c = a.shape
    n, kh, kw, _ = b.shape
    return (bsz, h, w, c, n, kh, kw, stride[0], stride[1], padding[0], padding[1])


def launch_key(a, b, stride, padding, out_dtype) -> tuple:
    """The `LAUNCH_SHAPES` key of one Q1 launch."""
    return ("int8_gemm", *a.shape, b.shape[0], b.shape[1], b.shape[2], stride[0], padding[0],
            _DTYPE_NAME[out_dtype])


#: a launch splits its K steps only where its tiles fill at most half the
#: SMs, so M x N <= SMs / 2 x 128 x 256; above that it needs no workspace
_NO_SPLIT_MN: Dict[int, int] = {}


def _q1(a, b, s_row, s_col, bias, stride, padding, out_dtype, ho, wo) -> torch.Tensor:
    """Launch Q1 on checked, padded operands."""
    dev = a.device
    geometry = _geometry(a, b, stride, padding)
    n = b.shape[0]
    m = a.shape[0] * ho * wo
    ws = None  # held until the launch is queued: its memory must not go to `out`
    limit = _NO_SPLIT_MN.get(dev.index)
    if limit is None:
        limit = _NO_SPLIT_MN.setdefault(dev.index, torch.cuda.get_device_properties(dev).multi_processor_count
                                        // 2 * 128 * 256)
    if m * n <= limit:
        ws_bytes = _entry("int8_gemm", "icd_int8_gemm_workspace", _WS_ARGS, ctypes.c_longlong)(*geometry)
        if ws_bytes < 0:
            raise ValueError(f"Q1 does not take a {tuple(a.shape)}, b {tuple(b.shape)}")
        if ws_bytes:
            ws = torch.empty(ws_bytes, dtype=torch.uint8, device=dev)
    out = torch.empty((a.shape[0], ho, wo, n), dtype=out_dtype, device=dev)
    _launch(dev, _entry("int8_gemm", "icd_int8_gemm", _GEMM_ARGS), a.data_ptr(), b.data_ptr(),
            s_row.data_ptr(), s_col.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), *geometry, 0 if s_row.numel() == 1 else 1,
            _OUT_KIND[out_dtype])
    fa.LAUNCH_SHAPES[launch_key(a, b, stride, padding, out_dtype)] += 1
    return out


def int8_gemm(a: torch.Tensor, b: torch.Tensor, s_row: torch.Tensor, s_col: torch.Tensor,
              stride=(1, 1), padding=(0, 0), out_dtype=torch.bfloat16,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel Q1: out[m, n] = out_dtype(float(sum_k A[m, k] B[n, k]) *
    (s_row[m] * s_col[n])) (+ bias[n] in out_dtype), A gathered from the
    NHWC int8 activation `a` (B, H, W, C) by implicit-GEMM addressing (k in
    kh, kw, c order, zero padding, `stride`), B the int8 weight `b`
    (N, kh, kw, C). A dense layer is H = W = 1 with C its input features.
    `s_row` holds one scale or one per row; returns (B, Ho, Wo, N) in
    `out_dtype` (bf16 or fp32). The kernel takes C in multiples of 16: the
    int8 layers' codes come padded (Q2, `weight_codes`); other callers' are
    padded here with zero codes, which add nothing. CPU tensors take
    `int8_gemm_plain`."""
    stride, padding = tuple(stride), tuple(padding)
    if a.device.type == "cpu":
        return int8_gemm_plain(a, b, s_row, s_col, stride, padding, out_dtype, bias)
    if out_dtype not in _OUT_KIND:
        raise TypeError(f"Q1 writes bf16 or fp32, not {out_dtype}")
    if bias is not None:
        bias = bias.to(out_dtype)
    ho, wo = _check_gemm(a, b, s_row, s_col, bias, stride, padding)
    a, b = _pad_channels(a, b)
    return _q1(a, b, s_row, s_col, bias, stride, padding, out_dtype, ho, wo)


def int8_gemm_acc(a: torch.Tensor, b: torch.Tensor, stride=(1, 1), padding=(0, 0)) -> torch.Tensor:
    """Q1's second entry point: the exact int32 accumulators (B, Ho, Wo, N)
    without the epilogue (the card checks hold them to the plain version's).
    CPU tensors take `int8_gemm_acc_plain`."""
    stride, padding = tuple(stride), tuple(padding)
    if a.device.type == "cpu":
        return int8_gemm_acc_plain(a, b, stride, padding)
    ho, wo = _check_gemm(a, b, None, None, None, stride, padding)
    a, b = _pad_channels(a, b)
    out = torch.empty((a.shape[0], ho, wo, b.shape[0]), dtype=torch.int32, device=a.device)
    _launch(a.device, _entry("int8_gemm", "icd_int8_gemm_acc", _ACC_ARGS), a.data_ptr(), b.data_ptr(),
            out.data_ptr(), *_geometry(a, b, stride, padding))
    fa.LAUNCH_SHAPES[launch_key(a, b, stride, padding, torch.int32)] += 1
    return out


# ---------------------------------------------------------------------------
# the int8 layers' maths
# ---------------------------------------------------------------------------
def _linear(x, weight, bias, codes):
    """Q2 on x's rows, then Q1 with the bias fused (CPU: the plain versions)."""
    q, s_row = quantize_activation(x, per_row=True)
    wq, s_col = codes
    out_dtype = torch.promote_types(x.dtype, weight.dtype)
    q = q.view(-1, 1, 1, q.shape[1])
    if x.device.type == "cpu":
        y = int8_gemm_plain(q, wq, s_row, s_col, out_dtype=out_dtype, bias=bias)
    else:
        if bias is not None and bias.dtype != out_dtype:
            bias = bias.to(out_dtype)
        y = _q1(q, wq, s_row, s_col, bias, (1, 1), (0, 0), out_dtype, 1, 1)
    return y.view(*x.shape[:-1], wq.shape[0])


def _conv(x, weight, bias, codes, stride, padding, amax):
    """Q2 on x (NHWC codes), then Q1 with the bias fused (CPU: the plain
    versions); NCHW out, a channels-last view of Q1's NHWC output."""
    q, s_row = quantize_activation(x, per_row=False, amax=amax)
    wq, s_col = codes
    out_dtype = torch.promote_types(x.dtype, weight.dtype)
    if x.device.type == "cpu":
        y = int8_gemm_plain(q, wq, s_row, s_col, stride, padding, out_dtype, bias)
    else:
        if bias is not None and bias.dtype != out_dtype:
            bias = bias.to(out_dtype)
        ho, wo = _out_hw(q.shape[1], q.shape[2], wq.shape[1], wq.shape[2], stride, padding)
        y = _q1(q, wq, s_row, s_col, bias, stride, padding, out_dtype, ho, wo)
    return y.permute(0, 3, 1, 2)


def _bias_grad(ctx, grad: torch.Tensor, dims):
    return grad.sum(dims).to(ctx.bias_dtype) if ctx.needs_input_grad[2] else None


class _Int8Linear(torch.autograd.Function):
    """`_linear` under autograd: zero gradient for x and the weight
    (inference only); the bias keeps its gradient, as it had when it was
    added after the product."""

    @staticmethod
    def forward(ctx, x, weight, bias, codes):
        ctx.shapes = (x.shape, x.dtype, weight.shape, weight.dtype)
        ctx.bias_dtype = None if bias is None else bias.dtype
        return _linear(x, weight, bias, codes)

    @staticmethod
    def backward(ctx, grad):
        xs, xd, ws, wd = ctx.shapes
        db = _bias_grad(ctx, grad, tuple(range(grad.dim() - 1)))
        return grad.new_zeros(xs, dtype=xd), grad.new_zeros(ws, dtype=wd), db, None


class _Int8Conv2d(torch.autograd.Function):
    """`_conv` under autograd: zero gradient for x and the weight (inference
    only); the bias keeps its gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, codes, stride, padding, amax):
        ctx.shapes = (x.shape, x.dtype, weight.shape, weight.dtype)
        ctx.bias_dtype = None if bias is None else bias.dtype
        return _conv(x, weight, bias, codes, stride, padding, amax)

    @staticmethod
    def backward(ctx, grad):
        xs, xd, ws, wd = ctx.shapes
        db = _bias_grad(ctx, grad, (0, 2, 3))
        return grad.new_zeros(xs, dtype=xd), grad.new_zeros(ws, dtype=wd), db, None, None, None, None


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def int8_linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                codes: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """The int8 dense layer (JAX `quant_dot_general` under `nn.Dense`): Q2
    on x, then Q1's dequantised product in the promoted dtype with the bias
    added in it. `codes`: the weight's cached codes (`weight_codes(layer)`);
    None quantises `weight` now. Outside autograd (inference) the maths run
    without the `autograd.Function`, whose only work is the zero gradient."""
    codes = quantize_weight(weight) if codes is None else codes
    if _needs_grad(x, weight, bias):
        return _Int8Linear.apply(x, weight, bias, codes)
    return _linear(x, weight, bias, codes)


def int8_linear_split(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                      codes: Tuple[torch.Tensor, torch.Tensor], reduce_max, reduce_sum) -> torch.Tensor:
    """The int8 dense layer whose input features are split over ranks (the
    in-feature slice of a tensor-parallel output projection, JAX's
    row-sharded `quant_dot_general` under XLA's partitioning): each row's
    amax is `reduce_max` of this rank's (the whole row's), Q2 quantises the
    slice with it, Q1 gives the int32 accumulators, `reduce_sum` adds the
    ranks' (exact), then the epilogue: float(acc) * (s_row * s_col) in the
    promoted dtype, plus the bias, once. `codes`: the slice's codes at the
    whole weight's scales (`weight_codes` of a layer with `weight_amax`).
    `reduce_*` reduce a tensor over the ranks in place and return it.
    Inference only."""
    k = x.shape[-1]
    rows = x.reshape(-1, k)
    amax = reduce_max(rows.detach().float().abs().amax(dim=1))
    q, s_row = quantize_activation(x, per_row=True, amax=amax)
    wq, s_col = codes
    acc = reduce_sum(int8_gemm_acc(q.view(-1, 1, 1, q.shape[1]), wq))
    out_dtype = torch.promote_types(x.dtype, weight.dtype)
    y = dequantize(acc, s_row, s_col, out_dtype)
    if bias is not None:
        y = y + bias.to(out_dtype)
    return y.view(*x.shape[:-1], wq.shape[0])


def int8_conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                stride, padding, amax: Optional[torch.Tensor] = None,
                codes: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """The int8 convolution (JAX `quant_conv_general_dilated` under
    `nn.Conv`): zero padding, no groups or dilation; `amax` the calibrated
    activation amax of "int8_static" (None: dynamic); `codes` as in
    `int8_linear`. The bias is added in the output dtype."""
    codes = quantize_weight(weight) if codes is None else codes
    if _needs_grad(x, weight, bias):
        return _Int8Conv2d.apply(x, weight, bias, codes, tuple(stride), tuple(padding), amax)
    return _conv(x, weight, bias, codes, tuple(stride), tuple(padding), amax)
