"""Kernel Q2's plain version and the Q-layers' weight-code cache against the
JAX package, on the CPU.

`quant.quantize_activation_plain` lays the codes out as kernels Q1 and Q2
do on the card: (rows, K) for a dense layer's input, NHWC for a
convolution's, the last dim padded to a multiple of 16 with zero codes. Its
codes and scales must equal JAX's `quantize_int8` (`invertible_cd_tpu/ops/
quant.py:176-209`) transposed the same way, bit for bit. JAX is jitted on
these small arrays: eager JAX divides amax by 127, while every compiled JAX
program (and the port) multiplies by f32(1/127), and the two differ by an
ulp on a few per cent of scales.

The weight codes (`quant.weight_codes`) are `quantize_int8(weight)` laid
out, computed once a weight and recomputed after each way the weight can
change. Padding C or K with zero codes leaves Q1's plain products as they
were.
"""
import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from invertible_cd_tpu.ops import quant as jquant
from invertible_cd_tpu_torch.models.layers import QConv2d, QLinear
from invertible_cd_tpu_torch.ops import quant

DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
_jquantize = jax.jit(jquant.quantize_int8, static_argnums=1)


@jax.jit
def _jstatic(x, amax):  # JAX's "int8_static" activation codes (quant.py:320-323)
    amax = jnp.maximum(jnp.asarray(amax, jnp.float32), 1e-12)
    q = jnp.clip(jnp.round(x.astype(jnp.float32) * (127.0 / amax)), -127, 127).astype(jnp.int8)
    return q, amax / 127.0


def _activations(shape, seed):
    """N(0, 1) with a few large entries, so the scales and clipping matter."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x.reshape(-1)[:: max(1, x.size // 7)] *= 9.0
    return x


def _both(x: np.ndarray, dtype: str):
    """The same values as a torch tensor and a JAX array of `dtype` (bf16
    rounded once, on the torch side)."""
    t = torch.from_numpy(x).to(DTYPES[dtype][0])
    return t, jnp.asarray(t.float().numpy(), DTYPES[dtype][1])


def _assert_padded(q: torch.Tensor, want: np.ndarray):
    c = want.shape[-1]
    assert q.dtype == torch.int8 and q.shape[-1] == quant.padded(c) and q.shape[-1] % 16 == 0
    np.testing.assert_array_equal(q[..., :c].numpy(), want)
    assert not q[..., c:].any()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", ["dense", "conv_c3", "conv_c20", "conv_channels_last", "static",
                                  "zero_dense", "zero_conv"])
def test_q2_plain_matches_jax(case, dtype):
    """Dense: one scale a row of (..., K); conv: one scale a tensor, NHWC
    codes from NCHW (or channels-last) input; static: the calibrated amax
    (clipping past it); an all-zero input gives zero codes and scale 1/127."""
    if case.startswith("zero"):
        x = np.zeros((2, 3, 40) if case == "zero_dense" else (2, 3, 4, 5), np.float32)
    elif case == "dense":
        x = _activations((2, 5, 40), 1)
    else:
        x = _activations((2, 20 if case == "conv_c20" else 3, 5, 6), 2)
    xt, xj = _both(x, dtype)
    if case in ("dense", "zero_dense"):
        q, s = quant.quantize_activation_plain(xt, per_row=True)
        jq, js = _jquantize(xj.reshape(-1, x.shape[-1]), (1,))
    elif case == "static":
        amax = np.float32(np.abs(x).max() / 2)
        q, s = quant.quantize_activation_plain(xt, per_row=False, amax=torch.tensor(amax))
        jq, js = _jstatic(xj.transpose(0, 2, 3, 1), amax)
        assert np.abs(np.asarray(jq)).max() == 127
    else:
        if case == "conv_channels_last":
            xt = xt.contiguous(memory_format=torch.channels_last)
        q, s = quant.quantize_activation_plain(xt, per_row=False)
        jq, js = _jquantize(xj.transpose(0, 2, 3, 1), None)
    _assert_padded(q, np.asarray(jq))
    assert s.dtype == torch.float32
    np.testing.assert_array_equal(s.numpy(), np.asarray(js).reshape(s.shape))
    got_q, got_s = quant.quantize_activation(xt, per_row=case in ("dense", "zero_dense"),
                                             amax=torch.tensor(amax) if case == "static" else None)
    assert torch.equal(got_q, q) and torch.equal(got_s, s)  # CPU tensors: the wrapper is the plain version


def _layers():
    torch.manual_seed(0)
    return QConv2d(3, 8, 3, padding=1), QLinear(40, 24)


@pytest.mark.parametrize("layer", ["conv", "linear"])
def test_weight_codes_equal_quantize_int8(layer):
    """Per-output-feature codes, (N, kh, kw, Cp) for a conv and (N, 1, 1, Kp)
    for a dense layer, and scales: JAX's `quantize_int8` of the weight, laid
    out, bit for bit."""
    conv, lin = _layers()
    m = conv if layer == "conv" else lin
    codes, scales = quant.weight_codes(m)
    w = m.weight.detach().numpy()
    if layer == "conv":  # JAX's kernel is HWIO: per output channel over (0, 1, 2)
        jq, js = _jquantize(jnp.asarray(w.transpose(2, 3, 1, 0)), (0, 1, 2))
        want = np.asarray(jq).transpose(3, 0, 1, 2)
    else:  # JAX's is (K, N): per output feature over 0
        jq, js = _jquantize(jnp.asarray(w.T), (0,))
        want = np.asarray(jq).T[:, None, None, :]
    _assert_padded(codes, want)
    np.testing.assert_array_equal(scales.numpy(), np.asarray(js))


def test_weight_codes_are_cached_until_the_weight_changes():
    """A second call quantises no weight; each way a weight changes misses:
    `load_state_dict` (in place), `load_state_dict(assign=True)` (a new
    tensor), an in-place op on the weight, `.to()`; a write through
    `weight.data` escapes `_version`, so `forget_weight_codes` follows it.
    The codes never enter `state_dict()`."""
    conv, lin = _layers()
    x, img = torch.randn(3, 40), torch.randn(1, 3, 6, 6)
    keys = set(conv.state_dict()) | set(lin.state_dict())

    def run():
        before = quant.weight_quantizations()
        with quant.quant_scope("int8"):
            out = lin(x), conv(img)
        return quant.weight_quantizations() - before, out

    assert run()[0] == 2
    assert run()[0] == 0
    assert set(conv.state_dict()) | set(lin.state_dict()) == keys
    new = {k: v * 2 for k, v in lin.state_dict().items()}

    def copy_in_place():
        with torch.no_grad():
            lin.weight.copy_(lin.weight.flip(0))
    steps = {
        "load_state_dict": lambda: lin.load_state_dict(new),
        "assign": lambda: lin.load_state_dict({k: -v for k, v in new.items()}, assign=True),
        "add_": lambda: lin.weight.detach().add_(0.5),
        "copy_": copy_in_place,
        "to": lambda: lin.to(torch.float64),
    }
    for name, step in steps.items():
        step()
        n, _ = run()
        assert n == 1, name
        codes, scales = quant.weight_codes(lin)  # the new weight's codes
        want_q, want_s = quant.quantize_int8(lin.weight.detach(), axes=(1,))
        assert torch.equal(codes.view(24, -1)[:, :40], want_q) and torch.equal(scales, want_s), name
    lin.weight.data.mul_(-1)  # invisible to the key ...
    assert run()[0] == 0
    quant.forget_weight_codes(lin)  # ... so the codes are dropped by hand
    assert run()[0] == 1
    assert set(conv.state_dict()) | set(lin.state_dict()) == keys


@pytest.mark.parametrize("case", ["conv_c3_stride2", "dense_k40"])
def test_plain_gemm_padded_equals_unpadded(case):
    """Zero codes appended to C (a conv) or K (a dense layer) of both
    operands leave Q1's plain accumulators and outputs as they were."""
    gen = torch.Generator().manual_seed(3)
    if case == "dense_k40":
        a = torch.randint(-127, 128, (6, 1, 1, 40), generator=gen, dtype=torch.int8)
        b = torch.randint(-127, 128, (24, 1, 1, 40), generator=gen, dtype=torch.int8)
        stride, pad, s_row = (1, 1), (0, 0), torch.rand(6, generator=gen) + 0.01
    else:
        a = torch.randint(-127, 128, (2, 9, 9, 3), generator=gen, dtype=torch.int8)
        b = torch.randint(-127, 128, (8, 3, 3, 3), generator=gen, dtype=torch.int8)
        stride, pad, s_row = (2, 2), (1, 1), torch.rand(1, generator=gen) + 0.01
    s_col, bias = torch.rand(b.shape[0], generator=gen) + 0.01, torch.randn(b.shape[0], generator=gen)
    ap, bp = (torch.nn.functional.pad(t, (0, quant.padded(t.shape[3]) - t.shape[3])) for t in (a, b))
    assert ap.shape[3] == bp.shape[3] == (48 if case == "dense_k40" else 16)
    assert torch.equal(quant.int8_gemm_acc(ap, bp, stride, pad), quant.int8_gemm_acc(a, b, stride, pad))
    for dtype in (torch.float32, torch.bfloat16):
        got = quant.int8_gemm(ap, bp, s_row, s_col, stride, pad, dtype, bias)
        want = quant.int8_gemm(a, b, s_row, s_col, stride, pad, dtype) + bias.to(dtype)
        assert got.dtype == dtype and torch.equal(got, want)


def test_int8_layers_equal_the_unfused_maths():
    """On the CPU a Q-layer's int8 call is bit for bit the unfused maths it
    replaced: `quantize_int8` of the activation and the weight, the codes
    permuted to NHWC, the plain product, the cast, then the bias added in
    the output dtype."""
    conv, lin = _layers()
    for m in (conv, lin):
        m.to(torch.bfloat16)
    x = torch.from_numpy(_activations((2, 7, 40), 4)).bfloat16()
    img = torch.from_numpy(_activations((2, 3, 8, 8), 5)).bfloat16()
    with quant.quant_scope("int8"):
        got_lin, got_conv = lin(x), conv(img)
    q, s_row = quant.quantize_int8(x.reshape(-1, 40), axes=(1,))
    wq, s_col = quant.quantize_int8(lin.weight, axes=(1,))
    want = quant.int8_gemm_plain(q.view(-1, 1, 1, 40), wq.view(24, 1, 1, 40), s_row, s_col,
                                 out_dtype=torch.bfloat16).view(2, 7, 24) + lin.bias
    assert torch.equal(got_lin, want)
    q, s_row = quant.quantize_int8(img)
    wq, s_col = quant.quantize_int8(conv.weight, axes=(1, 2, 3))
    y = quant.int8_gemm_plain(q.permute(0, 2, 3, 1).contiguous(), wq.permute(0, 2, 3, 1).contiguous(),
                              s_row.reshape(1), s_col, (1, 1), (1, 1), torch.bfloat16)
    assert torch.equal(got_conv, y.permute(0, 3, 1, 2) + conv.bias[None, :, None, None])
    assert isinstance(lin, nn.Linear) and isinstance(conv, nn.Conv2d)
