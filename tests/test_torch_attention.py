"""Kernels B1/B2 of the PyTorch port: their plain versions (the CPU path of
`invertible_cd_tpu_torch.ops.flash_attention`) against the JAX package's
Pallas kernels in interpret mode, on the same numpy-seeded fp32 inputs.

Tolerance: atol 2e-5 / rtol 1e-4, fp32 on both sides; the two differ only
in summation order (online softmax over tiles vs one softmax).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invertible_cd_tpu.ops.flash_attention import (
    _flash_forward,
    _flash_forward_streamed,
    flash_attention_bhsd,
)
from invertible_cd_tpu_torch.models.attention import fused_attention
from invertible_cd_tpu_torch.ops import flash_attention as port

ATOL, RTOL = 2e-5, 1e-4


def _inputs(b, sq, sk, h, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, h, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, h, d)).astype(np.float32)
    return q, k, v


def _bhsd(x):
    """(B, S, H, D) -> (B*H, S, D), the Pallas kernels' layout."""
    b, s, h, d = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))


def _from_bhsd(x, b, h):
    g, s, d = x.shape
    return np.asarray(x).reshape(b, h, s, d).transpose(0, 2, 1, 3)


def _port(fn, q, k, v):
    return fn(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)).numpy()


@pytest.mark.parametrize(
    "sq,sk,h,d",
    [
        (256, 256, 2, 40),  # SD1.5 4096-token head dim, padded to 64 in the kernel
        (128, 128, 2, 80),
        (128, 128, 1, 160),
    ],
)
def test_b1_plain_matches_pallas(sq, sk, h, d):
    q, k, v = _inputs(1, sq, sk, h, d)
    want = _from_bhsd(flash_attention_bhsd(_bhsd(q), _bhsd(k), _bhsd(v), interpret=True), 1, h)
    np.testing.assert_allclose(_port(port.flash_attention, q, k, v), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("sk,block_k", [(77, 64), (200, 64)])
def test_b1_plain_matches_pallas_ragged_keys(sk, block_k):
    """Cross-attention's 77 keys and a multi-tile ragged tail, through the
    kernel's masked branch (the public wrapper sends Sk=77 to XLA)."""
    h, d = 2, 40
    q, k, v = _inputs(1, 64, sk, h, d, seed=1)
    out, _ = _flash_forward(
        _bhsd(q), _bhsd(k), _bhsd(v), 64, block_k, d**-0.5, True, with_lse=False
    )
    want = _from_bhsd(out, 1, h)
    np.testing.assert_allclose(_port(port.flash_attention, q, k, v), want, atol=ATOL, rtol=RTOL)


def test_b2_plain_matches_pallas_streamed():
    q, k, v = _inputs(1, 256, 256, 1, 512, seed=2)
    want = _from_bhsd(
        flash_attention_bhsd(_bhsd(q), _bhsd(k), _bhsd(v), interpret=True, streamed=True), 1, 1
    )
    np.testing.assert_allclose(
        _port(port.flash_attention_streamed, q, k, v), want, atol=ATOL, rtol=RTOL
    )


def test_b2_plain_matches_pallas_streamed_ragged_keys():
    q, k, v = _inputs(1, 64, 77, 1, 512, seed=3)
    out, _ = _flash_forward_streamed(
        _bhsd(q), _bhsd(k), _bhsd(v), 32, 32, 512**-0.5, True, with_lse=False
    )
    np.testing.assert_allclose(
        _port(port.flash_attention_streamed, q, k, v), _from_bhsd(out, 1, 1),
        atol=ATOL, rtol=RTOL,
    )


@pytest.mark.parametrize("d", [40, 512])
def test_fused_attention_routes_to_plain_on_cpu_without_launch(d):
    """On CPU tensors the route (B1 for d <= 256, B2 above) computes the
    plain version and counts no kernel launch."""
    port.reset_launch_counts()
    q, k, v = _inputs(2, 32, 77, 1, d, seed=4)
    got = _port(fused_attention, q, k, v)
    want = _port(port.attention_plain, q, k, v)
    np.testing.assert_array_equal(got, want)
    assert not port.LAUNCH_SHAPES
    assert [port.launches(name) for name in port.KERNELS] == [0] * len(port.KERNELS)


def test_kernel_library_names_track_sources():
    """Each kernel builds from its own source; the library name carries a
    hash of it, so an edited source is rebuilt rather than reused."""
    paths = {name: port.library_path(name) for name in port.KERNELS}
    assert len(set(paths.values())) == len(port.KERNELS)
    for name, path in paths.items():
        assert path.startswith(port.BUILD_DIR)
        assert os.path.basename(path).startswith(f"lib{name}-")
        assert os.path.exists(os.path.join(port._CSRC, port.KERNELS[name][0]))


@pytest.mark.parametrize("sk,want", [(77, 80), (80, 80), (1, 8)])
def test_b2_pads_keys_to_whole_row_groups(sk, want):
    """B2's TMA copies read K and V in groups of 8 rows: its wrapper pads a
    ragged key axis with zero rows and keeps every real row as it was."""
    k = torch.randn((2, sk, 3, 16))
    padded = port.pad_rows(k, 8)
    assert padded.shape == (2, want, 3, 16) and padded.is_contiguous()
    assert torch.equal(padded[:, :sk], k) and not padded[:, sk:].any()
    assert (padded is k) == (sk == want)


def test_round_tf32_rounds_to_nearest_ties_away():
    """The rounding B2's fp32 build applies to its operands (cvt.rna): 10
    mantissa bits kept, to nearest, ties away from zero; signs and zeros
    kept, and the result is exact in TF32."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp / 4, 1 + 3 * ulp / 4, -(1 + ulp / 2), 3.14159,
                      0.0, -0.0, 2.0 ** -130])
    got = port.round_tf32(x)
    want = torch.tensor([1.0, 1 + ulp, 1.0, 1 + ulp, -(1 + ulp), 3.140625, 0.0, -0.0, 2.0 ** -130])
    assert torch.equal(got, want) and torch.equal(torch.signbit(got), torch.signbit(want))
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    assert torch.equal(port.round_tf32(port.round_tf32(y)), port.round_tf32(y))
    assert ((port.round_tf32(y) - y).abs() <= y.abs() * 2.0 ** -11).all()


@pytest.mark.parametrize("sq,sk", [(96, 300), (64 * 5 + 1, 77), (64, 32)])
def test_b2_fp32_tf32_model_matches_pallas_streamed(sq, sk):
    """The model the card gates hold B2's fp32 build to: the plain version on
    q, k, v rounded to TF32 (`round_tf32`, as the kernel rounds its
    operands), against the JAX package's streamed kernel in interpret mode on
    the same rounded fp32 inputs, output and lse (natural log). Both are
    fp32 products of the same TF32-exact values, so they differ only in
    summation order (online softmax over 32-key tiles against one softmax):
    the module's 2e-5 / 1e-4 for o, and 2e-5 absolute for lse (|lse| < 10
    here, fp32 rounding ~1e-6). Shapes: a ragged key tail, an odd count of
    64-row query tiles with a one-row tail, and a single key tile."""
    q, k, v = (port.round_tf32(torch.from_numpy(x)).numpy()
               for x in _inputs(1, sq, sk, 1, 512, seed=5))
    out, lse = _flash_forward_streamed(
        _bhsd(q), _bhsd(k), _bhsd(v), 32, 32, 512**-0.5, True, with_lse=True
    )
    got_o, got_lse = port.attention_plain_lse(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(got_o.numpy(), _from_bhsd(out, 1, 1), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_lse.numpy()[0, 0], np.asarray(lse)[0, :, 0], atol=2e-5, rtol=0)


def test_b2_fp32_prepass_plain_layout():
    """The prepass's layout in plain PyTorch (what the card test holds the
    kernel's prepass to bit for bit): K rounded to TF32 as (B*H, Skp, 512);
    V rounded and transposed to (B*H, 512, Skp), each group of 8 keys in
    the order 0 2 4 6 1 3 5 7; zero rows and columns for keys past Sk."""
    k = torch.randn((2, 77, 3, 512), generator=torch.Generator().manual_seed(7))
    v = torch.randn((2, 77, 3, 512), generator=torch.Generator().manual_seed(8))
    kr, vt = port.f32_prepass_plain(k, v)
    assert kr.shape == (6, 96, 512) and vt.shape == (6, 512, 96)
    order = [0, 2, 4, 6, 1, 3, 5, 7]
    for b, h in ((0, 0), (1, 2)):
        bh = b * 3 + h
        assert torch.equal(kr[bh, :77], port.round_tf32(k[b, :, h])) and not kr[bh, 77:].any()
        for place in range(96):
            key = 8 * (place // 8) + order[place % 8]
            want = port.round_tf32(v[b, key, h]) if key < 77 else torch.zeros(512)
            assert torch.equal(vt[bh, :, place], want)
