"""The backward of the port's attention kernels on the CPU: the plain explicit
backward (`attention_backward_plain`, what B3 and B4 compute) and the
`FlashAttentionFn` CPU path against the JAX package's Pallas backward kernels
in interpret mode, called directly with explicit blocks (the public JAX
wrapper hands shapes like Sk = 77 to plain XLA, so it would not reach them),
and against PyTorch autograd through `attention_plain`; B1's logsumexp
against the Pallas forward's; B2's chunked backward against
`_streamed_backward_xla`. Same numpy-seeded fp32 inputs on both sides.

Tolerance: atol 2e-5 / rtol 1e-4 for gradients and outputs, fp32 on both
sides; they differ in summation order (tiles vs whole rows) and in exp(s -
lse) against a softmax that divides. The logsumexp: atol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invertible_cd_tpu.ops.flash_attention import (
    LSE_LANES,
    _flash_backward,
    _flash_forward,
    _streamed_backward_xla,
)
from invertible_cd_tpu_torch.ops import flash_attention as port

ATOL, RTOL = 2e-5, 1e-4

# (sq, sk, h, d, block_q, block_k): aligned at the two head dims the JAX
# kernels pad, then ragged queries with the 77-key tail and with several
# ragged key tiles, through the kernels' masked branches; then the shapes
# B4's routes split on: many query tiles with a ragged last one over the
# 77-key tail (the split route), and Sk = 129, one key past it; then the
# padded head dim 160 of the 256- and 64-token layers (B3's and B4's d = 160
# route), over the 77-key tail and self-attention
SHAPES = [
    (256, 256, 2, 40, 128, 128),
    (256, 256, 1, 80, 128, 128),
    (200, 77, 2, 40, 128, 128),
    (200, 300, 2, 40, 128, 128),
    (1000, 77, 1, 40, 128, 128),
    (256, 129, 1, 40, 128, 128),
    (256, 77, 1, 160, 128, 128),
    (64, 64, 1, 160, 128, 128),
]


def _inputs(b, sq, sk, h, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, h, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, h, d)).astype(np.float32)
    do = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    return q, k, v, do


def _bhsd(x):
    """(B, S, H, D) -> (B*H, S, D), the Pallas kernels' layout."""
    b, s, h, d = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))


def _from_bhsd(x, b, h):
    g, s, d = x.shape
    return np.asarray(x).reshape(b, h, s, d).transpose(0, 2, 1, 3)


def _pallas(q, k, v, do, block_q, block_k):
    """(o, lse (B, H, Sq), dq, dk, dv) from the Pallas kernels in interpret mode."""
    b, sq, h, d = q.shape
    scale = d**-0.5
    qj, kj, vj, doj = (_bhsd(x) for x in (q, k, v, do))
    o, lse = _flash_forward(qj, kj, vj, block_q, block_k, scale, True, with_lse=True)
    dq, dk, dv = _flash_backward(qj, kj, vj, o, lse, doj, block_q, block_k, scale, True)
    return (_from_bhsd(o, b, h), np.asarray(lse[..., 0]).reshape(b, h, sq),
            _from_bhsd(dq, b, h), _from_bhsd(dk, b, h), _from_bhsd(dv, b, h))


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "sq{}-sk{}-h{}-d{}".format(*s[:4]))
def case(request):
    sq, sk, h, d, block_q, block_k = request.param
    q, k, v, do = _inputs(1, sq, sk, h, d, seed=sq + sk + d)
    return (q, k, v, do), _pallas(q, k, v, do, block_q, block_k)


def test_plain_lse_matches_pallas_forward(case):
    (q, k, v, _), (o, lse, *_) = case
    got_o, got_lse = port.attention_plain_lse(*(torch.from_numpy(x) for x in (q, k, v)))
    assert got_lse.dtype == torch.float32 and tuple(got_lse.shape) == lse.shape
    np.testing.assert_allclose(got_lse.numpy(), lse, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_o.numpy(), o, atol=ATOL, rtol=RTOL)


def test_plain_backward_matches_pallas_backward(case):
    """The explicit formula on the Pallas forward's own o and lse."""
    (q, k, v, do), (o, lse, dq, dk, dv) = case
    got = port.attention_backward_plain(
        *(torch.from_numpy(np.array(x)) for x in (q, k, v, o, lse, do)))
    for name, g, want in zip(("dq", "dk", "dv"), got, (dq, dk, dv)):
        np.testing.assert_allclose(g.numpy(), want, atol=ATOL, rtol=RTOL, err_msg=name)


def test_autograd_function_cpu_path_matches_pallas_backward(case):
    """`flash_attention` under grad on CPU tensors: plain forward with lse,
    plain explicit backward, through `FlashAttentionFn`."""
    (q, k, v, do), (o, _, dq, dk, dv) = case
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = port.flash_attention(qt, kt, vt)
    assert isinstance(out.grad_fn, port.FlashAttentionFn._backward_cls)
    # a non-contiguous dO, as `out.reshape(b, sq, dim)` upstream produces it
    do_t = torch.from_numpy(np.ascontiguousarray(do.transpose(0, 2, 1, 3))).transpose(1, 2)
    got = torch.autograd.grad(out, (qt, kt, vt), do_t)
    np.testing.assert_allclose(out.detach().numpy(), o, atol=ATOL, rtol=RTOL)
    for name, g, want in zip(("dq", "dk", "dv"), got, (dq, dk, dv)):
        np.testing.assert_allclose(g.numpy(), want, atol=ATOL, rtol=RTOL, err_msg=name)


def test_plain_backward_matches_torch_autograd(case):
    """Against autograd's own softmax derivative through `attention_plain`,
    which never sees lse."""
    (q, k, v, do), _ = case
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    want = torch.autograd.grad(port.attention_plain(qt, kt, vt), (qt, kt, vt), torch.from_numpy(do))
    with torch.no_grad():
        o, lse = port.attention_plain_lse(qt, kt, vt)
        got = port.attention_backward_plain(qt, kt, vt, o, lse, torch.from_numpy(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL, rtol=RTOL, err_msg=name)


def test_no_grad_forward_saves_nothing_and_matches():
    q, k, v, _ = _inputs(1, 32, 77, 2, 40, seed=5)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    with torch.no_grad():
        out = port.flash_attention(qt, kt, vt)
        want = port.attention_plain(qt, kt, vt)
    assert out.grad_fn is None and not out.requires_grad
    np.testing.assert_array_equal(out.numpy(), want.numpy())


@pytest.mark.parametrize("sk,block_k", [(96, 32), (77, 32)])
def test_b2_chunked_backward_matches_streamed_backward_xla(sk, block_k):
    """B2's backward (plain PyTorch, one key tile at a time) against the JAX
    package's plain-XLA streamed backward, aligned and with a ragged tail,
    and through `flash_attention_streamed` under grad on the CPU."""
    b, sq, h, d = 1, 64, 1, 264
    q, k, v, do = _inputs(b, sq, sk, h, d, seed=6)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    with torch.no_grad():
        o, lse = port.attention_plain_lse(qt, kt, vt)
    lse_j = jnp.broadcast_to(jnp.asarray(lse.numpy().reshape(b * h, sq, 1)), (b * h, sq, LSE_LANES))
    want = _streamed_backward_xla(
        _bhsd(q), _bhsd(k), _bhsd(v), _bhsd(o.numpy()), lse_j, _bhsd(do), block_k, d**-0.5)
    with torch.no_grad():
        got = port.attention_backward_chunked(
            qt, kt, vt, o, lse, torch.from_numpy(do), block_k=block_k)
    via_fn = torch.autograd.grad(port.flash_attention_streamed(qt, kt, vt), (qt, kt, vt),
                                 torch.from_numpy(do))
    for name, g, f, w in zip(("dq", "dk", "dv"), got, via_fn, want):
        np.testing.assert_allclose(g.numpy(), _from_bhsd(w, b, h), atol=ATOL, rtol=RTOL, err_msg=name)
        np.testing.assert_allclose(f.numpy(), _from_bhsd(w, b, h), atol=ATOL, rtol=RTOL, err_msg=name)
