"""Kernels B1-B4 of the PyTorch port on a CUDA card, against their plain
versions on the same bf16 inputs (plain math in fp32).

Marked `gpu`; every test skips without a CUDA device. This file imports
torch only, so it runs on a machine without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Inputs: q and k drawn at scale 2, so the logits have a spread of about 4
and the outputs are O(1) at every key count; with unit inputs a long key
axis averages the output down to a few hundredths and a wrong softmax
scale would hide under the limit. v is drawn at scale 0.5, which keeps
|output| under ~3, where the bf16 rounding of the output stays below
8e-3.

Tolerance: max abs error <= 2e-2 * min(1, max |reference|) (bf16 inputs;
the kernels round the probabilities and the output to bf16, the plain
version does neither). The backward kernels: max abs error <= 2e-2 *
max |reference| for each of dq, dk, dv (they round P and dS to bf16 before
the products and the result to bf16; the plain backward does neither), and
1e-3 absolute for the logsumexp (fp32 on both sides, logits from bf16
products accumulated in fp32; |lse| stays under ~50 here).
"""
import pytest
import torch

from invertible_cd_tpu_torch.models.attention import fused_attention
from invertible_cd_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.gpu
TOL = 2e-2


def _assert_close(out, q, k, v):
    ref = fa.attention_plain(q.float(), k.float(), v.float())
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    limit = TOL * min(1.0, ref.abs().max().item())
    err = (out.float() - ref).abs().max().item()
    assert err <= limit, f"max abs err {err:.3e} > {limit:.3e}"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _qkv(cuda, b, sq, sk, h, d, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(s, scale):
        return (scale * torch.randn((b, s, h, d), generator=gen, device=cuda)).to(torch.bfloat16)
    return rnd(sq, 2.0), rnd(sk, 2.0), rnd(sk, 0.5)


@pytest.mark.parametrize(
    "b,sq,sk,h,d",
    [
        (2, 256, 256, 8, 40),
        (1, 100, 77, 8, 40),    # ragged queries and the 77-key tail
        (2, 64, 77, 8, 160),
        (1, 130, 200, 2, 80),   # multi-tile ragged keys
        (1, 64, 64, 1, 256),
        (3, 17, 5, 4, 8),       # head dim padded 8 -> 48
        (1, 70, 90, 2, 136),    # head dim padded 136 -> 160
    ],
)
def test_b1_matches_plain(cuda, b, sq, sk, h, d):
    q, k, v = _qkv(cuda, b, sq, sk, h, d)
    before = fa.launches("flash_fwd")
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.launches("flash_fwd") == before + 1
    _assert_close(out, q, k, v)


@pytest.mark.parametrize("b,sq,sk,h,d", [(1, 1024, 1024, 1, 512), (2, 100, 77, 1, 512),
                                         (1, 64, 130, 2, 384)])
def test_b2_matches_plain(cuda, b, sq, sk, h, d):
    q, k, v = _qkv(cuda, b, sq, sk, h, d, seed=1)
    before = fa.launches("flash_fwd_streamed")
    out = fa.flash_attention_streamed(q, k, v)
    torch.cuda.synchronize()
    assert fa.launches("flash_fwd_streamed") == before + 1
    _assert_close(out, q, k, v)


def test_fused_attention_routes_by_head_dim(cuda):
    fa.reset_launch_counts()
    fused_attention(*_qkv(cuda, 1, 64, 77, 8, 40))
    fused_attention(*_qkv(cuda, 1, 64, 64, 1, 512))
    assert {name: fa.launches(name) for name in fa.KERNELS} == {
        "flash_fwd": 1, "flash_fwd_streamed": 1, "flash_bwd_dq": 0, "flash_bwd_dkdv": 0}


def test_wrappers_raise_instead_of_falling_back(cuda):
    q, k, v = _qkv(cuda, 1, 64, 64, 2, 40)
    with pytest.raises(TypeError):
        fa.flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError):
        fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    with pytest.raises(ValueError):
        fa.flash_attention(q, k.cpu(), v)
    q5, k5, v5 = _qkv(cuda, 1, 64, 64, 1, 512)
    with pytest.raises(ValueError):
        fa.flash_attention(q5, k5, v5)
    with pytest.raises(ValueError):
        fa.flash_attention_streamed(q, k, v)


BACKWARD_SHAPES = [
    (2, 4096, 4096, 8, 40),   # the main path's eight shapes, at batch 2
    (2, 1024, 1024, 8, 80),
    (2, 256, 256, 8, 160),
    (2, 64, 64, 8, 160),
    (2, 4096, 77, 8, 40),
    (2, 1024, 77, 8, 80),
    (2, 256, 77, 8, 160),
    (2, 64, 77, 8, 160),
    (1, 100, 77, 8, 40),      # ragged queries and the 77-key tail
    (1, 130, 200, 2, 80),     # ragged on both sides, several tiles
    (1, 200, 300, 2, 40),
    (3, 17, 5, 4, 8),         # head dim padded 8 -> 48
    (1, 70, 90, 2, 136),      # head dim padded 136 -> 160
    (1, 64, 64, 1, 256),
]


def _rel(got, ref):
    return (got.float() - ref).abs().max().item() / ref.abs().max().item()


@pytest.mark.parametrize("b,sq,sk,h,d", BACKWARD_SHAPES)
def test_b1_lse_b3_b4_match_plain(cuda, b, sq, sk, h, d):
    q, k, v = _qkv(cuda, b, sq, sk, h, d, seed=2)
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(3),
                     device=cuda).to(torch.bfloat16)
    before = {name: fa.launches(name) for name in fa.KERNELS}
    o, lse = fa.flash_forward_lse(q, k, v)
    dq = fa.flash_backward_dq(q, k, v, o, lse, do)
    dk, dv = fa.flash_backward_dkdv(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    after = {name: fa.launches(name) for name in fa.KERNELS}
    assert {n: after[n] - before[n] for n in after} == {
        "flash_fwd": 1, "flash_fwd_streamed": 0, "flash_bwd_dq": 1, "flash_bwd_dkdv": 1}
    _assert_close(o, q, k, v)
    assert torch.equal(o, fa.flash_attention(q, k, v))  # the no-lse variant: same output

    qf, kf, vf = (x.float().requires_grad_(True) for x in (q, k, v))
    ref_o, ref_lse = fa.attention_plain_lse(qf, kf, vf)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    # the explicit plain backward on the plain lse, and autograd (which knows no lse)
    plain = fa.attention_backward_plain(qf.detach(), kf.detach(), vf.detach(),
                                        ref_o.detach(), ref_lse.detach(), do.float())
    auto = torch.autograd.grad(fa.attention_plain(qf, kf, vf), (qf, kf, vf), do.float())
    for name, got, ref_p, ref_a in zip(("dq", "dk", "dv"), (dq, dk, dv), plain, auto):
        assert got.shape == ref_p.shape and got.dtype == torch.bfloat16
        assert bool(torch.isfinite(got).all()), name
        assert _rel(got, ref_p) <= TOL, f"{name} vs plain backward: {_rel(got, ref_p):.3e}"
        assert _rel(got, ref_a) <= TOL, f"{name} vs autograd: {_rel(got, ref_a):.3e}"

    # no atomics: a repeat gives the same bits
    assert torch.equal(dq, fa.flash_backward_dq(q, k, v, o, lse, do))
    dk2, dv2 = fa.flash_backward_dkdv(q, k, v, o, lse, do)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


def test_autograd_function_launches_backward_kernels(cuda):
    """Under grad B1 writes lse and the backward goes through B3 and B4, with
    a non-contiguous dO as the attention layers produce it; without grad
    nothing but B1 runs."""
    q, k, v = (x.requires_grad_(True) for x in _qkv(cuda, 2, 128, 77, 4, 40, seed=4))
    fa.reset_launch_counts()
    out = fa.flash_attention(q, k, v)
    do = torch.randn((2, 4, 128, 40), device=cuda).to(torch.bfloat16).transpose(1, 2)
    assert not do.is_contiguous()
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert {name: fa.launches(name) for name in fa.KERNELS} == {
        "flash_fwd": 1, "flash_fwd_streamed": 0, "flash_bwd_dq": 1, "flash_bwd_dkdv": 1}
    qf, kf, vf = (x.detach().float().requires_grad_(True) for x in (q, k, v))
    auto = torch.autograd.grad(fa.attention_plain(qf, kf, vf), (qf, kf, vf), do.float())
    for got, ref in zip((dq, dk, dv), auto):
        assert _rel(got, ref) <= TOL
    with torch.no_grad():
        fa.flash_attention(q, k, v)
    assert fa.launches("flash_bwd_dq") == 1 and fa.launches("flash_fwd") == 2


def test_b2_is_differentiable_through_the_chunked_backward(cuda):
    q, k, v = (x.requires_grad_(True) for x in _qkv(cuda, 1, 192, 130, 1, 512, seed=5))
    out = fa.flash_attention_streamed(q, k, v)
    do = torch.randn(out.shape, device=cuda).to(torch.bfloat16)
    got = torch.autograd.grad(out, (q, k, v), do)
    qf, kf, vf = (x.detach().float().requires_grad_(True) for x in (q, k, v))
    ref_o, ref_lse = fa.attention_plain_lse(qf, kf, vf)
    auto = torch.autograd.grad(ref_o, (qf, kf, vf), do.float())
    for g, ref in zip(got, auto):
        assert _rel(g, ref) <= TOL


def test_backward_wrappers_raise_instead_of_falling_back(cuda):
    q, k, v = _qkv(cuda, 1, 64, 64, 2, 40)
    o, lse = fa.flash_forward_lse(q, k, v)
    do = torch.randn_like(o)
    with pytest.raises(TypeError):
        fa.flash_backward_dq(q, k, v, o, lse.double(), do)
    with pytest.raises(ValueError):
        fa.flash_backward_dq(q, k, v, o, lse[:, :, :32], do)
    with pytest.raises(ValueError):
        fa.flash_backward_dkdv(q, k, v, o, lse, do.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError):
        fa.flash_backward_dkdv(q, k, v, o.cpu(), lse, do)
    with pytest.raises(TypeError):
        fa.flash_backward_dq(q, k, v, o, lse, do.float())
