"""Kernels B1-B5 of the PyTorch port on a CUDA card, against their plain
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
products accumulated in fp32; |lse| stays under ~50 here). B5's variants
against `flash_variant_plain` at the kernel's key tile (where the bf16
variants round), with the forward's limit; and the two bf16 variants on
`variant_probe` inputs, where the kernel must sit within a quarter of the
variant's distance from base of its own plain version (the output's bf16
rounding, <= 2^-10 there, against a distance of 7e-3 to 1.5e-2).
"""
import pytest
import torch

from invertible_cd_tpu_torch.models.attention import fused_attention
from invertible_cd_tpu_torch.ops import flash_attention as fa
from invertible_cd_tpu_torch.ops import flash_variant as fv

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


B2_SHAPES = [
    (1, 1024, 1024, 1, 512),
    (2, 100, 77, 1, 512),
    (1, 64, 130, 2, 384),
    (4, 4096, 4096, 1, 512),  # the VAE mid-block at batch 4: one block a query tile
    (1, 4096, 4096, 1, 512),  # and at batch 1: the key range split in two
    (1, 512, 1000, 1, 512),   # split, Sk off the 32-key tile
    (1, 300, 1000, 2, 320),   # split, two heads, d = 320, ragged queries
    (2, 700, 333, 2, 384),    # split, d = 384, ragged on both sides
]


@pytest.mark.parametrize("b,sq,sk,h,d", B2_SHAPES)
def test_b2_matches_plain(cuda, b, sq, sk, h, d):
    q, k, v = _qkv(cuda, b, sq, sk, h, d, seed=1)
    before = fa.launches("flash_fwd_streamed")
    out = fa.flash_attention_streamed(q, k, v)
    torch.cuda.synchronize()
    assert fa.launches("flash_fwd_streamed") == before + 1
    _assert_close(out, q, k, v)


@pytest.mark.parametrize("b,sq,sk,h,d", B2_SHAPES)
def test_b2_lse_matches_plain(cuda, b, sq, sk, h, d):
    """The logsumexp entry point, on the split route too: the same output
    as the inference entry point, and lse within 1e-3 of the plain one."""
    q, k, v = _qkv(cuda, b, sq, sk, h, d, seed=9)
    o, lse = fa._forward_streamed(q, k, v, with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(o, fa.flash_attention_streamed(q, k, v))
    ref_lse = fa.attention_plain_lse(q.float(), k.float(), v.float())[1]
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    assert (lse - ref_lse).abs().max().item() <= 1e-3


@pytest.mark.parametrize("b,split", [(1, True), (4, False)])
def test_b2_repeats_bit_for_bit(cuda, b, split):
    """At 4096^2, d = 512: batch 1 fills the card by splitting the key range
    (fp32 partials merged in a fixed order by a second pass), batch 4 does
    not; either way three runs give the same bits, one launch each."""
    q, k, v = _qkv(cuda, b, 4096, 4096, 1, 512, seed=10)
    assert (fa._workspace("flash_fwd_streamed", q, k).numel() > 0) == split
    before = fa.launches("flash_fwd_streamed")
    runs = [fa.flash_attention_streamed(q, k, v) for _ in range(3)]
    torch.cuda.synchronize()
    assert fa.launches("flash_fwd_streamed") == before + 3
    for out in runs[1:]:
        assert torch.equal(out, runs[0])


def test_fused_attention_routes_by_head_dim(cuda):
    fa.reset_launch_counts()
    fused_attention(*_qkv(cuda, 1, 64, 77, 8, 40))
    fused_attention(*_qkv(cuda, 1, 64, 64, 1, 512))
    assert {name: fa.launches(name) for name in fa.KERNELS} == {
        "flash_fwd": 1, "flash_fwd_streamed": 1, "flash_bwd_dq": 0, "flash_bwd_dkdv": 0,
        "flash_variant": 0}


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
    (2, 256, 128, 8, 40),     # B4: Sk = 128, the widest split of the query tiles
    (2, 256, 129, 8, 40),     # B4: Sk = 129, key tiles of 128 and a 1-key tail
    (1, 1000, 77, 8, 40),     # B4: several query splits, the last one ragged
    (2, 300, 300, 4, 72),     # head dim padded 72 -> 80
    (1, 512, 77, 1, 80),      # batch x heads = 1, split
    (1, 300, 400, 1, 40),     # batch x heads = 1, key tiles
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
        "flash_fwd": 1, "flash_fwd_streamed": 0, "flash_bwd_dq": 1, "flash_bwd_dkdv": 1,
        "flash_variant": 0}
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


def test_b4_split_route_repeats_bit_for_bit(cuda):
    """Sk <= 128 splits the query tiles of each (batch, head) over several
    blocks whose fp32 partials a second pass adds in a fixed order: three
    runs give the same bits, and each counts as one launch of B4."""
    b, sq, sk, h, d = 4, 1024, 77, 8, 40
    q, k, v = _qkv(cuda, b, sq, sk, h, d, seed=7)
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(8),
                     device=cuda).to(torch.bfloat16)
    o, lse = fa.flash_forward_lse(q, k, v)
    rows_only = 8 * b * h * sq  # (lse2, delta) per row, sq a whole number of tiles
    assert fa._workspace("flash_bwd_dkdv", q, k).numel() > rows_only  # the partials are there: split
    before = fa.launches("flash_bwd_dkdv")
    runs = [fa.flash_backward_dkdv(q, k, v, o, lse, do) for _ in range(3)]
    torch.cuda.synchronize()
    assert fa.launches("flash_bwd_dkdv") == before + 3
    for dk, dv in runs[1:]:
        assert torch.equal(dk, runs[0][0]) and torch.equal(dv, runs[0][1])
    qf, kf, vf = (x.float() for x in (q, k, v))
    ref_o, ref_lse = fa.attention_plain_lse(qf, kf, vf)
    _, dk_ref, dv_ref = fa.attention_backward_plain(qf, kf, vf, ref_o, ref_lse, do.float())
    assert _rel(runs[0][0], dk_ref) <= TOL and _rel(runs[0][1], dv_ref) <= TOL


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
        "flash_fwd": 1, "flash_fwd_streamed": 0, "flash_bwd_dq": 1, "flash_bwd_dkdv": 1,
        "flash_variant": 0}
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


@pytest.mark.parametrize("variant", fv.VARIANTS)
@pytest.mark.parametrize("g,sq,sk,d", [(4, 256, 256, 40), (2, 200, 300, 64), (1, 70, 77, 128),
                                      (1, 129, 1000, 64), (2, 300, 190, 128)])
def test_b5_matches_plain(cuda, variant, g, sq, sk, d):
    q, k, v = (x[:, :, 0] for x in _qkv(cuda, g, sq, sk, 1, d, seed=6))
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    before = fa.launches("flash_variant")
    out = fv.flash_variant(q, k, v, variant)
    torch.cuda.synchronize()
    assert fa.launches("flash_variant") == before + 1
    ref = fv.flash_variant_plain(q.float(), k.float(), v.float(), variant, block_k=fv.KEY_TILE)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    limit = TOL * min(1.0, ref.abs().max().item())
    err = (out.float() - ref).abs().max().item()
    assert err <= limit, f"max abs err {err:.3e} > {limit:.3e}"


@pytest.mark.parametrize("variant", fv.BF16_VARIANTS)
@pytest.mark.parametrize("g,s,d", [(2, 4096, 40), (1, 256, 64), (1, 1000, 128)])
def test_b5_bf16_variants_round_as_they_say(cuda, variant, g, s, d):
    scale = 40.0 ** -0.5
    q, k, v = fv.variant_probe(g, s, d, variant, scale, device=cuda)
    out = fv.flash_variant(q, k, v, variant, scale=scale)
    qf, kf, vf = q.float(), k.float(), v.float()
    want = fv.flash_variant_plain(qf, kf, vf, variant, block_k=fv.KEY_TILE, scale=scale)
    base = fv.flash_variant_plain(qf, kf, vf, "base", block_k=fv.KEY_TILE, scale=scale)
    err = (out.float() - want).abs().max().item()
    gap = (want - base).abs().max().item()
    assert gap >= 5e-3, gap
    assert err <= 0.25 * gap, f"max abs err {err:.3e} against a distance from base of {gap:.3e}"


@pytest.mark.parametrize("d", [64, 128, 40])
def test_wgmma_products_at_b5_widths(cuda, d):
    """One Q K^T (wgmma_ss) and one P V (wgmma_rs, V read MN-major) of the
    shared loop's layout and descriptors at B5's padded widths, against
    torch on the same bf16 inputs: a wrong LBO/SBO reads other elements."""
    import ctypes
    fn = fa._lib("flash_variant").icd_wgmma_product_check
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    gen = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = (torch.randn((64, d), generator=gen, device=cuda).to(torch.bfloat16) for _ in range(3))
    s = torch.empty((64, 64), device=cuda)
    o = torch.empty((64, d), device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), s.data_ptr(), o.data_ptr(), d, stream) == 0
    torch.cuda.synchronize()
    ref_s = q.float() @ k.float().T
    assert (s - ref_s).abs().max().item() <= 1e-3 * ref_s.abs().max().item()
    ref_o = s.to(torch.bfloat16).float() @ v.float()  # the kernel's own S, rounded as it rounds P
    assert (o - ref_o).abs().max().item() <= 1e-4 * ref_o.abs().max().item()
