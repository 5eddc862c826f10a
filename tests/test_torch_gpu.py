"""Kernels B1-B5, Q1 and Q2 of the PyTorch port on a CUDA card, against
their plain versions on the same inputs (plain math in fp32; Q1's in float64
on its integer codes, exact, so its accumulators and outputs are held bit for
bit; Q2's codes and scales bit for bit).

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
    assert out.shape == q.shape and out.dtype == q.dtype
    limit = TOL * min(1.0, ref.abs().max().item())
    err = (out.float() - ref).abs().max().item()
    assert err <= limit, f"max abs err {err:.3e} > {limit:.3e}"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _qkv(cuda, b, sq, sk, h, d, seed=0, dtype=torch.bfloat16):
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(s, scale):
        return (scale * torch.randn((b, s, h, d), generator=gen, device=cuda)).to(dtype)
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
        (1, 4096, 4096, 10, 64),  # SDXL's self layers at 64^2 tokens: DP 64, unpadded
        (2, 1024, 77, 20, 64),  # SDXL's cross layers at 32^2 tokens
        (1, 100, 90, 3, 56),    # head dim padded 56 -> 64, ragged on both sides
        # sp = 2 on SD1.5 512^2: a rank's queries against the whole height's keys
        (2, 2048, 4096, 8, 40),
        (2, 512, 1024, 8, 80),
        (2, 128, 256, 8, 160),
        (2, 32, 64, 8, 160),
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
    (2, 4096, 4096, 1, 512),  # at batch 2, the decode of an edited pair: 128 blocks, no split
    (1, 4096, 4096, 1, 512),  # and at batch 1: the key range split in two
    (1, 512, 1000, 1, 512),   # split, Sk off the 32-key tile
    (1, 300, 1000, 2, 320),   # split, two heads, d = 320, ragged queries
    (2, 700, 333, 2, 384),    # split, d = 384, ragged on both sides
    (1, 16384, 16384, 1, 512),  # SDXL's VAE mid-block at 1024^2 under the bf16 opt-in
    (2, 16384, 16384, 1, 512),  # and its decode of an edited pair
    (1, 2048, 4096, 1, 512),  # sp = 2: a rank's half of the mid-block's queries, split keys
    (2, 2048, 4096, 1, 512),
]
# B2's fp32 build (SDXL's default fp32 VAE): SDXL's shapes, and ragged ones.
# d = 512 takes the Hopper route (clusters of 2 query tiles x 2 head-dim
# halves, 32-key tiles, the key range split where clusters are few: batch 1
# at 16384^2 and the small shapes); other widths the first version's route.
B2_F32_SHAPES = [
    (1, 16384, 16384, 1, 512),
    (2, 16384, 16384, 1, 512),
    (1, 1024, 1024, 1, 512),
    (2, 100, 77, 1, 512),     # ragged queries, Sk off the 16-key tile
    (1, 64, 130, 2, 384),
    (1, 300, 1000, 2, 320),   # two heads, d = 320, ragged queries
    (2, 700, 333, 2, 264),    # d = 264, ragged on both sides
    (1, 64 * 5 + 1, 1000, 1, 512),  # six query tiles, the last one row: a cluster's second tile ragged
    (1, 300, 16384 - 7, 1, 512),    # five query tiles (a cluster's second wholly past Sq), Sk off the tile
    (2, 1024, 1000, 2, 512),        # batch 2 with two heads
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


@pytest.mark.parametrize("b,sq,sk,h,d", B2_F32_SHAPES)
def test_b2_fp32_matches_plain(cuda, b, sq, sk, h, d):
    """fp32 inputs launch B2's fp32 build (TF32 products, fp32 everything
    else), held to the fp32 plain version with the bf16 builds' limit; its
    lse entry point gives the same output, and an lse within 1e-3 of the
    plain one on q and k rounded to TF32 (TF32 moves a logit by up to
    2^-10 scale sum|q_i k_i|, a few 1e-3 here; a kernel that rounded q and k
    to bf16 would be ~8x further off); a repeat gives the same bits."""
    q, k, v = _qkv(cuda, b, sq, sk, h, d, seed=11, dtype=torch.float32)
    before = {name: fa.launches(name) for name in ("flash_fwd_streamed", "flash_fwd_streamed_f32")}
    out = fa.flash_attention_streamed(q, k, v)
    torch.cuda.synchronize()
    assert fa.launches("flash_fwd_streamed_f32") == before["flash_fwd_streamed_f32"] + 1
    assert fa.launches("flash_fwd_streamed") == before["flash_fwd_streamed"]
    _assert_close(out, q, k, v)
    o, lse = fa._forward_streamed_f32(q, k, v, with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(o, out)
    ref_lse = fa.attention_plain_lse(fa.round_tf32(q), fa.round_tf32(k), v)[1]
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    assert torch.equal(fa.flash_attention_streamed(q, k, v), out)


@pytest.mark.parametrize("b,sk,h", [(1, 77, 1), (2, 1000, 2), (1, 16384 - 7, 1)])
def test_b2_fp32_prepass_layout(cuda, b, sk, h):
    """The d = 512 route's prepass (its launch's first pass): K rounded to
    TF32 and V rounded and transposed, each 8-key group of V^T in the order
    0 2 4 6 1 3 5 7, zero rows past Sk; bit for bit against
    `f32_prepass_plain` (round_tf32 is cvt.rna's rounding exactly)."""
    _, k, v = _qkv(cuda, b, 8, sk, h, 512, seed=12, dtype=torch.float32)
    kr, vt = fa.f32_prepass(k, v)
    torch.cuda.synchronize()
    want_k, want_v = fa.f32_prepass_plain(k, v)
    assert torch.equal(kr, want_k) and torch.equal(vt, want_v)


def test_b2_takes_bf16_and_fp32_only(cuda):
    q, k, v = _qkv(cuda, 1, 64, 64, 1, 512, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention_streamed(q, k, v)
    with pytest.raises(TypeError):
        fa.flash_attention_streamed(q.float(), k, v.float())


@pytest.mark.parametrize("b,split", [(1, True), (2, False), (4, False)])
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
        "flash_fwd": 1, "flash_fwd_streamed": 1, "flash_fwd_streamed_f32": 0, "flash_bwd_dq": 0,
        "flash_bwd_dkdv": 0, "flash_variant": 0}


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
] + [  # NTI's: the main path's eight shapes at batch 1
    (1, sq, sk, 8, d) for sq, d in ((4096, 40), (1024, 80), (256, 160), (64, 160)) for sk in (sq, 77)
] + [  # SDXL training's, head dim 64 (B3 and B4's DP 64 route), at batch 2
    (2, sq, sk, h, 64) for sq, h in ((4096, 10), (1024, 20)) for sk in (sq, 77)
] + [
    (1, 130, 200, 2, 64),     # DP 64 ragged on both sides
    (2, 100, 77, 3, 56),      # head dim padded 56 -> 64, split
] + [  # the DP 160 route's edges (80 < d <= 160): B3 splits key tiles, B4 query tiles
    (1, 1, 300, 4, 160),      # one query row; B3 splits 5 key tiles
    (1, 300, 1, 4, 160),      # one key; B4 splits 5 query tiles
    (1, 63, 65, 2, 88),       # B3's one 80-key tile (64 < Sk <= 80), head dim padded 88 -> 160
    (1, 65, 63, 2, 128),      # B3's one 64-key tile; B4 splits 2 query tiles
    (4, 77, 77, 8, 128),      # B3's 80-key tile; B4 splits 2 query tiles of 77 rows
    (4, 256, 300, 8, 88),     # neither splits (at least 128 blocks of 5 tiles)
    (4, 300, 256, 8, 160),    # neither splits
    (1, 300, 300, 8, 128),    # both split: 3 splits of 2, 2 and 1 tiles
    (4, 1, 1, 8, 160),        # one row, one key
    (1, 256, 77, 8, 88),      # B3's 80-key tile; B4 splits 4 query tiles
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
        "flash_fwd": 1, "flash_fwd_streamed": 0, "flash_fwd_streamed_f32": 0, "flash_bwd_dq": 1,
        "flash_bwd_dkdv": 1, "flash_variant": 0}
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
        if sk == 1 and name in ("dq", "dk"):
            # one key: P = 1 and dS = dP - delta = 0, so dQ and dK are zero in
            # exact arithmetic and both references are rounding noise; hold
            # them to the size they would take with delta = 0 (dS = dP)
            dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vf.detach())
            wrong = (torch.einsum("bhqk,bkhd->bqhd", dp, kf.detach()) if name == "dq"
                     else torch.einsum("bhqk,bqhd->bkhd", dp, qf.detach()))
            size = d**-0.5 * wrong.abs().max().item()
            for ref in (ref_p, ref_a):
                err = (got.float() - ref).abs().max().item()
                assert err <= TOL * size, f"{name} with one key: {err:.3e} > {TOL} * {size:.3e}"
            continue
        assert _rel(got, ref_p) <= TOL, f"{name} vs plain backward: {_rel(got, ref_p):.3e}"
        assert _rel(got, ref_a) <= TOL, f"{name} vs autograd: {_rel(got, ref_a):.3e}"

    # no atomics: a repeat gives the same bits
    assert torch.equal(dq, fa.flash_backward_dq(q, k, v, o, lse, do))
    dk2, dv2 = fa.flash_backward_dkdv(q, k, v, o, lse, do)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


@pytest.mark.parametrize("b,sq,sk,h,d", [(4, 1024, 77, 8, 40), (1, 256, 256, 8, 160),
                                         (1, 256, 77, 8, 160), (1, 300, 300, 2, 128)])
def test_b4_split_route_repeats_bit_for_bit(cuda, b, sq, sk, h, d):
    """Where the grid is small (at DP 80 and below Sk <= 128, at DP 160 any
    Sk) B4 splits the query tiles of each (batch, head) over several blocks
    whose fp32 partials a second pass adds in a fixed order: three runs give
    the same bits, and each counts as one launch of B4."""
    q, k, v = _qkv(cuda, b, sq, sk, h, d, seed=7)
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(8),
                     device=cuda).to(torch.bfloat16)
    o, lse = fa.flash_forward_lse(q, k, v)
    rows_only = 8 * b * h * -(-sq // 64) * 64  # (lse2, delta) per row, padded to whole tiles
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


@pytest.mark.parametrize("b,sq,sk,h,d", [(1, 256, 256, 8, 160), (2, 256, 256, 8, 160),
                                         (1, 300, 300, 2, 128), (1, 1, 300, 4, 88)])
def test_b3_split_route_repeats_bit_for_bit(cuda, b, sq, sk, h, d):
    """At DP 160 B3 splits the key tiles of a small grid over several blocks
    whose fp32 partial dQ a second pass adds in split order: three runs give
    the same bits, and each counts as one launch of B3."""
    q, k, v = _qkv(cuda, b, sq, sk, h, d, seed=12)
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(13),
                     device=cuda).to(torch.bfloat16)
    o, lse = fa.flash_forward_lse(q, k, v)
    assert fa._workspace("flash_bwd_dq", q, k).numel() > 0  # the partials are there: split
    before = fa.launches("flash_bwd_dq")
    runs = [fa.flash_backward_dq(q, k, v, o, lse, do) for _ in range(3)]
    torch.cuda.synchronize()
    assert fa.launches("flash_bwd_dq") == before + 3
    for dq in runs[1:]:
        assert torch.equal(dq, runs[0])
    qf, kf, vf = (x.float() for x in (q, k, v))
    ref_o, ref_lse = fa.attention_plain_lse(qf, kf, vf)
    dq_ref = fa.attention_backward_plain(qf, kf, vf, ref_o, ref_lse, do.float())[0]
    assert _rel(runs[0], dq_ref) <= TOL


@pytest.mark.parametrize("name,b,sq,sk,h,d", [
    ("flash_bwd_dq", 1, 256, 256, 8, 160), ("flash_bwd_dq", 1, 300, 300, 2, 128),
    ("flash_bwd_dkdv", 1, 256, 77, 8, 160), ("flash_bwd_dkdv", 1, 300, 300, 2, 128),
    ("flash_bwd_dkdv", 4, 1024, 77, 8, 40)])
def test_backward_workspace_covers_what_the_kernel_writes(cuda, name, b, sq, sk, h, d):
    """A split route writes its partial sums (and B4 its rows) into the
    workspace its C `<entry>_workspace` sizes: a guard band past that size
    keeps its bytes, and the gradients equal the wrapper's."""
    q, k, v = _qkv(cuda, b, sq, sk, h, d, seed=14)
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(15),
                     device=cuda).to(torch.bfloat16)
    o, lse = fa.flash_forward_lse(q, k, v)
    nbytes = fa._workspace(name, q, k).numel()
    guard = 1 << 16
    work = torch.full((nbytes + guard,), 0xA5, dtype=torch.uint8, device=cuda)
    if name == "flash_bwd_dq":
        outs = (torch.empty_like(q),)
        want = (fa.flash_backward_dq(q, k, v, o, lse, do),)
    else:
        outs = (torch.empty_like(k), torch.empty_like(v))
        want = fa.flash_backward_dkdv(q, k, v, o, lse, do)
    fa._launch(name, fa.KERNELS[name][1], q, k, (q, k, v, o, do, lse, *outs, work))
    torch.cuda.synchronize()
    assert bool((work[nbytes:] == 0xA5).all()), "the kernel wrote past its workspace"
    for got, w in zip(outs, want):
        assert torch.equal(got, w)


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
        "flash_fwd": 1, "flash_fwd_streamed": 0, "flash_fwd_streamed_f32": 0, "flash_bwd_dq": 1,
        "flash_bwd_dkdv": 1, "flash_variant": 0}
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
    assert out.shape == q.shape and out.dtype == q.dtype
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


def test_hooked_unet_at_full_width_matches_the_unhooked_one(cuda):
    """SD1.5's UNet at full width, bf16, seeded weights: a store controller's
    hook (the identity on every layer: it records the <= 32^2-token maps and
    edits nothing) routes those 22 layers to materialised probabilities and
    keeps the 10 at 4096 tokens on B1; its epsilon is within 5e-2 relative
    L2 of the unhooked UNet's, whose 32 layers all take B1 (the two differ
    only in B1's bf16 rounding of P and O against fp32 probabilities)."""
    from invertible_cd_tpu_torch.edit import ControllerRuntime, empty_arrays, store_controller
    from invertible_cd_tpu_torch.models.layers import cast_compute_weights, fan_in_init_
    from invertible_cd_tpu_torch.models.unet2d import UNet2DCondition, UNetConfig
    from invertible_cd_tpu_torch.pipelines.sampler import GuidanceConfig, w_embedding_for

    gen = torch.Generator(device=cuda).manual_seed(3)
    with torch.device(cuda):
        unet = UNet2DCondition(UNetConfig.sd15())
    fan_in_init_(unet, gen)
    unet = cast_compute_weights(unet, torch.bfloat16).eval().requires_grad_(False)
    x = torch.randn((1, 4, 64, 64), generator=gen, device=cuda)
    ctx = 0.1 * torch.randn((1, 77, 768), generator=gen, device=cuda)
    w = w_embedding_for(GuidanceConfig(), 519, 1, device=cuda)
    runtime = ControllerRuntime(store_controller(num_steps=1), empty_arrays(1, 1))
    with torch.inference_mode():
        fa.reset_launch_counts()
        plain = unet(x, 519, ctx, w)
        assert fa.launches("flash_fwd") == 32
        fa.reset_launch_counts()
        hooked = unet(x, 519, ctx, w, attn_hook=runtime.hook_factory(0))
        torch.cuda.synchronize()
    assert fa.launches("flash_fwd") == 10
    assert sum(len(maps) for maps in runtime.store.values()) == 22
    rel = ((hooked - plain).norm() / plain.norm()).item()
    assert torch.isfinite(hooked).all() and rel <= 5e-2, f"relative L2 {rel:.3e}"



def test_tiny_ddim_and_nti_on_the_card_match_the_cpu(cuda):
    """A seeded tiny bundle's DDIM baselines, bf16 on the card, against the
    same weights in fp32 on the CPU, teacher-forced on the CPU's 50-step
    DDIM inversion: at six of its steps the CFG-doubled teacher call (B1)
    and, on a 4-step grid, NTI's first gradient with respect to the uncond
    embedding (B1 with its logsumexp, then B3 and B4 on every layer after
    the first cross layer), each within 5e-2 relative L2; then NTI and its
    reconstruction run end to end on the card, finite."""
    import dataclasses

    import numpy as np

    from invertible_cd_tpu_torch.diffusion.solver import make_solver_grid
    from invertible_cd_tpu_torch.models.unet2d import count_attention_layers
    from invertible_cd_tpu_torch.pipelines import nti
    from invertible_cd_tpu_torch.pipelines.pipeline import InvertibleCD
    from invertible_cd_tpu_torch.testing import tiny_configs
    from invertible_cd_tpu_torch.utils.tokenizer import HashTokenizer

    unet_cfg, clip_cfg, vae_cfg = tiny_configs()
    cfgs = dict(unet_cfg=unet_cfg, clip_cfg=clip_cfg, vae_cfg=vae_cfg, latent_size=(16, 16))
    cpu_pipe = InvertibleCD.sd15(device="cpu", dtype=torch.float32, seed=7, lora_rank=64,
                                 tokenizer=HashTokenizer(clip_cfg.vocab_size), **cfgs)
    params = {name: m.state_dict() for name, m in (
        ("teacher", cpu_pipe.unets["teacher"]), ("text", cpu_pipe.text_encoder), ("vae", cpu_pipe.vae))}
    card_pipe = InvertibleCD.sd15(params=params, device=cuda, dtype=torch.bfloat16,
                                  tokenizer=cpu_pipe.tokenizer, **cfgs)
    image = np.random.default_rng(43).integers(0, 256, (32, 32, 3), dtype=np.uint8)
    prompt = "a photo of a corgi on the beach"
    traj, _ = cpu_pipe.ddim_invert(image, prompt)
    x = traj.permute(0, 1, 4, 2, 3)
    ctx_u, ctx_c = (c.clone() for c in cpu_pipe.encode_prompt([prompt]))

    def rel(got, want):
        return ((got.float().cpu() - want).norm() / want.norm()).item()
    nms = [p._noise_model(p.unets["teacher"]) for p in (cpu_pipe, card_pipe)]
    ctx2 = torch.cat([ctx_u, ctx_c])
    for i in (0, 1, 10, 25, 48, 49):
        t = int(cpu_pipe.grid.ddim_timesteps[i])
        latent2 = torch.cat([x[i], x[i]])
        with torch.no_grad():
            want = nms[0](latent2, t, ctx2, None)
            got = nms[1](latent2.to(cuda), t, ctx2.to(cuda), None)
        assert rel(got, want) <= 5e-2, f"step {i}: teacher call off by {rel(got, want):.3e}"

    def first_gradient(pipe, nm, i, *inputs):
        u, cur, prev, ctx = inputs
        t = int(pipe.grid.ddim_timesteps[::-1][i])
        with torch.no_grad():
            cond = nm(cur, t, ctx, None)
        u = u.to(torch.float32, copy=True).requires_grad_(True)
        loss = nti.nti_loss(nm, u, cond, cur, prev, t, pipe.schedule, 1000 // pipe.grid.n_steps, 7.5)
        return torch.autograd.grad(loss, u)[0]
    grid = make_solver_grid(n_steps=4)
    cpu4, card4 = (dataclasses.replace(p, grid=grid) for p in (cpu_pipe, card_pipe))
    traj4, _ = cpu4.ddim_invert(image, prompt)
    x4 = traj4.permute(0, 1, 4, 2, 3)
    grad_layers = count_attention_layers(unet_cfg) - 1
    for i in range(4):
        inputs = (ctx_u, x4[4 - i], x4[3 - i], ctx_c)
        want = first_gradient(cpu4, nms[0], i, *inputs)
        fa.reset_launch_counts()
        got = first_gradient(card4, nms[1], i, *(a.to(cuda) for a in inputs))
        torch.cuda.synchronize()
        assert fa.launches("flash_bwd_dq") == fa.launches("flash_bwd_dkdv") == grad_layers
        assert rel(got, want) <= 5e-2, f"NTI step {i}: gradient off by {rel(got, want):.3e}"

    per_step, inverted = nti.null_text_inversion(card4, image, prompt, num_inner_steps=2)
    images, latents = card4.ddim_generate([prompt], latent=inverted, nti_uncond=per_step)
    assert tuple(per_step.shape) == (4, 1, 77, clip_cfg.hidden_size)
    assert all(bool(torch.isfinite(t).all()) for t in (per_step, inverted, images, latents))


def test_tiny_bundle_served_on_the_card_matches_a_direct_generate(cuda):
    """The seeded tiny bundle in bf16 on the card behind the executor: a
    burst of three requests runs as one padded batch of 4 and a lone one at
    batch 1, each image bit for bit row i of a direct `generate` at the
    same size on the executor's latents (B1 in every attention layer); the
    launches are counted per batch."""
    from invertible_cd_tpu_torch.serving import BatchingExecutor
    from invertible_cd_tpu_torch.testing import tiny_bundle

    pipe = tiny_bundle(None, dtype=torch.bfloat16, device=cuda)
    prompts, seeds = ["a cat", "a dog", "a fox"], [1, -(2**63), 2**63 - 1]
    with BatchingExecutor(pipe, batch_sizes=(1, 4), max_delay=0.5) as ex:
        futs = [ex.submit(p, seed=s) for p, s in zip(prompts, seeds)]
        burst = [f.result(timeout=300) for f in futs]
        lone = ex.generate("a cow", seed=9)
        stats = ex.stats()
        fa.reset_launch_counts()
        want4, _ = pipe.generate(prompts + prompts[-1:], latent=ex._latents(seeds + seeds[-1:]),
                                 guidance=ex.guidance)
        per_batch = fa.launches("flash_fwd")
        want1, _ = pipe.generate(["a cow"], latent=ex._latents([9]), guidance=ex.guidance)
    assert stats["batches_b4"] == 1 and stats["batches_b1"] == 1 and stats["padded_slots"] == 1
    assert per_batch > 0
    for got, row in zip(burst, want4.cpu().numpy()):
        assert (got == row).all()
    assert (lone == want1[0].cpu().numpy()).all()


def test_lazy_lora_step_on_the_card_matches_the_merged_step(cuda):
    """One train step of a small SDXL-like UNet (linear projections, added
    conditioning, head dim 64 at level 1, so B1, B3 and B4 take their DP 64
    routes), bf16 on the card, lazy against merged LoRA from one state and
    draws: metrics within 5e-2 relative and the adapter gradients (Adam's
    first moments) within 0.15 relative L2, `chip_smoke.py`'s limits (the
    merged path rounds every W + dW to bf16, the lazy one W and the
    low-rank path apart); both launch B3 and B4, as many times each."""
    import dataclasses

    from invertible_cd_tpu_torch.diffusion.schedule import make_schedule
    from invertible_cd_tpu_torch.diffusion.solver import make_train_solver
    from invertible_cd_tpu_torch.models.layers import cast_compute_weights, fan_in_init_
    from invertible_cd_tpu_torch.models.lora import seeded_lora
    from invertible_cd_tpu_torch.models.unet2d import UNet2DCondition, UNetConfig
    from invertible_cd_tpu_torch.training import ICDTrainState, LossConfig, TrainConfig, make_train_step
    from invertible_cd_tpu_torch.training.trainer import init_optimizer

    cfg = UNetConfig(block_out_channels=(128, 256), cross_attn_blocks=(False, True),
                     layers_per_block=1, num_heads=(2, 4), transformer_depth=(1, 2),
                     cross_attention_dim=64, use_linear_projection=True, time_cond_proj_dim=8,
                     addition_embed_dim=16 + 6 * 8, addition_time_embed_dim=8)
    gen = torch.Generator(device=cuda).manual_seed(5)
    with torch.device(cuda):
        unet = UNet2DCondition(cfg)
    fan_in_init_(unet, gen)
    unet = cast_compute_weights(unet, torch.bfloat16).eval().requires_grad_(False)
    base = unet.state_dict()
    lora_r, lora_f = seeded_lora(base, gen, 8), seeded_lora(base, gen, 8)
    for ab in (*lora_r.values(), *lora_f.values()):
        ab["up"].mul_(0.1)
    b = 2
    batch = {"latents": torch.randn((b, 32, 32, 4), generator=gen, device=cuda),
             "context": 0.1 * torch.randn((b, 77, 64), generator=gen, device=cuda),
             "added_cond": {"text_embeds": 0.1 * torch.randn((b, 16), generator=gen, device=cuda),
                            "time_ids": torch.tensor([[256.0, 256, 0, 0, 256, 256]] * b, device=cuda)}}
    draws = {"noise": torch.randn((b, 32, 32, 4), generator=gen, device=cuda),
             "w": torch.tensor([7.0, 11.0], device=cuda),
             "reverse_index": torch.tensor([5, 12], device=cuda),
             "forward_index": torch.tensor([5, 12], device=cuda),
             "forward_preserve_index": torch.tensor([1, 2], device=cuda),
             "reverse_preserve_index": torch.tensor([1, 2], device=cuda)}
    schedule = make_schedule(device=cuda)
    solver = make_train_solver(schedule.alphas_cumprod, num_endpoints=4, num_forward_endpoints=4,
                               endpoints="0,249,499,699", forward_endpoints="249,499,699,999",
                               device=cuda)
    tcfg = TrainConfig(lora_rank=8, remat=True, loss=LossConfig(w_embed_dim=8))
    out = {}
    for lazy in (False, True):
        mcfg = dataclasses.replace(tcfg, lazy_lora=lazy)
        fn = make_train_step(unet, base, base, solver, schedule, mcfg)
        state = ICDTrainState(0, lora_r, lora_f, init_optimizer(lora_r, mcfg), init_optimizer(lora_f, mcfg))
        fa.reset_launch_counts()
        new, metrics = fn(state, batch, None, draws)
        torch.cuda.synchronize()
        launches = {n: fa.launches(n) for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")}
        mu = torch.cat([t.flatten() for o in (new.opt_reverse, new.opt_forward)
                        for ab in o["mu"].values() for t in ab.values()])
        out[lazy] = ({k: float(v) for k, v in metrics.items()}, mu, launches)
    (m_merged, mu_merged, l_merged), (m_lazy, mu_lazy, l_lazy) = out[False], out[True]
    assert l_lazy == l_merged and l_lazy["flash_bwd_dq"] == l_lazy["flash_bwd_dkdv"] > 0
    for name, a in m_merged.items():
        assert abs(m_lazy[name] - a) <= 5e-2 * abs(a), (name, a, m_lazy[name])
    rel = ((mu_lazy - mu_merged).norm() / mu_merged.norm()).item()
    assert rel <= 0.15, f"adapter gradients: relative L2 {rel:.3e}"


# ---------------------------------------------------------------------------
# the metric suite and the training eval on the card
# ---------------------------------------------------------------------------
SCORERS = ("inception", "clip_vision", "clip_text", "dino", "lpips", "image_reward")


@pytest.mark.parametrize("name", SCORERS)
def test_tiny_scorer_on_the_card_matches_the_cpu(cuda, name):
    """Each scorer at the tiny configs (`scores.scorer_modules(tiny=True)`;
    Inception and LPIPS at full size), fp32 on both sides with TF32 off, on
    the same seeded weights and inputs: relative L2 <= 1e-3 (fp32 reductions
    in another order; the CPU's own rounding is ~1e-6)."""
    import numpy as np

    from invertible_cd_tpu_torch.metrics import scores
    from invertible_cd_tpu_torch.metrics.vit import preprocess_for

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = scores.scorer_modules(tiny=True, seed=3)[name]
    gpu = scores.scorer_modules(tiny=True, seed=3)[name].to(cuda)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(size=(2, 3, 64, 64)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 999, (2, 12))).long()

    def run(module, device):
        with torch.inference_mode():
            xd, idd = x.to(device), ids.to(device)
            if name == "inception":
                return module(xd)
            if name in ("clip_vision", "dino"):
                return module(preprocess_for(xd, 28, (0.5,) * 3, (0.25,) * 3))
            if name == "clip_text":
                return module(idd)["projected_pooled"]
            if name == "lpips":
                return module(xd * 2 - 1, xd.flip(-1) * 2 - 1)
            return module(xd, idd, torch.arange(12, device=device)[None].expand(2, 12) < 7)

    want, got = run(cpu, "cpu"), run(gpu, cuda).cpu()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    rel = ((got - want).norm() / want.norm()).item()
    assert rel <= 1e-3, rel


def test_tiny_eval_inversion_on_the_card_matches_the_cpu(cuda):
    """`eval_inversion` of 4 seeded latents with the tiny bundle's students
    (bf16 on the card: the tiny VAE's d = 32 head takes B1, bf16 only)
    against the same weights in fp32 on the CPU: the latent MSE within 5e-2
    relative (four bf16 hops each way), finite recon-FID on both."""
    from invertible_cd_tpu_torch.metrics import FIDScorer
    from invertible_cd_tpu_torch.testing import tiny_bundle
    from invertible_cd_tpu_torch.training.eval import eval_inversion, forward_sample, reverse_sample

    cpu_pipe = tiny_bundle(None)
    params = {name: m.state_dict() for name, m in cpu_pipe.unets.items()}
    params.update(text=cpu_pipe.text_encoder.state_dict(), vae=cpu_pipe.vae.state_dict())
    gpu_pipe = tiny_bundle(params, dtype=torch.bfloat16, device=cuda)
    latents = torch.randn((4, 16, 16, 4), generator=torch.Generator().manual_seed(5))
    fa.reset_launch_counts()
    out = {}
    for label, pipe in (("cpu", cpu_pipe), ("gpu", gpu_pipe)):
        ctx = pipe.encode_prompt(["a cat"] * 4)[1]
        g0 = pipe.default_guidance(guidance_scale=0.0)
        noise = torch.randn((4, 16, 16, 4), generator=torch.Generator().manual_seed(6))

        def invert(chunk, gen, c, pipe=pipe, noise=noise):
            return forward_sample(pipe._noise_model(pipe.unets["forward"]), chunk,
                                  noise.to(chunk.device), c, c, pipe.grid, pipe.schedule,
                                  pipe.w_embed_dim)

        def reconstruct(noisy, gen, c, pipe=pipe, g0=g0):
            return reverse_sample(pipe._noise_model(pipe.unets["reverse"]), noisy, c, c,
                                  pipe.grid, pipe.schedule, g0)

        with torch.inference_mode():
            out[label] = eval_inversion(
                invert, reconstruct, latents.to(pipe.device), batch_size=4,
                decode_fn=lambda z, pipe=pipe: pipe._decode_latents(z.permute(0, 3, 1, 2)),
                scorer=FIDScorer.random_init(device=pipe.device), val_context=ctx,
                reference_images=list((latents[..., :3].clamp(0, 1) * 255).byte().numpy()))
    assert fa.launches("flash_fwd") > 0
    a, b = out["cpu"]["inversion_latent_mse"], out["gpu"]["inversion_latent_mse"]
    assert abs(a - b) <= 5e-2 * abs(a), (a, b)
    assert all(map(torch.isfinite, map(torch.tensor, (out["cpu"]["inversion_fid"],
                                                     out["gpu"]["inversion_fid"]))))


# ---------------------------------------------------------------------------
# Q1, the int8 implicit GEMM of the int8 layers (`ops/quant.py`)
# ---------------------------------------------------------------------------
Q1_SHAPES = [  # (batch, H, W, C, N, kernel, stride, padding)
    (2, 9, 9, 3, 8, 3, 1, 1),       # K = 27: the VAE encoder's conv_in
    (2, 16, 16, 4, 320, 3, 1, 1),   # K = 36: the UNet's conv_in
    (1, 16, 16, 320, 4, 3, 1, 1),   # N = 4: the UNet's conv_out
    (1, 32, 32, 128, 3, 3, 1, 1),   # N = 3: the VAE decoder's conv_out
    (2, 17, 17, 64, 64, 3, 2, 0),   # stride 2 on a (0,1,0,1)-padded map
    (1, 1, 1, 1280, 320, 1, 1, 0),  # M = 1: one time_emb_proj row
    (3, 1, 1, 40, 24, 1, 1, 0),     # K = 40: byte gathers, ragged K step
    (2, 8, 8, 320, 640, 1, 1, 0),   # a 1x1 shortcut
    (1, 5, 7, 16, 130, 3, 1, 1),    # ragged M and N tiles
    (4, 1, 1, 320, 1280, 1, 1, 0),  # M = 4: the time embedding's first dense layer
    (2, 11, 13, 320, 320, 3, 1, 1),  # N = 320 (160-wide tiles), M tail
    (1, 9, 9, 640, 640, 3, 1, 1),   # N = 640, M tail
    (1, 7, 7, 48, 200, 3, 1, 1),    # K = 432 (a K-step tail), N tail
    (4, 17, 17, 128, 256, 3, 2, 0),  # stride 2, 256-wide tiles
    (4, 8, 8, 1280, 1280, 3, 1, 1),  # split K: 10 tiles of 90 K steps
    (4, 1, 1, 1280, 1280, 1, 1, 0),  # M = 4, split K
]


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", Q1_SHAPES)
def test_q1_matches_plain(cuda, shape, out_dtype):
    """Q1's int32 accumulators equal the plain float64 products exactly, and
    its dequantised output equals the plain epilogue on them bit for bit
    (one scale per row for a dense shape, one per tensor for a conv)."""
    from invertible_cd_tpu_torch.ops import quant

    b, h, w, c, n, k, s, p = shape
    gen = torch.Generator(device=cuda).manual_seed(11)
    a = torch.randint(-127, 128, (b, h, w, c), generator=gen, device=cuda, dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, k, k, c), generator=gen, device=cuda, dtype=torch.int8)
    ho, wo = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    rows = b * ho * wo if h == w == k == 1 else 1
    s_row = 0.05 * (torch.rand(rows, generator=gen, device=cuda) + 0.01)
    s_col = 0.01 * (torch.rand(n, generator=gen, device=cuda) + 0.01)
    before = fa.launches("int8_gemm")
    acc = quant.int8_gemm_acc(a, wq, (s, s), (p, p))
    out = quant.int8_gemm(a, wq, s_row, s_col, (s, s), (p, p), out_dtype)
    torch.cuda.synchronize()
    assert fa.launches("int8_gemm") == before + 2
    want = quant.int8_gemm_acc_plain(a, wq, (s, s), (p, p))
    assert acc.dtype == torch.int32 and acc.shape == (b, ho, wo, n)
    assert torch.equal(acc, want)
    assert out.dtype == out_dtype and torch.equal(out, quant.dequantize(want, s_row, s_col, out_dtype))


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", [Q1_SHAPES[i] for i in (0, 3, 5, 9, 10, 14)])
def test_q1_fused_bias_matches_the_eager_bias_add(cuda, shape, out_dtype):
    """Q1 with the bias fused: bit for bit the eager `dequantize` followed by
    the bias added in the output dtype (bf16: bf16(float(bf16(y)) + bias))."""
    from invertible_cd_tpu_torch.ops import quant

    b, h, w, c, n, k, s, p = shape
    gen = torch.Generator(device=cuda).manual_seed(13)
    a = torch.randint(-127, 128, (b, h, w, c), generator=gen, device=cuda, dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, k, k, c), generator=gen, device=cuda, dtype=torch.int8)
    ho, wo = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    rows = b * ho * wo if h == w == k == 1 else 1
    s_row = 0.05 * (torch.rand(rows, generator=gen, device=cuda) + 0.01)
    s_col = 0.01 * (torch.rand(n, generator=gen, device=cuda) + 0.01)
    bias = torch.randn(n, generator=gen, device=cuda).to(out_dtype)
    out = quant.int8_gemm(a, wq, s_row, s_col, (s, s), (p, p), out_dtype, bias)
    want = quant.dequantize(quant.int8_gemm_acc_plain(a, wq, (s, s), (p, p)), s_row, s_col, out_dtype)
    torch.cuda.synchronize()
    assert torch.equal(out, want + bias)


Q2_SHAPES = [  # (form, shape): the int8 paths' kinds of Q2 input, and odd ones
    ("rows", (4, 320)),          # M = 4: the time embedding
    ("rows", (16384, 320)),      # 64^2 tokens at batch 4
    ("rows", (4096, 640)),
    ("rows", (256, 1280)),
    ("rows", (308, 768)),        # the context's 77 tokens at batch 4 into k and v
    ("rows", (16384, 1280)),     # GEGLU's output projection at 64^2
    ("rows", (256, 5120)),
    ("rows", (2, 2816)),         # SDXL's added conditioning
    ("rows", (7, 40)),           # odd rows, a K tail
    ("rows", (5, 8)),            # K = 8: padded to 16
    ("rows", (3, 1000)),
    ("tensor", (4, 4, 64, 64)),  # the UNet's conv_in: C = 4
    ("tensor", (4, 320, 64, 64)),
    ("tensor", (4, 2560, 8, 8)),
    ("tensor", (1, 3, 256, 256)),  # the VAE encoder's conv_in: C = 3
    ("tensor", (4, 8, 64, 64)),  # C = 8
    ("tensor", (4, 512, 128, 128)),
    ("tensor", (2, 20, 33, 17)),  # odd C, H, W
    ("static", (4, 320, 64, 64)),
    ("static", (1, 3, 64, 64)),
    ("static", (2, 20, 33, 17)),
    ("rows_amax", (16384, 640)),  # a tp = 2 rank's half of GEGLU's output projection at 64^2
    ("rows_amax", (7, 40)),
    ("rows_amax", (5, 8)),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("form,shape", Q2_SHAPES)
def test_q2_matches_plain(cuda, form, shape, dtype):
    """Q2's codes and scales equal its plain version's bit for bit: dense
    rows (one scale a row, K padded to 16; or each row's amax read on the
    device, clipping, 0 taken as 1), a convolution's tensor (one scale; NHWC
    codes, C padded to 16) from NCHW and channels-last input, and the static
    form (the calibrated amax read on the device, clipping); one launch
    counted each call."""
    from invertible_cd_tpu_torch.ops import quant

    gen = torch.Generator(device=cuda).manual_seed(17)
    x = torch.randn(shape, generator=gen, device=cuda)
    x.view(-1)[::997] *= 11.0
    x = x.to(dtype)
    amax = (0.75 * x.float().abs().amax()).reshape(1) if form == "static" else None
    if form == "rows_amax":  # rows' amaxes from elsewhere (a tp group's): above, below, 0
        amax = x.float().abs().amax(1) * torch.linspace(0.5, 1.5, shape[0], device=cuda)
        amax[0] = 0.0
    per_row = form.startswith("rows")
    for xx in [x] if per_row else [x, x.contiguous(memory_format=torch.channels_last)]:
        before = fa.launches("int8_quantize")
        q, s = quant.quantize_activation(xx, per_row, amax)
        qp, sp = quant.quantize_activation_plain(xx, per_row, amax)
        torch.cuda.synchronize()
        assert fa.launches("int8_quantize") == before + 1
        assert q.shape[-1] % 16 == 0 and torch.equal(q, qp) and torch.equal(s, sp)


@pytest.mark.parametrize("rows,k,n", [(4096, 640, 320), (154, 160, 320), (3, 40, 24)])
def test_int8_linear_split_on_one_rank_is_the_int8_layer(cuda, rows, k, n):
    """The tp row-split int8 layer (Q2 with the rows' amax, Q1's int32
    accumulators, the epilogue) with its reductions the identity (one rank
    holding every in-feature) equals the int8 layer (Q2, Q1 with its fused
    epilogue) bit for bit, with and without a bias."""
    from invertible_cd_tpu_torch.ops import quant

    gen = torch.Generator(device=cuda).manual_seed(23)
    x = torch.randn((rows, k), generator=gen, device=cuda).to(torch.bfloat16)
    w = (torch.randn((n, k), generator=gen, device=cuda) / k ** 0.5).to(torch.bfloat16)
    bias = (0.05 * torch.randn(n, generator=gen, device=cuda)).to(torch.bfloat16)
    codes = quant.quantize_weight(w, w.float().abs().amax(dim=1))
    for b in (bias, None):
        want = quant.int8_linear(x, w, b, quant.quantize_weight(w))
        got = quant.int8_linear_split(x, w, b, codes, lambda t: t, lambda t: t)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_q2_all_zero_input(cuda):
    from invertible_cd_tpu_torch.ops import quant

    for per_row, shape in ((True, (3, 40)), (False, (2, 16, 8, 8))):
        q, s = quant.quantize_activation(torch.zeros(shape, device=cuda, dtype=torch.bfloat16), per_row)
        torch.cuda.synchronize()
        assert not q.any() and torch.all(s == torch.tensor(1.0) * (1.0 / 127.0)).item()


def test_q2_wrapper_raises_instead_of_falling_back(cuda):
    from invertible_cd_tpu_torch.ops import quant

    with pytest.raises(TypeError):
        quant.quantize_activation(torch.ones((4, 16), device=cuda, dtype=torch.float16), True)
    with pytest.raises(ValueError):
        quant.quantize_activation(torch.ones((4, 16, 8), device=cuda), False)


def test_q1_wrapper_raises_instead_of_falling_back(cuda):
    from invertible_cd_tpu_torch.ops import quant

    a = torch.zeros((1, 4, 4, 16), dtype=torch.int8, device=cuda)
    wq = torch.zeros((8, 3, 3, 16), dtype=torch.int8, device=cuda)
    s_row, s_col = torch.ones(1, device=cuda), torch.ones(8, device=cuda)
    with pytest.raises(TypeError):
        quant.int8_gemm(a.float(), wq, s_row, s_col, (1, 1), (1, 1))
    with pytest.raises(TypeError):
        quant.int8_gemm(a, wq, s_row, s_col, (1, 1), (1, 1), torch.float16)
    with pytest.raises(ValueError):
        quant.int8_gemm(a.transpose(1, 2), wq, s_row, s_col, (1, 1), (1, 1))
    with pytest.raises(ValueError):
        quant.int8_gemm(a, wq.cpu(), s_row, s_col, (1, 1), (1, 1))
    with pytest.raises(ValueError):
        quant.int8_gemm(a, wq, s_row, torch.ones(7, device=cuda), (1, 1), (1, 1))


def test_tiny_unet_int8_call_on_the_card_matches_the_cpu(cuda):
    """A seeded tiny UNet's int8 call on the card (Q1, fp32 outputs) against
    the same weights on the CPU (the plain versions), both fp32 with every
    attention layer materialised (an identity hook: B1 takes bf16 only).
    Layer by layer, each int8 layer fed the CPU call's input on both
    devices: bit for bit, with one Q1 launch per layer. End to end: mean
    |diff| < 4e-2, max < 4e-1, twice the JAX tests' flip envelope; the
    float layers between (GroupNorm, softmax, erf) round differently on the
    two devices and move int8 buckets, and on this seeded model int8 itself
    moves epsilon by ~6e-2 mean from "off" (measured on the H100: 2.5e-2
    mean, 0.11 max, against 7e-4 for "off")."""
    from invertible_cd_tpu_torch.models.layers import QConv2d, QLinear
    from invertible_cd_tpu_torch.ops import quant
    from invertible_cd_tpu_torch.testing import tiny_bundle

    cpu_pipe = tiny_bundle(None)
    params = {name: m.state_dict() for name, m in cpu_pipe.unets.items()}
    params.update(text=cpu_pipe.text_encoder.state_dict(), vae=cpu_pipe.vae.state_dict())
    gpu_pipe = tiny_bundle(params, device=cuda)
    cpu_unet, gpu_unet = cpu_pipe.unets["reverse"], gpu_pipe.unets["reverse"]
    gen = torch.Generator().manual_seed(12)
    x, ctx, w = (torch.randn(s, generator=gen) for s in ((2, 4, 16, 16), (2, 77, 32), (2, 8)))
    t = torch.full((2,), 999)
    inputs = {}
    for name, m in cpu_unet.named_modules():
        if isinstance(m, (QLinear, QConv2d)):
            m.register_forward_pre_hook(
                lambda mod, args, name=name: inputs.__setitem__(name, args[0].detach().clone()))

    def identity(probs, meta):
        return probs
    eps = {}
    with torch.inference_mode():
        for label, unet, dev in (("cpu", cpu_unet, "cpu"), ("gpu", gpu_unet, cuda)):
            with quant.quant_scope("int8"):
                eps[label] = unet(x.to(dev), t.to(dev), ctx.to(dev), w_cond=w.to(dev),
                                  attn_hook=identity).cpu()
        gpu_layers = dict(gpu_unet.named_modules())
        fa.reset_launch_counts()
        with quant.quant_scope("int8"):
            differ = [name for name, xin in inputs.items() if not torch.equal(
                dict(cpu_unet.named_modules())[name](xin), gpu_layers[name](xin.to(cuda)).cpu())]
        launched = fa.launches("int8_gemm")
    n_layers = sum(isinstance(m, (QLinear, QConv2d)) for m in gpu_unet.modules())
    assert len(inputs) == n_layers and launched == n_layers and differ == []
    diff = (eps["gpu"] - eps["cpu"]).abs()
    assert diff.mean() < 4e-2 and diff.max() < 4e-1, (diff.mean().item(), diff.max().item())


# ---------------------------------------------------------------------------
# distribution on the card
# ---------------------------------------------------------------------------
def test_world_one_nccl_step_equals_the_plain_step(cuda):
    """One train step through a mesh over a world-size-1 NCCL group (the
    gradients and losses all-reduced through NCCL, the draws made at the
    global batch and sliced) equals the step without a mesh bit for bit:
    the adapters, both optimizer states and every metric, with the same
    kernel launches."""
    import socket

    import torch.distributed as dist

    from invertible_cd_tpu_torch.diffusion.schedule import make_schedule
    from invertible_cd_tpu_torch.diffusion.solver import make_train_solver
    from invertible_cd_tpu_torch.models.layers import cast_compute_weights, fan_in_init_
    from invertible_cd_tpu_torch.models.lora import seeded_lora
    from invertible_cd_tpu_torch.models.unet2d import UNet2DCondition, UNetConfig
    from invertible_cd_tpu_torch.parallel import make_mesh
    from invertible_cd_tpu_torch.training import ICDTrainState, LossConfig, TrainConfig, make_train_step
    from invertible_cd_tpu_torch.training.trainer import init_optimizer

    cfg = UNetConfig(block_out_channels=(128, 256), cross_attn_blocks=(False, True),
                     layers_per_block=1, num_heads=(2, 4), transformer_depth=(1, 1),
                     cross_attention_dim=64, time_cond_proj_dim=8)
    gen = torch.Generator(device=cuda).manual_seed(5)
    with torch.device(cuda):
        unet = UNet2DCondition(cfg)
    fan_in_init_(unet, gen)
    base = {k: v.float().clone() for k, v in unet.state_dict().items()}
    unet = cast_compute_weights(unet, torch.bfloat16).eval().requires_grad_(False)
    lora_r, lora_f = seeded_lora(base, gen, 8), seeded_lora(base, gen, 8)
    b = 2
    batch = {"latents": torch.randn((b, 32, 32, 4), generator=gen, device=cuda),
             "context": 0.1 * torch.randn((b, 77, 64), generator=gen, device=cuda)}
    schedule = make_schedule(device=cuda)
    solver = make_train_solver(schedule.alphas_cumprod, num_endpoints=4, num_forward_endpoints=4,
                               endpoints="0,259,519,779", forward_endpoints="259,519,779,999",
                               device=cuda)
    tcfg = TrainConfig(lora_rank=8, loss=LossConfig(w_embed_dim=8))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    try:
        mesh = make_mesh(device="cuda")
        assert mesh.device_mesh is not None and mesh.size == 1
        out = []
        for m in (None, mesh):
            fn = make_train_step(unet, base, unet.state_dict(), solver, schedule, tcfg, m)
            state = ICDTrainState(0, lora_r, lora_f, init_optimizer(lora_r, tcfg),
                                  init_optimizer(lora_f, tcfg))
            fa.reset_launch_counts()
            new, metrics = fn(state, batch, torch.Generator(device=cuda).manual_seed(9))
            torch.cuda.synchronize()
            out.append((new, {k: float(v) for k, v in metrics.items()}, dict(fa.LAUNCH_SHAPES)))
    finally:
        dist.destroy_process_group()
    (plain, m_plain, l_plain), (meshed, m_mesh, l_mesh) = out
    assert m_mesh == m_plain and l_mesh == l_plain
    assert sum(n for key, n in l_plain.items() if key[0] == "flash_bwd_dq") > 0
    def tensors(state):
        trees = [state.lora_reverse, state.lora_forward] + [
            opt[part] for opt in (state.opt_reverse, state.opt_forward) for part in ("mu", "nu")]
        return [t for tree in trees for ab in tree.values() for t in ab.values()]
    a, c = tensors(plain), tensors(meshed)
    assert len(a) == len(c) > 0 and all(torch.equal(x, y) for x, y in zip(a, c))


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_tp_reductions_keep_the_gradient_on_the_card(cuda, backend):
    """tp's Megatron pair on CUDA tensors over a world-size-1 group of each
    backend: gloo moves a CUDA tensor's all_reduce through the host (the
    path two ranks sharing one card take), NCCL on the device. A
    column-split layer (its input through `to_tp`) into a `RowSplitLinear`
    holding every in-feature gives the unsplit pair's output and gradients
    (input and all four parameters, bf16 products: 2e-2 of each one's
    largest entry), leaves the input unwritten, and no gradient is cut (an
    in-place copy from the host would zero the layer's input gradient)."""
    import socket

    import torch.distributed as dist
    import torch.nn as nn
    import torch.nn.functional as F

    from invertible_cd_tpu_torch.parallel import make_mesh, to_tp
    from invertible_cd_tpu_torch.parallel.tp import RowSplitLinear

    gen = torch.Generator(device=cuda).manual_seed(3)
    with torch.device(cuda):
        col, row = nn.Linear(320, 1280).bfloat16(), nn.Linear(1280, 320).bfloat16()
    x = torch.randn((2, 4096, 320), generator=gen, device=cuda).bfloat16()
    g = torch.randn((2, 4096, 320), generator=gen, device=cuda).bfloat16()

    def grads(first, second, tp_input):
        xi = x.clone().requires_grad_(True)
        params = [first.weight, first.bias, second.weight, second.bias]
        for p in params:
            p.requires_grad_(True)
        h = tp_input(xi)
        version = h._version
        y = second(F.gelu(first(h)))
        out = torch.autograd.grad((y.float() * g.float()).sum(), [xi] + params)
        return y.detach(), out, h._version == version

    want_y, want, _ = grads(col, row, lambda t: t)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    try:
        mesh = make_mesh(device="cuda")
        split = RowSplitLinear(row, mesh, torch.arange(1280))
        got_y, got, kept = grads(col, split, lambda t: to_tp(t, mesh))
    finally:
        dist.destroy_process_group()
    assert kept
    assert (got_y.float() - want_y.float()).abs().max() <= 2e-2 * want_y.float().abs().max()
    for a, b in zip(got, want):
        assert b.abs().max() > 0 and (a.float() - b.float()).abs().max() <= 2e-2 * b.float().abs().max()
