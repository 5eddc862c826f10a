"""Kernels B1/B2 of the PyTorch port on a CUDA card, against their plain
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
version does neither).
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
    assert [fa.launches(name) for name in fa.KERNELS] == [1, 1]


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
