"""B5, the softmax-variant harness, on the CPU: `flash_variant_plain` (what
the kernel `csrc/flash_variant.cu` computes) against the TPU kernel
`flash_variant` of `tools/exp_softmax.py` in interpret mode, for all five
variants, on the same numpy-seeded inputs at G=2, S=256, D=40 and 64, with
block_q=64 and block_k=128 on both sides; the wrapper's CPU path; the
harness CLI.

The JAX side is imported by path (`tools/` is no package). XLA's CPU compiler
does two things to the bf16 exponentials that the TPU kernel does not mean:
it keeps `jnp.exp`'s bf16 result in fp32 when a cast to fp32 follows, and it
lowers `jnp.exp2` on bf16 as exp of a bf16 product with ln 2 (one more
bf16 rounding of the argument). So these tests replace `jnp.exp` and
`jnp.exp2` by the correctly rounded function (exp in fp32, rounded to the
argument's dtype),
which leaves the fp32 variants as they were and gives the bf16 variants the
p in bf16 that the TPU kernel, the CUDA kernel and the plain version take.

Tolerances, fp32 inputs: 2e-5 absolute for base, exp2 and nomax (fp32 on
both sides; summation order). bf16exp and exp2bf16: both sides round
logits - m to bf16 at each tile's running max and p to bf16, so the mean
absolute difference stays under 2e-6 (measured 2e-9 to 3e-7), against 2e-4
between either variant and the fp32 softmax; the maximum stays under 8e-4,
since a logit that differs in its last fp32 bit can flip the bf16 rounding
of one p (measured up to 4.9e-4), while the two variants differ from the
fp32 softmax by 1.1e-3 to 1.7e-3 at these shapes. bf16 inputs: outputs
rounded to bf16 on both sides, so two bf16 steps of max|ref| (2^-7).
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invertible_cd_tpu_torch.cli import exp_softmax
from invertible_cd_tpu_torch.ops import flash_attention as fa
from invertible_cd_tpu_torch.ops.flash_variant import (
    BF16_VARIANTS, KEY_TILE, VARIANTS, flash_variant, flash_variant_plain, variant_probe)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = 40.0 ** -0.5
G, S = 2, 256
BLOCK_Q, BLOCK_K = 64, 128


def _load_tool():
    spec = importlib.util.spec_from_file_location(
        "exp_softmax_tool", os.path.join(REPO, "tools", "exp_softmax.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _load_tool()


@pytest.fixture
def rounded_exp(monkeypatch):
    """jnp.exp / jnp.exp2 as correctly rounded functions of their dtype."""
    exp = jnp.exp
    monkeypatch.setattr(jnp, "exp", lambda x: exp(x.astype(jnp.float32)).astype(x.dtype))
    monkeypatch.setattr(jnp, "exp2", lambda x: exp(x.astype(jnp.float32) * np.log(2.0)).astype(x.dtype))


def _inputs(d, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(G, S, d)).astype(dtype) for _ in range(3)]


def _jax(q, k, v, variant, dtype=jnp.float32):
    out = TOOL.flash_variant(*(jnp.asarray(x, dtype) for x in (q, k, v)), variant,
                             block_q=BLOCK_Q, block_k=BLOCK_K, scale=SCALE, interpret=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("d", [40, 64])
def test_plain_matches_tpu_kernel(rounded_exp, d, variant):
    q, k, v = _inputs(d, seed=d)
    want = _jax(q, k, v, variant)
    got = flash_variant_plain(*(torch.from_numpy(x) for x in (q, k, v)), variant,
                              block_k=BLOCK_K, scale=SCALE)
    assert got.shape == (G, S, d) and got.dtype == torch.float32
    err = np.abs(got.numpy() - want)
    if variant in BF16_VARIANTS:
        assert err.mean() <= 2e-6 and err.max() <= 8e-4, (err.mean(), err.max())
        # the rounding is real: the variant is measurably off the fp32 softmax
        base = _jax(q, k, v, "base")
        assert np.abs(want - base).max() > 1e-3
    else:
        assert err.max() <= 2e-5, err.max()


def test_plain_matches_tpu_kernel_bf16_inputs(rounded_exp):
    q, k, v = _inputs(40, seed=7)
    want = _jax(q, k, v, "exp2bf16", dtype=jnp.bfloat16)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = flash_variant_plain(tq, tk, tv, "exp2bf16", block_k=BLOCK_K, scale=SCALE)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2.0 ** -7 * np.abs(want).max(), err


@pytest.mark.parametrize("variant", BF16_VARIANTS)
def test_probe_separates_the_variant_from_base(rounded_exp, variant):
    """On `variant_probe` inputs the TPU kernel's variant sits far from its
    base, and the plain version sits on the TPU kernel (the same bf16 p)."""
    q, k, v = (x.float().numpy() for x in variant_probe(G, S, 40, variant, SCALE))
    want = _jax(q, k, v, variant)
    gap = np.abs(want - _jax(q, k, v, "base")).max()
    got = flash_variant_plain(*(torch.from_numpy(x) for x in (q, k, v)), variant,
                              block_k=BLOCK_K, scale=SCALE).numpy()
    assert gap >= 5e-3, gap
    assert np.abs(got - want).max() <= 1e-2 * gap, (np.abs(got - want).max(), gap)


def test_wrapper_takes_the_plain_version_on_cpu():
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs(40, seed=3))
    fa.reset_launch_counts()
    for variant in VARIANTS:
        got = flash_variant(q, k, v, variant, scale=SCALE)
        want = flash_variant_plain(q, k, v, variant, block_k=KEY_TILE, scale=SCALE)
        assert torch.equal(got, want), variant
    assert fa.launches("flash_variant") == 0  # no kernel on the CPU
    with pytest.raises(ValueError):
        flash_variant(q, k, v, "exp3")


def test_cli_on_cpu(capsys):
    results = exp_softmax.main(["--device", "cpu", "--shape", "2,256,40", "--iters", "2"])
    (res,) = results
    assert res["shape"] == (2, 256, 40) and res["library_ms"] is None
    assert [r["variant"] for r in res["variants"]] == list(VARIANTS)
    diffs = {r["variant"]: r["max_abs_diff_vs_base"] for r in res["variants"]}
    assert diffs["base"] == 0.0
    assert all(0.0 <= x < 2e-2 for x in diffs.values()), diffs
    out = capsys.readouterr().out
    assert all(v in out for v in VARIANTS) and "host clock" in out
