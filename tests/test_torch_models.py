"""Module-level parity of the PyTorch port against the JAX package, fp32 on
the CPU, on weights bridged from the JAX tiny bundle
(`invertible_cd_tpu_torch.models.convert`) and numpy-seeded inputs.

Tolerance: atol 1e-4 / rtol 1e-3 (fp32 in both frameworks; convolution and
matmul summation orders differ), unless a test states otherwise. The JAX
side runs compiled (`jax.jit`), once per call: eager Flax dispatches op by
op and took most of this file's time.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invertible_cd_tpu.diffusion import guidance as jguidance
from invertible_cd_tpu.models import layers as jlayers
from invertible_cd_tpu.models.attention import Transformer2D as JTransformer2D
from invertible_cd_tpu.models.vae import AutoencoderKL as JVAE
from invertible_cd_tpu_torch.diffusion.guidance import guidance_scale_embedding
from invertible_cd_tpu_torch.models import convert
from invertible_cd_tpu_torch.models.attention import Transformer2D
from invertible_cd_tpu_torch.models.layers import (
    GroupNorm32,
    ResnetBlock2D,
    sinusoidal_timestep_embedding,
)
from invertible_cd_tpu_torch.testing import tiny_bundle

from _torch_jax_params import seeded_tiny_bundle

ATOL, RTOL = 1e-4, 1e-3
RNG = np.random.default_rng(0)


def _randn(*shape):
    return RNG.normal(size=shape).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's tiny models (see
    `test_torch_baselines.py`): under the suite's parallel workers more
    threads oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny_pipe():
    """The JAX tiny bundle with numpy-seeded weights (this module's, in place
    of the session's Flax-initialised one)."""
    return seeded_tiny_bundle()


@pytest.fixture(scope="module")
def port_pipe(tiny_pipe):
    p = tiny_pipe.params
    return tiny_bundle({
        "reverse": convert.unet_state_dict_from_flax(_np_tree(p["reverse"])),
        "text": convert.clip_state_dict_from_flax(_np_tree(p["text"])),
        "vae": convert.vae_state_dict_from_flax(_np_tree(p["vae"])),
    })


@pytest.mark.parametrize("dim", [32, 320])
def test_sinusoidal_timestep_embedding(dim):
    t = np.array([0, 19, 259, 999], np.int64)
    want = jlayers.sinusoidal_timestep_embedding(jnp.asarray(t), dim)
    got = sinusoidal_timestep_embedding(torch.from_numpy(t), dim)
    # fp32 sin/cos of large arguments (999 x the top frequency) differ in the last ulp
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_guidance_scale_embedding():
    w = np.array([0.0, 7.5, 19.0], np.float32)
    want = jguidance.guidance_scale_embedding(jnp.asarray(w), 512)
    got = guidance_scale_embedding(torch.from_numpy(w), 512)
    # arguments reach 19000 rad: fp32 range reduction differs by a few ulp
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=RTOL)


@pytest.mark.parametrize("channels", [64, 48])
def test_groupnorm32(channels):
    """48 channels exercises the group-count fallback (32 -> 24)."""
    x = _randn(2, 8, 8, channels) * 3 + 1
    scale, bias = _randn(channels), _randn(channels)
    want = jax.jit(jlayers.GroupNorm32(32, epsilon=1e-6).apply)(
        {"params": {"GroupNorm_0": {"scale": scale, "bias": bias}}}, jnp.asarray(x)
    )
    gn = GroupNorm32(channels, eps=1e-6)
    gn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    np.testing.assert_allclose(_nhwc(gn(_nchw(x))), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("in_ch,out_ch,eps", [(64, 64, 1e-5), (32, 96, 1e-6)])
def test_resnet_block(in_ch, out_ch, eps):
    x, temb = _randn(2, 8, 8, in_ch), _randn(2, 16)
    jblock = jlayers.ResnetBlock2D(out_ch, norm_eps=eps)
    params = jax.jit(jblock.init)(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(temb))
    want = jax.jit(jblock.apply)(params, jnp.asarray(x), jnp.asarray(temb))
    block = ResnetBlock2D(in_ch, out_ch, 16, eps=eps)
    block.load_state_dict(convert.unet_state_dict_from_flax(_np_tree(params)))
    got = _nhwc(block(_nchw(x), torch.from_numpy(temb)))
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)


def test_transformer2d():
    dim, ctx_dim, heads = 64, 32, 4
    x, ctx = _randn(2, 8, 8, dim), _randn(2, 77, ctx_dim)
    jblock = JTransformer2D(heads)
    params = jax.jit(lambda x, c: jblock.init(jax.random.PRNGKey(2), x, c, "down", [0], None))(
        jnp.asarray(x), jnp.asarray(ctx))
    want = jax.jit(lambda p, x, c: jblock.apply(p, x, c, "down", [0], None))(
        params, jnp.asarray(x), jnp.asarray(ctx))
    block = Transformer2D(dim, heads, ctx_dim)
    block.load_state_dict(convert.unet_state_dict_from_flax(_np_tree(params)))
    counter = [0]
    got = _nhwc(block(_nchw(x), torch.from_numpy(ctx), "down", counter))
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)
    assert counter == [2]  # one self- and one cross-attention layer


def test_unet(tiny_pipe, port_pipe):
    x, ctx, w = _randn(2, 16, 16, 4), _randn(2, 77, 32), _randn(2, 8)
    t = np.array([999, 259], np.int64)
    want = jax.jit(tiny_pipe.unet.apply)(
        tiny_pipe.params["reverse"], jnp.asarray(x), jnp.asarray(t, jnp.int32),
        jnp.asarray(ctx), jnp.asarray(w),
    )
    with torch.no_grad():
        got = port_pipe.unets["reverse"](
            _nchw(x), torch.from_numpy(t), torch.from_numpy(ctx), torch.from_numpy(w)
        )
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_vae_decode_and_encode(tiny_pipe, port_pipe):
    z, pix = _randn(2, 16, 16, 4), _randn(2, 32, 32, 3) * 0.5
    vp = tiny_pipe.params["vae"]
    want_dec = jax.jit(lambda p, z: tiny_pipe.vae.apply(p, z, method=JVAE.decode))(vp, jnp.asarray(z))
    want_enc = jax.jit(lambda p, x: tiny_pipe.vae.apply(p, x, method=JVAE.encode_mean))(
        vp, jnp.asarray(pix))
    with torch.no_grad():
        got_dec = _nhwc(port_pipe.vae.decode(_nchw(z)))
        got_enc = _nhwc(port_pipe.vae.encode_mean(_nchw(pix)))
    np.testing.assert_allclose(got_dec, np.asarray(want_dec), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_enc, np.asarray(want_enc), atol=ATOL, rtol=RTOL)


def test_clip(tiny_pipe, port_pipe):
    tokens = tiny_pipe.tokenizer(["a photo of a cat", "", "an astronaut riding a horse"])
    want = jax.jit(tiny_pipe.text_encoder.apply)(tiny_pipe.params["text"], jnp.asarray(tokens))
    with torch.no_grad():
        got = port_pipe.text_encoder(torch.from_numpy(tokens).long())
    for key in ("last_hidden_state", "penultimate_hidden_state", "pooled_output"):
        np.testing.assert_allclose(
            got[key].numpy(), np.asarray(want[key]), atol=ATOL, rtol=RTOL, err_msg=key
        )
