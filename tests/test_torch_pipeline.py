"""The PyTorch port's generation slice against the JAX package, fp32 on the CPU.

The port's tiny bundle is built from the JAX tiny bundle's params through
the weights bridge; both get the same start latent (drawn by JAX from
PRNGKey(150), since torch generators and threefry differ). Tolerances:
atol 1e-4 / rtol 1e-3 on images and latents (fp32 in both frameworks, four
UNet hops plus the VAE decode, differing in summation order); the diffusion
tables and hop math to fp32 rounding.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invertible_cd_tpu.diffusion import guidance as jguidance
from invertible_cd_tpu.diffusion import schedule as jschedule
from invertible_cd_tpu.diffusion import solver as jsolver
from invertible_cd_tpu.pipelines import sampler as jsampler
from invertible_cd_tpu.utils import tokenizer as jtokenizer
from invertible_cd_tpu_torch.diffusion import guidance, schedule, solver
from invertible_cd_tpu_torch.models import convert
from invertible_cd_tpu_torch.pipelines import sampler
from invertible_cd_tpu_torch.pipelines.pipeline import InvertibleCD, to_uint8
from invertible_cd_tpu_torch.testing import tiny_bundle
from invertible_cd_tpu_torch.utils import tokenizer

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "tiny_pipeline.npz")
ATOL, RTOL = 1e-4, 1e-3
PROMPT = "a photo of a cat"


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
def port_pipe(tiny_pipe):
    p = tiny_pipe.params
    return tiny_bundle({
        "reverse": convert.unet_state_dict_from_flax(_np_tree(p["reverse"])),
        "text": convert.clip_state_dict_from_flax(_np_tree(p["text"])),
        "vae": convert.vae_state_dict_from_flax(_np_tree(p["vae"])),
    })


@pytest.fixture(scope="module")
def jax_generation(tiny_pipe):
    """(start latent, images, final latents, the (5, 1, 16, 16, 4) trajectory)."""
    latent = np.asarray(tiny_pipe.init_latent(jax.random.PRNGKey(150), 1))
    images, traj = tiny_pipe.generate([PROMPT], latent=jnp.asarray(latent), return_trajectory=True)
    return latent, np.asarray(images), np.asarray(traj[-1]), np.asarray(traj)


@pytest.fixture(scope="module")
def port_generation(port_pipe, jax_generation):
    latent = jax_generation[0]
    images, latents = port_pipe.generate([PROMPT], latent=torch.tensor(latent))
    return images.numpy(), latents.numpy()


def test_generate_matches_jax_tiny_bundle(jax_generation, port_generation):
    _, want_images, want_latents, _ = jax_generation
    images, latents = port_generation
    assert images.shape == (1, 32, 32, 3) and images.dtype == np.float32
    assert latents.shape == (1, 16, 16, 4)
    np.testing.assert_allclose(latents, want_latents, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(images, want_images, atol=ATOL, rtol=RTOL)


def test_generate_trajectory_matches_jax(port_pipe, jax_generation, port_generation):
    """`return_trajectory`: row i is hop i's input; the last row is the final
    latent of the call without it, and its images match that call's."""
    latent, want_images, _, want_traj = jax_generation
    images, traj = port_pipe.generate([PROMPT], latent=torch.tensor(latent), return_trajectory=True)
    assert tuple(traj.shape) == (5, 1, 16, 16, 4)
    np.testing.assert_allclose(traj.numpy(), want_traj, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(images.numpy(), want_images, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(traj[-1], torch.from_numpy(port_generation[1]), atol=0, rtol=0)
    torch.testing.assert_close(images, torch.from_numpy(port_generation[0]), atol=ATOL, rtol=RTOL)


def test_generate_matches_golden(port_generation):
    golden = np.load(GOLDEN)
    images, latents = port_generation
    np.testing.assert_allclose(images, golden["gen_images"], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(latents, golden["gen_latents"], atol=ATOL, rtol=RTOL)


def test_generate_shares_one_latent_across_the_batch(port_pipe):
    gen = torch.Generator().manual_seed(3)
    images, latents = port_pipe.generate([PROMPT, PROMPT], generator=gen)
    assert images.shape == (2, 32, 32, 3)
    assert torch.isfinite(images).all() and images.min() >= 0 and images.max() <= 1
    torch.testing.assert_close(images[0], images[1], atol=0, rtol=0)
    again, _ = port_pipe.generate([PROMPT], generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(again[0], images[0], atol=1e-6, rtol=0)


def test_schedule_tables_match_jax():
    want = jschedule.make_schedule()
    got = schedule.make_schedule()
    for name in ("betas", "alphas_cumprod", "sqrt_alphas_cumprod",
                 "sqrt_one_minus_alphas_cumprod", "final_alpha_cumprod"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name
        )


@pytest.mark.parametrize(
    "kw",
    [
        dict(reverse_timesteps=[259, 519, 779, 999], forward_timesteps=[19, 259, 519, 779]),
        dict(n_steps=50, num_endpoints=3, num_forward_endpoints=4),
    ],
)
def test_solver_grid_matches_jax(kw):
    want, got = jsolver.make_solver_grid(**kw), solver.make_solver_grid(**kw)
    for name in ("reverse_timesteps", "reverse_boundaries", "forward_timesteps",
                 "forward_boundaries", "ddim_timesteps"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)


def test_predicted_origin_and_add_noise_match_jax():
    rng = np.random.default_rng(7)
    x, eps = rng.normal(size=(2, 4, 8, 8)).astype(np.float32), rng.normal(size=(2, 4, 8, 8)).astype(np.float32)
    t, s = np.array([999, 259]), np.array([779, 0])  # s == 0 takes the hard boundary
    js, ts = jschedule.make_schedule(), schedule.make_schedule()
    want = jsolver.predicted_origin(
        jnp.asarray(eps), jnp.asarray(t), jnp.asarray(s), jnp.asarray(x),
        js.sqrt_alphas_cumprod, js.sqrt_one_minus_alphas_cumprod,
    )
    got = solver.predicted_origin(
        torch.from_numpy(eps), torch.from_numpy(t), torch.from_numpy(s), torch.from_numpy(x),
        ts.sqrt_alphas_cumprod, ts.sqrt_one_minus_alphas_cumprod,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    want_n = jschedule.add_noise(js, jnp.asarray(x), jnp.asarray(eps), jnp.asarray(t))
    got_n = schedule.add_noise(ts, torch.from_numpy(x), torch.from_numpy(eps), torch.from_numpy(t))
    np.testing.assert_allclose(got_n.numpy(), np.asarray(want_n), atol=1e-6, rtol=1e-6)


def test_guidance_schedules_and_w_embedding_match_jax():
    t = np.array([0, 259, 519, 700, 779, 999])
    for fn, jfn, kw in (
        (guidance.linear_schedule_old, jguidance.linear_schedule_old, dict(tau1=0.5, tau2=0.8)),
        (guidance.linear_schedule, jguidance.linear_schedule, dict(tau1=0.4, tau2=0.8)),
    ):
        np.testing.assert_allclose(
            fn(torch.from_numpy(t), 7.5, **kw).numpy(), np.asarray(jfn(jnp.asarray(t), 7.5, **kw)),
            atol=1e-6,
        )
    g = dict(guidance_scale=19.0, w_embed_dim=16, dynamic_guidance=True, tau1=0.6, tau2=0.8,
             edit_pair=True)
    for step in (999, 700, 259):
        want = jsampler.w_embedding_for(jsampler.GuidanceConfig(**g), step, 2)
        got = sampler.w_embedding_for(sampler.GuidanceConfig(**g), step, 2)
        # w*1000 reaches 19000 rad: fp32 sin/cos range reduction differs by a few ulp
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3)


def test_entry_point_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InvertibleCD.sd15()


def test_tokenizers_match_jax(monkeypatch):
    prompts = ["a photo of a cat", "  A &amp; B, don't stop!  ", "", "ünïcode  words"]
    np.testing.assert_array_equal(
        tokenizer.HashTokenizer(1000)(prompts), jtokenizer.HashTokenizer(1000)(prompts)
    )
    # a small byte-level BPE vocabulary: every byte symbol, its </w> form, and two merges
    symbols = list(tokenizer.bytes_to_unicode().values())
    merges = [("c", "a"), ("ca", "t</w>")]
    vocab = {tok: i for i, tok in enumerate(
        symbols + [s + "</w>" for s in symbols] + ["ca", "cat</w>",
                                                   "<|startoftext|>", "<|endoftext|>"])}
    got = tokenizer.ClipTokenizer(vocab, merges, context_length=16)(prompts)
    want = jtokenizer.ClipTokenizer(vocab, merges, context_length=16)(prompts)
    np.testing.assert_array_equal(got, want)
    for var in ("ICD_TPU_CLIP_VOCAB", "ICD_TPU_CLIP_MERGES", "ICD_TPU_ASSETS"):
        monkeypatch.delenv(var, raising=False)
    assert isinstance(tokenizer.default_tokenizer(), tokenizer.HashTokenizer)


def test_to_uint8():
    x = torch.tensor([[-0.5, 0.0, 0.5, 1.0, 2.0]])
    np.testing.assert_array_equal(to_uint8(x), np.array([[0, 0, 128, 255, 255]], np.uint8))
