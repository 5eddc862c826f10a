"""The port's invert, edit and decode against the JAX package's tiny
bundle, fp32 on the CPU (the generate trajectory is in
`test_torch_pipeline.py`).

The port's tiny bundle is built from the JAX tiny bundle's params (teacher,
both students, CLIP, VAE) through the weights bridge. Start latents and
inversion noise are drawn by JAX (torch generators and threefry differ) and
passed to the port. Each JAX call runs once, in a module-scoped fixture.
Tolerances as in `test_torch_pipeline.py`: atol 1e-4 / rtol 1e-3 on images,
latents and stored attention maps (fp32 in both frameworks, four UNet hops
plus the VAE, differing in summation order).
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from invertible_cd_tpu.edit import make_controller as jmake_controller
from invertible_cd_tpu_torch.edit import make_controller
from invertible_cd_tpu_torch.models import convert
from invertible_cd_tpu_torch.testing import tiny_bundle

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "tiny_pipeline.npz")
ATOL, RTOL = 1e-4, 1e-3
PROMPT = "a photo of a cat"
SOURCE, TARGET = "a photo of a cat on the grass", "a photo of a dog on the grass"
CONTROLLER = dict(num_steps=4, cross_replace_steps=0.6, self_replace_steps=0.4,
                  blend_words=[["cat"], ["dog"]], equalizer_params={"words": ["dog"], "values": [2.0]})


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _image(seed=0):
    return np.random.default_rng(seed).integers(0, 255, (32, 32, 3), np.uint8)


@pytest.fixture(scope="module")
def port_pipe(tiny_pipe):
    p = tiny_pipe.params
    return tiny_bundle({
        **{name: convert.unet_state_dict_from_flax(_np_tree(p[name]))
           for name in ("teacher", "reverse", "forward")},
        "text": convert.clip_state_dict_from_flax(_np_tree(p["text"])),
        "vae": convert.vae_state_dict_from_flax(_np_tree(p["vae"])),
    })


@pytest.fixture(scope="module")
def jax_runs(tiny_pipe):
    """invert and edit (store_all), each run once by the JAX package (the
    edit's inversion is the invert's compiled program)."""
    out = {"inv_noise": np.asarray(jax.random.normal(jax.random.PRNGKey(1), (1, 16, 16, 4)))}
    inv, clean = tiny_pipe.invert(_image(), PROMPT, key=jax.random.PRNGKey(1))
    out["inv"], out["inv_clean"] = np.asarray(inv), np.asarray(clean)
    spec, arrays = jmake_controller([SOURCE, TARGET], tiny_pipe.tokenizer, **CONTROLLER)
    spec = dataclasses.replace(spec, store_all=True)
    out["edit_noise"] = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (1, 16, 16, 4)))
    images, latents, store = tiny_pipe.edit(_image(5), SOURCE, TARGET, (spec, arrays),
                                            key=jax.random.PRNGKey(2))
    out["edit"] = (np.asarray(images), np.asarray(latents),
                   {k: [np.asarray(m) for m in v] for k, v in store.items()})
    return out


def test_invert_matches_golden(port_pipe, jax_runs):
    inv, _ = port_pipe.invert(_image(), PROMPT, noise=jax_runs["inv_noise"])
    assert tuple(inv.shape) == (1, 16, 16, 4)
    np.testing.assert_allclose(inv.numpy(), np.load(GOLDEN)["inv_latents"], atol=ATOL, rtol=RTOL)


def test_invert_matches_jax(port_pipe, jax_runs):
    """The noise and clean latents, and the trajectory's ends: row 0 the
    noised clean latent, the last row the noise latent."""
    inv, clean = port_pipe.invert(_image(), PROMPT, noise=jax_runs["inv_noise"])
    np.testing.assert_allclose(clean.numpy(), jax_runs["inv_clean"], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(inv.numpy(), jax_runs["inv"], atol=ATOL, rtol=RTOL)
    traj, _ = port_pipe.invert(_image(), PROMPT, noise=jax_runs["inv_noise"],
                               return_trajectory=True)
    assert tuple(traj.shape) == (5, 1, 16, 16, 4)
    torch.testing.assert_close(traj[-1], inv, atol=0, rtol=0)
    start = port_pipe.grid.start_timestep
    noised = (port_pipe.schedule.sqrt_alphas_cumprod[start] * clean
              + port_pipe.schedule.sqrt_one_minus_alphas_cumprod[start] * torch.tensor(jax_runs["inv_noise"]))
    np.testing.assert_allclose(traj[0].numpy(), noised.numpy(), atol=1e-6, rtol=1e-6)


def test_edit_matches_jax(port_pipe, jax_runs):
    """replace + LocalBlend + equalizer + store_all: images, latents and
    every stored map, per store_key and in call order."""
    spec, arrays = make_controller([SOURCE, TARGET], port_pipe.tokenizer, **CONTROLLER)
    spec = dataclasses.replace(spec, store_all=True)
    images, latents, store = port_pipe.edit(_image(5), SOURCE, TARGET, (spec, arrays),
                                            noise=jax_runs["edit_noise"])
    want_images, want_latents, want_store = jax_runs["edit"]
    assert tuple(images.shape) == (2, 32, 32, 3) and tuple(latents.shape) == (2, 16, 16, 4)
    np.testing.assert_allclose(latents.numpy(), want_latents, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(images.numpy(), want_images, atol=ATOL, rtol=RTOL)
    assert sorted(store) == sorted(want_store)
    for key, maps in want_store.items():
        assert len(store[key]) == len(maps), key
        for got, want in zip(store[key], maps):
            np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL, err_msg=key)


def test_edit_is_repeatable_and_keeps_the_source_row(port_pipe, jax_runs):
    """Same image and noise, same output; row 0 is never edited, so it is the
    unedited reconstruction of the inverted latent at w = 0."""
    spec, arrays = make_controller([SOURCE, TARGET], port_pipe.tokenizer, **CONTROLLER)
    noise = jax_runs["edit_noise"]
    images, latents = port_pipe.edit(_image(5), SOURCE, TARGET, (spec, arrays), noise=noise)
    again, _ = port_pipe.edit(_image(5), SOURCE, TARGET, (spec, arrays), noise=noise)
    torch.testing.assert_close(again, images, atol=0, rtol=0)
    inv, _ = port_pipe.invert(_image(5), SOURCE, noise=noise)
    recon, _ = port_pipe.generate([SOURCE], latent=inv, guidance=port_pipe.default_guidance(
        guidance_scale=0.0))
    np.testing.assert_allclose(images[:1].numpy(), recon.numpy(), atol=ATOL, rtol=RTOL)


def test_decode_matches_jax(port_pipe, jax_runs):
    """`decode` of the JAX edit's final latents gives the JAX edit's images
    (its decode and clamp)."""
    want_images, want_latents, _ = jax_runs["edit"]
    got = port_pipe.decode(want_latents)
    assert isinstance(got, np.ndarray) and got.shape == (2, 32, 32, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want_images, atol=ATOL, rtol=RTOL)
