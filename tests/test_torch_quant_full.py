"""One full-width SD1.5 int8 generate of the port against the JAX package's
(`slow`): the synthetic checkpoint files of `tools/make_synthetic_pack.py
ensure_weights` (written into the git-ignored `tests/golden/synth_sd15/`
when absent: the teacher, the VAE, CLIP and the reverse student's kohya
LoRA), loaded by each package's own `load_bundle_params`, fp32 on the CPU,
both on the 4-hop grid, one prompt from the same start latent (JAX's draw
for PRNGKey(150)). The images must sit within the JAX tests' flip envelope
(`tests/test_parallel_inference.py:177-178`: mean |diff| < 2e-2, max <
2e-1); the int8_vae latents hold the generate parity tolerance of the
full-width replay (the UNets are float there).

Marked `slow`: two 860M UNets and two full VAEs in fp32, in two packages.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invertible_cd_tpu.pipelines.loading import load_bundle_params as jload_bundle_params
from invertible_cd_tpu.pipelines.pipeline import InvertibleCD as JInvertibleCD
from invertible_cd_tpu_torch.pipelines.loading import load_bundle_params
from invertible_cd_tpu_torch.pipelines.pipeline import InvertibleCD

FULL_WEIGHTS = os.path.join(os.path.dirname(__file__), "golden", "synth_sd15")
PROMPT = "a photo of a corgi on the beach"

pytestmark = pytest.mark.slow  # full 860M shapes on the CPU, in both packages


@pytest.fixture(scope="module")
def pipes():
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    from make_synthetic_pack import ensure_weights

    ensure_weights(FULL_WEIGHTS)
    files = {name: os.path.join(FULL_WEIGHTS, f"{file}.safetensors") for name, file in (
        ("teacher", "teacher"), ("vae", "vae"), ("text", "text_encoder"), ("reverse_lora", "reverse"))}
    jpipe = JInvertibleCD.sd15(dtype=jnp.float32)
    jpipe.params = jload_bundle_params(**files, params=jpipe.params)
    params = load_bundle_params(**files)
    params.pop("teacher", None)
    pipe = InvertibleCD.sd15(params=params, device="cpu", dtype=torch.float32)
    latent = np.asarray(jpipe.init_latent(jax.random.PRNGKey(150), 1))
    return jpipe, pipe, latent


@pytest.mark.parametrize("mode", ["int8", "int8_vae"])
def test_full_width_int8_generate_matches_jax(pipes, mode):
    jpipe, pipe, latent = pipes
    jpipe.quantize, pipe.quantize = mode, mode
    try:
        want, want_lat = jpipe.generate([PROMPT], latent=jnp.asarray(latent))
        got, lat = pipe.generate([PROMPT], latent=torch.from_numpy(latent))
    finally:
        jpipe.quantize, pipe.quantize = "off", "off"
    diff = np.abs(got.numpy() - np.asarray(want))
    assert np.isfinite(got.numpy()).all()
    assert diff.mean() < 2e-2 and diff.max() < 2e-1, (diff.mean(), diff.max())
    if mode == "int8_vae":
        want_lat = np.asarray(want_lat)
        err = np.abs(lat.numpy() - want_lat).max()
        assert err <= max(0.1, 2e-3 * float(np.abs(want_lat).max())), err
