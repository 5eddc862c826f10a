"""Full-shape replay of the synthetic SDXL pack through the PyTorch port.

The port's twin of `tests/test_reference_parity_sdxl.py` on its synthetic
fallback: the recorded pack `tests/golden/synth_pack_sdxl.npz` (dual tokens,
context and pooled embeds, the UNet stage by stage and its epsilon, the fp32
VAE mean and decode, the 4-hop generation, the forward-CD inversion and the
amplify-prompt edit, recorded by `tools/make_synthetic_pack_sdxl.py` with the
reference's inference semantics in torch at 512^2) is replayed through
`invertible_cd_tpu_torch` at SDXL's full width and depth (the 2.6B UNet,
ViT-L and OpenCLIP bigG, the fp32 VAE), fp32 on the CPU. The weights come
from `tools/make_synthetic_pack_sdxl.py ensure_weights_sdxl` (written into
the git-ignored `tests/golden/synth_sdxl/`, about 14 GB, from numpy's seeded
stream when absent, in a subprocess: the writer builds its modules from the
JAX package's configs) and are loaded through the port's own
`pipelines.loading.load_bundle_params`: diffusers / transformers state dicts
and kohya LoRAs fused at their alpha and rank. One fp32 student is held at a
time (about 10 GB each): the reverse student's tests run first, then the
forward student's. Nothing of the JAX package is imported in this process.
Tolerances are the JAX test's own (fp32 pack: atol 2e-3, rtol 5e-3; the VAE
5e-3 / 1e-2; final latents max(0.1, 2e-3 max |want|)).

Marked `slow`: full 2.6B-parameter shapes on the CPU.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from invertible_cd_tpu_torch.pipelines.loading import load_bundle_params
from invertible_cd_tpu_torch.pipelines.sdxl import InvertibleCDXL

_GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")
PACK = os.path.join(_GOLDEN, "synth_pack_sdxl.npz")
WEIGHTS = os.path.join(_GOLDEN, "synth_sdxl")
ATOL, RTOL = 2e-3, 5e-3  # the JAX test's fp32-pack tolerances

pytestmark = [
    pytest.mark.slow,  # full 2.6B-parameter shapes on the CPU
    pytest.mark.skipif(not os.path.exists(PACK), reason="no synthetic SDXL pack"),
]


def _find(name):
    for ext in (".safetensors", ".pt", ".bin"):
        p = os.path.join(WEIGHTS, name + ext)
        if os.path.exists(p):
            return p
    return None


def _nhwc(x_nchw):
    return np.transpose(x_nchw, (0, 2, 3, 1))


def _final_gate(final, want):
    # scale-aware, as the JAX test: synthetic random-weight trajectories reach
    # larger magnitudes than real ones (each hop multiplies by alpha_s / alpha_t)
    err = np.abs(np.asarray(final) - want).max()
    tol = max(0.1, 2e-3 * float(np.abs(want).max()))
    return err, tol


@pytest.fixture(scope="module")
def pack():
    return dict(np.load(PACK))


@pytest.fixture(scope="module")
def shared():
    """The text encoders and the VAE, and a slot for the one student held."""
    subprocess.run([sys.executable, "-c",
                    "import sys; sys.path.insert(0, sys.argv[1]); "
                    "from make_synthetic_pack_sdxl import ensure_weights_sdxl; "
                    "ensure_weights_sdxl(sys.argv[2])",
                    TOOLS, WEIGHTS], check=True)
    params = load_bundle_params(vae=_find("vae"), text=_find("text_encoder"),
                                text_2=_find("text_encoder_2"))
    return {"params": params, "pipe": None}


def _pipe(shared, student: str) -> InvertibleCDXL:
    """The SDXL bundle with `student` ("reverse" or "forward") only: the
    teacher with that student's kohya LoRA fused in, the one held before
    dropped first."""
    pipe = shared["pipe"]
    if pipe is not None and student in pipe.unets:
        return pipe
    shared["pipe"] = pipe = None
    unet = load_bundle_params(teacher=_find("teacher"),
                              **{f"{student}_lora": _find(student)})[student]
    shared["pipe"] = InvertibleCDXL.sdxl(params={**shared["params"], student: unet},
                                        device="cpu", dtype=torch.float32)
    return shared["pipe"]


@torch.inference_mode()
def test_tokenizer_and_dual_encoder_parity(pack, shared):
    """Both tokenizers give the recorded ids (tokenizer_2 pads with 0), and
    the context (both encoders' penultimate states) and bigG's projected
    pooled embedding match."""
    pipe = _pipe(shared, "reverse")
    prompts = [str(pack["edit/source"]), str(pack["edit/target"])]
    np.testing.assert_array_equal(np.asarray(pipe.tokenizer(prompts)), pack["clip/tokens"])
    np.testing.assert_array_equal(np.asarray(pipe.tokenizer_2(prompts)), pack["clip/tokens2"])
    ctx, pooled = pipe.encode_prompt_xl(prompts)
    np.testing.assert_allclose(ctx.numpy(), pack["clip/context"], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(pooled.numpy(), pack["clip/pooled"], atol=ATOL, rtol=RTOL)


@torch.inference_mode()
def test_unet_epsilon_parity(pack, shared):
    """The reverse student's epsilon with the recorded added conditioning, and
    the activations after conv_in, every down block, the mid block and every
    up block."""
    unet = _pipe(shared, "reverse").unets["reverse"]
    stages = {"unet/conv_in": unet.conv_in, "unet/mid": unet.mid_block,
              **{f"unet/down_{i}": b for i, b in enumerate(unet.down_blocks)},
              **{f"unet/up_{i}": b for i, b in enumerate(unet.up_blocks)}}
    acts = {}
    handles = [module.register_forward_hook(
        lambda m, args, out, key=key: acts.__setitem__(key, out[0] if isinstance(out, tuple) else out))
        for key, module in stages.items()]
    added = {"text_embeds": torch.from_numpy(pack["clip/pooled"]),
             "time_ids": torch.from_numpy(pack["inputs/time_ids"])}
    try:
        got = unet(torch.from_numpy(pack["inputs/latent"]), torch.from_numpy(pack["inputs/t"]),
                   torch.from_numpy(pack["clip/context"]),
                   w_cond=torch.from_numpy(pack["inputs/w_emb"]), added_cond=added).numpy()
    finally:
        for h in handles:
            h.remove()
    for key in stages:
        want = pack[key].astype(np.float32)
        err = np.abs(acts[key].numpy() - want).max() / max(np.abs(want).max(), 1e-6)
        assert err < RTOL, f"stage {key} relative error {err}"
    want = pack["unet/out"]
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
    assert err < RTOL, f"SDXL UNet epsilon relative error {err}"


@torch.inference_mode()
def test_vae_parity(pack, shared):
    """fp32 both ways: the reference decodes the SDXL VAE in fp32, and so
    does the port by default."""
    vae = _pipe(shared, "reverse").vae
    assert vae.dtype == torch.float32
    mean = vae.encode_mean(torch.from_numpy(pack["inputs/pixels"].astype(np.float32)))
    np.testing.assert_allclose(mean.numpy(), pack["vae/mean"], atol=5e-3, rtol=1e-2)
    dec = vae.decode(torch.from_numpy(pack["vae/mean"]))
    np.testing.assert_allclose(dec.numpy(), pack["vae/decode"].astype(np.float32),
                               atol=5e-3, rtol=1e-2)


def test_generation_trajectory_parity(pack, shared):
    """The recorded init latent through 4 hops at static guidance 7.0."""
    pipe = _pipe(shared, "reverse")
    g = pipe.default_guidance(guidance_scale=7.0, dynamic_guidance=False)
    _, final = pipe.generate([str(pack["edit/source"])], latent=_nhwc(pack["gen/init"]),
                             guidance=g)
    err, tol = _final_gate(final.numpy(), _nhwc(pack["gen/latents_final"]))
    assert err < tol, f"SDXL generation final-latent divergence {err} (tol {tol})"


def test_amplify_edit_parity(pack, shared):
    """The reference SDXL editing protocol from the recorded inverted latent:
    the TARGET prompt under dynamic guidance 19.0 / tau 0.7 with
    amplify_prompt=[source]. The LPIPS <= 0.05 gate of the JAX test needs
    LPIPS weights, which the synthetic weights directory does not hold (the
    metrics are a later slice of the port): as there, it is not reached."""
    pipe = _pipe(shared, "reverse")
    g = pipe.default_guidance(guidance_scale=19.0, dynamic_guidance=True, tau1=0.7, tau2=0.7)
    _, final = pipe.generate([str(pack["edit/target"])], latent=_nhwc(pack["inv/latents_final"]),
                             guidance=g, amplify_prompt=[str(pack["edit/source"])])
    err, tol = _final_gate(final.numpy(), _nhwc(pack["edit/latents_final"]))
    assert err < tol, f"SDXL edited-latent divergence {err} (tol {tol})"
    assert _find("lpips_vgg") is None or _find("lpips_lin") is None


def test_inversion_parity(pack, shared):
    """Forward-CD inversion at guidance 0, from the exact start noise that
    makes the port's noising land on the recorded start latent (the
    reference samples the posterior and noises it at t = 19 itself; solving
    the noising for the noise absorbs sample-vs-mean exactly)."""
    pipe = _pipe(shared, "forward")
    img = pack["inputs/image_u8"]
    with torch.inference_mode():
        pixels = torch.from_numpy(img.astype(np.float32) / 127.5 - 1.0).permute(2, 0, 1)[None]
        z0 = pipe.vae.encode_mean(pixels).numpy() * pipe.scaling_factor
    t0 = int(pipe.grid.start_timestep)
    ac = pipe.schedule.alphas_cumprod.numpy()
    a, s = float(np.sqrt(ac[t0])), float(np.sqrt(1.0 - ac[t0]))
    noise = _nhwc((pack["inv/start"] - a * z0) / s)
    inv, _ = pipe.invert(img, str(pack["edit/source"]), noise=noise)
    err, tol = _final_gate(inv.numpy(), _nhwc(pack["inv/latents_final"]))
    assert err < tol, f"SDXL inversion final-latent divergence {err} (tol {tol})"
