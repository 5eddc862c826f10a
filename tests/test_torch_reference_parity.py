"""Full-shape replay of the synthetic SD1.5 pack through the PyTorch port.

The port's twin of `tests/test_reference_parity.py` on its synthetic
fallback: the recorded pack `tests/golden/synth_pack_sd15.npz` (inputs,
noise and reference activations and trajectories, recorded by
`tools/make_synthetic_pack.py` with the reference's inference semantics in
torch) is replayed through `invertible_cd_tpu_torch` at the full SD1.5
shapes (860M UNet, 64x64 latents, the full VAE, ViT-L CLIP), in fp32 on the
CPU. The weights come from `tools/make_synthetic_pack.py ensure_weights`
(written into the git-ignored `tests/golden/synth_sd15/` from numpy's seeded
stream when absent, about a minute, in a subprocess: the writer builds its
modules from the JAX package's configs) and are loaded through the port's
own `pipelines.loading.load_bundle_params`: diffusers / transformers state
dicts and kohya LoRAs fused at their alpha and rank. Nothing of the JAX
package is imported in this process. Tolerances are the JAX tests' own.

Marked `slow`: it holds two full UNets (the students; the teacher is not
replayed) and runs 18 full-size UNet calls and a 512^2 VAE round trip.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from invertible_cd_tpu_torch.edit import make_controller
from invertible_cd_tpu_torch.pipelines.loading import load_bundle_params
from invertible_cd_tpu_torch.pipelines.pipeline import InvertibleCD

_GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")
PACK = os.path.join(_GOLDEN, "synth_pack_sd15.npz")
WEIGHTS = os.path.join(_GOLDEN, "synth_sd15")

pytestmark = [
    pytest.mark.slow,  # full 860M shapes on the CPU
    pytest.mark.skipif(not os.path.exists(PACK), reason="no synthetic SD1.5 pack"),
]


def _find(name):
    for ext in (".safetensors", ".pt", ".bin"):
        p = os.path.join(WEIGHTS, name + ext)
        if os.path.exists(p):
            return p
    return None


@pytest.fixture(scope="module")
def pack():
    return dict(np.load(PACK))


@pytest.fixture(scope="module")
def pipe():
    subprocess.run([sys.executable, "-c",
                    "import sys; sys.path.insert(0, sys.argv[1]); "
                    "from make_synthetic_pack import ensure_weights; ensure_weights(sys.argv[2])",
                    TOOLS, WEIGHTS], check=True)
    params = load_bundle_params(
        teacher=_find("teacher"), vae=_find("vae"), text=_find("text_encoder"),
        reverse_lora=_find("reverse"), forward_lora=_find("forward"),
    )
    del params["teacher"]  # the students share its tensors outside their adapted weights
    return InvertibleCD.sd15(params=params, device="cpu", dtype=torch.float32)


def _nhwc(x_nchw):
    return np.transpose(x_nchw, (0, 2, 3, 1))


def _final_gate(final, want):
    # scale-aware, as the JAX test: synthetic random-weight trajectories reach
    # ~70 because each consistency hop multiplies by alpha_s / alpha_t
    err = np.abs(np.asarray(final) - want).max()
    tol = max(0.1, 2e-3 * float(np.abs(want).max()))
    return err, tol


@torch.inference_mode()
def test_clip_parity(pack, pipe):
    tokens = torch.as_tensor(pack["clip/tokens"], dtype=torch.long)
    got = pipe.text_encoder(tokens)["last_hidden_state"].numpy()
    np.testing.assert_allclose(got, pack["clip/last_hidden"], atol=2e-4, rtol=1e-3)


@torch.inference_mode()
def test_unet_epsilon_parity(pack, pipe):
    """The reverse student's epsilon, and the activations after conv_in,
    every down block, the mid block and every up block: a converter or
    loader fault fails at the first stage that diverges."""
    unet = pipe.unets["reverse"]
    stages = {"unet/conv_in": unet.conv_in, "unet/mid": unet.mid_block,
              **{f"unet/down_{i}": b for i, b in enumerate(unet.down_blocks)},
              **{f"unet/up_{i}": b for i, b in enumerate(unet.up_blocks)}}
    acts = {}
    handles = [module.register_forward_hook(
        lambda m, args, out, key=key: acts.__setitem__(key, out[0] if isinstance(out, tuple) else out))
        for key, module in stages.items()]
    try:
        got = unet(torch.from_numpy(pack["inputs/latent"]), torch.from_numpy(pack["inputs/t"]),
                   torch.from_numpy(pack["clip/last_hidden"]),
                   w_cond=torch.from_numpy(pack["inputs/w_emb"])).numpy()
    finally:
        for h in handles:
            h.remove()
    for key in stages:
        want = pack[key].astype(np.float32)
        err = np.abs(acts[key].numpy() - want).max() / max(np.abs(want).max(), 1e-6)
        assert err < 5e-3, f"stage {key} relative error {err}"
    want = pack["unet/out"]
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
    assert err < 5e-3, f"UNet epsilon relative error {err}"


@torch.inference_mode()
def test_vae_parity(pack, pipe):
    mean = pipe.vae.encode_mean(torch.from_numpy(pack["inputs/pixels"].astype(np.float32)))
    np.testing.assert_allclose(mean.numpy(), pack["vae/mean"], atol=5e-3, rtol=1e-2)
    dec = pipe.vae.decode(torch.from_numpy(pack["vae/mean"]))
    np.testing.assert_allclose(dec.numpy(), pack["vae/decode"].astype(np.float32), atol=5e-3, rtol=1e-2)


def test_generation_trajectory_parity(pack, pipe):
    """The recorded seed-150 start noise through the 4-hop reverse-CD sampler."""
    latent = np.broadcast_to(_nhwc(pack["gen/noise"]), (1, 64, 64, 4))
    g = pipe.default_guidance(guidance_scale=19.0, dynamic_guidance=False)
    _, traj = pipe.generate(["a photo of a corgi on the beach"], latent=latent, guidance=g,
                            return_trajectory=True)
    n_rows = len([k for k in pack if k.startswith("gen/latents")])
    assert traj.shape[0] == n_rows
    for i in range(n_rows):
        err, tol = _final_gate(traj[i].numpy(), _nhwc(pack[f"gen/latents_{i}"]))
        assert err < tol, f"trajectory row {i} divergence {err} (tol {tol})"


def test_inversion_parity_and_lpips_north_star(pack, pipe):
    """Forward-CD inversion under the source prompt with the recorded noise.
    The LPIPS <= 0.05 round-trip gate of the JAX test needs LPIPS weights,
    which the synthetic weights directory does not hold (and the metrics
    are a later slice of the port): as in the JAX test, it is not reached."""
    pixels01 = _nhwc(pack["inputs/pixels"]).astype(np.float32) * 0.5 + 0.5
    image = (pixels01[0] * 255).astype(np.uint8)
    inv, _ = pipe.invert(image, str(pack["edit/source"]), noise=_nhwc(pack["inv/noise"]))
    err = np.abs(inv.numpy() - _nhwc(pack["inv/latents_final"])).max()
    assert err < 0.1, f"inversion latent divergence {err}"
    assert _find("lpips_vgg") is None or _find("lpips_lin") is None


def test_edit_trajectory_parity(pack, pipe):
    """The recorded p2p-controlled edit: the same inverted latent and
    controller, so the final [source, target] latents and the step-0
    controller output of the first 16^2 down cross layer must match."""
    import dataclasses

    src, tgt = str(pack["edit/source"]), str(pack["edit/target"])
    sw, tw = str(pack["edit/blend_src"]).split(), str(pack["edit/blend_tgt"]).split()
    spec, arrays = make_controller(
        [src, tgt], pipe.tokenizer, num_steps=4, is_replace_controller=True,
        cross_replace_steps=float(pack["edit/cross_replace_steps"]),
        self_replace_steps=float(pack["edit/self_replace_steps"]),
        blend_words=[sw, tw] if sw else None,
        equalizer_params={"words": tw, "values": (4.0,) * len(tw)} if tw else None,
    )
    spec = dataclasses.replace(spec, store_all=True)
    g = pipe.default_guidance(guidance_scale=19.0, dynamic_guidance=True, tau1=0.8, tau2=0.8,
                              edit_pair=True)
    inv = _nhwc(pack["inv/latents_final"])
    latent = np.broadcast_to(inv, (2,) + inv.shape[1:])
    _, final, store = pipe.generate([src, tgt], latent=latent, guidance=g, controller=(spec, arrays))
    n_hops = len([k for k in pack if k.startswith("edit/latents")])
    err, tol = _final_gate(final.numpy(), _nhwc(pack[f"edit/latents_{n_hops - 1}"]))
    assert err < tol, f"edited latent divergence {err} (tol {tol})"

    # step 0, the first 16^2 down cross layer (call order 1024, 1024, 256, 256
    # per step); the recorded capture is the edited cond half (2H, 256, 77)
    got = [m.numpy() for m in store["down_cross"] if m.shape[2] == 256][0]
    want = pack["edit/attn_down16_step0"].reshape(2, -1, 256, pack["edit/attn_down16_step0"].shape[-1])
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err < 5e-3, f"controller attention divergence {err}"
