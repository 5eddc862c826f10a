"""The port's DDIM, null-text (NTI) and negative-prompt (NPI) baselines
against the JAX package, fp32 on the CPU.

The JAX package's tiny SD1.5 bundle gets numpy-seeded weights, and the
port's tiny bundle is built from them (teacher, students, CLIP, VAE)
through the weights bridge; start latents are drawn with numpy and handed
to both packages. Each JAX program runs once, in a
module-scoped fixture: JAX's own `ddim_invert`, and for generation JAX's
`sampler.ddim_loop` compiled with `return_all` (the loop `ddim_generate`
runs, here returning its trajectory), one program serving the plain run and
NPI, one the controlled pair.

Tolerances: atol 1e-4 / rtol 1e-3 (the port's pipeline tolerance), with the
absolute part scaled by max(1, max |want| / 10) as in `test_torch_sdxl.py`
(the CFG 7.5 latents reach |x| ~ 30). The 50-step loops are compared step
by step, teacher-forced: the port's loop takes JAX's latent at every step
(its step callback swaps it in) and its output is held to JAX's next row,
so no per-step error can hide in an end-to-end limit. The end-to-end runs
are held at the same tolerance. NTI runs on a 4-step grid with 2 inner
iterations, each outer step teacher-forced with JAX's inputs, then end to
end. SDXL's `ddim_generate` runs on a 10-step grid (its tiny UNet's loop
is the one the SD1.5 runs cover at 50 steps).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invertible_cd_tpu.diffusion import guidance as jguidance
from invertible_cd_tpu.diffusion import schedule as jschedule
from invertible_cd_tpu.diffusion import solver as jsolver
from invertible_cd_tpu import models as jmodels
from invertible_cd_tpu.edit import controllers as jcontrollers
from invertible_cd_tpu.pipelines import nti as jnti
from invertible_cd_tpu.pipelines import sampler as jsampler
from invertible_cd_tpu.pipelines.pipeline import InvertibleCD as JInvertibleCD
from invertible_cd_tpu.utils.tokenizer import HashTokenizer as JHashTokenizer
from invertible_cd_tpu.testing import tiny_bundle_xl as jtiny_bundle_xl
from invertible_cd_tpu_torch.diffusion import guidance, schedule, solver
from invertible_cd_tpu_torch.edit import (
    ControllerRuntime, aggregate_attention, make_controller, spatial_replace_controller)
from invertible_cd_tpu_torch.models import convert
from invertible_cd_tpu_torch.models.clip import CLIPTextModel
from invertible_cd_tpu_torch.models.layers import fan_in_init_
from invertible_cd_tpu_torch.models.lora import merge_lora, seeded_lora
from invertible_cd_tpu_torch.models.unet2d import UNet2DCondition
from invertible_cd_tpu_torch.models.vae import AutoencoderKL
from invertible_cd_tpu_torch.pipelines import nti, sampler
from invertible_cd_tpu_torch.pipelines.pipeline import InvertibleCD
from invertible_cd_tpu_torch.testing import tiny_bundle, tiny_bundle_xl, tiny_configs
from invertible_cd_tpu_torch.utils.tokenizer import HashTokenizer

from _torch_jax_params import seeded_params

ATOL, RTOL = 1e-4, 1e-3
PROMPT = "a photo of a cat"
SOURCE, TARGET = "a photo of a cat on the grass", "a photo of a dog on the grass"
CONTROLLER = dict(cross_replace_steps=0.6, self_replace_steps=0.4, blend_words=[["cat"], ["dog"]],
                  equalizer_params={"words": ["dog"], "values": [2.0]})
CFG = dict(guidance_scale=7.5, w_embed_dim=0)
NTI_STEPS, NTI_INNER = 4, 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's tiny models: their ops are too
    small to share out, and under the suite's parallel workers the threads
    oversubscribe the cores (a 50-step loop then took 100x its time alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _image(seed=0):
    return np.random.default_rng(seed).integers(0, 255, (32, 32, 3), np.uint8)


def _latent(batch, seed):
    z = np.random.default_rng(seed).standard_normal((1, 16, 16, 4)).astype(np.float32)
    return np.ascontiguousarray(np.broadcast_to(z, (batch, 16, 16, 4)))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _close(got, want, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    atol = ATOL * max(1.0, float(np.abs(want).max()) / 10)
    np.testing.assert_allclose(got, want, atol=atol, rtol=RTOL, err_msg=msg)


# ---------------------------------------------------------------------------
# DDIM steps and the CFG mix
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("t", [19, 39, 499, 979, 999])
def test_ddim_steps_match_jax(t):
    """Both directions at a python-int and a per-row timestep, 20 apart (the
    50-step grid's ratio): t = 19 takes `final_alpha_cumprod` both ways, t =
    999 the forward step's clamp to 999."""
    rng = np.random.default_rng(t)
    eps, x = (rng.standard_normal((2, 8, 8, 4)).astype(np.float32) for _ in range(2))
    js, ps = jschedule.make_schedule(), schedule.make_schedule()
    for tt in (t, np.array([t, 39], np.int64)):
        for jfn, fn in ((jsolver.ddim_prev_step, solver.ddim_prev_step),
                        (jsolver.ddim_next_step, solver.ddim_next_step)):
            want = jfn(jnp.asarray(eps), jnp.asarray(tt), jnp.asarray(x), js, 20)
            got = fn(torch.from_numpy(eps), torch.as_tensor(tt), torch.from_numpy(x), ps, 20)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6,
                                       err_msg=f"{fn.__name__} t={tt}")


def test_cfg_combine_matches_jax():
    rng = np.random.default_rng(1)
    text, uncond = (rng.standard_normal((2, 4, 8, 8)).astype(np.float32) for _ in range(2))
    for t in (100, 500, 700, 999):
        for kw in ({}, {"dynamic_guidance": True}, {"dynamic_guidance": True, "tau1": 0.3, "tau2": 0.9}):
            want = jguidance.cfg_combine(jnp.asarray(text), jnp.asarray(uncond), t, 7.5, **kw)
            got = guidance.cfg_combine(torch.from_numpy(text), torch.from_numpy(uncond), t, 7.5, **kw)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, err_msg=f"{t} {kw}")


# ---------------------------------------------------------------------------
# The seeded bundle's teacher
# ---------------------------------------------------------------------------
def test_seeded_bundle_has_the_unmerged_base_as_teacher():
    """Without params, `sd15` builds a "teacher": the seeded base before any
    LoRA is merged. The students, text encoder and VAE are what the same
    seed gave before the teacher existed: the draw order below is a copy of
    that earlier `build_modules` (base UNet, CLIP, VAE, then the reverse
    and the forward LoRA; the forward merged first, since the reverse merge
    writes into the base)."""
    u, c, v = tiny_configs()
    pipe = InvertibleCD.sd15(device="cpu", dtype=torch.float32, seed=5, lora_rank=4, unet_cfg=u,
                             clip_cfg=c, vae_cfg=v, latent_size=(16, 16),
                             tokenizer=HashTokenizer(c.vocab_size))
    gen = torch.Generator().manual_seed(5)
    unet, text, vae = UNet2DCondition(u), CLIPTextModel(c), AutoencoderKL(v)
    for module in (unet, text, vae):
        fan_in_init_(module, gen)
    base = unet.state_dict()
    unmerged = {k: t.clone() for k, t in base.items()}
    loras = {name: seeded_lora(base, gen, 4) for name in ("reverse", "forward")}
    want = {name: {k: t.clone() for k, t in merge_lora(base, loras[name], rank=4).items()}
            for name in ("forward", "reverse")}
    want["teacher"] = unmerged
    assert sorted(pipe.unets) == ["forward", "reverse", "teacher"]
    for name, state in want.items():
        got = pipe.unets[name].state_dict()
        assert got.keys() == state.keys()
        assert all(torch.equal(got[k], state[k]) for k in state), name
    for module, ref in ((pipe.text_encoder, text), (pipe.vae, vae)):
        ref_state = ref.state_dict()
        assert all(torch.equal(t, ref_state[k]) for k, t in module.state_dict().items())
    assert not any(torch.equal(pipe.unets["teacher"].state_dict()[k], want["reverse"][k])
                   for k in loras["reverse"])  # every adapted weight differs from the base


# ---------------------------------------------------------------------------
# The tiny bundle's baselines
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jpipe():
    """The JAX package's tiny SD1.5 bundle with numpy-seeded weights: built
    from `init_zero_params`' traced shapes (Flax's init, op by op, costs
    most of a minute here); its teacher is the UNet the baselines run."""
    unet_cfg = jmodels.UNetConfig.tiny()
    clip_cfg = jmodels.CLIPTextConfig.tiny()
    pipe = JInvertibleCD.sd15(dtype=jnp.float32, unet_cfg=unet_cfg, clip_cfg=clip_cfg,
                              vae_cfg=jmodels.VAEConfig.tiny(), latent_size=(16, 16),
                              tokenizer=JHashTokenizer(clip_cfg.vocab_size))
    return dataclasses.replace(pipe, params=seeded_params(pipe.params))


@pytest.fixture(scope="module")
def port_pipe(jpipe):
    return tiny_bundle(convert.bundle_state_dicts_from_flax(_np_tree(jpipe.params)))


def _jax_ddim_program(pipe, g, spec=None):
    """JAX's `ddim_loop` generating with `return_all` and per-step uncond
    contexts, compiled: (trajectory, store)."""
    def run(params, latent, ctx_u, ctx_c, per_step, arrays):
        rt = jcontrollers.ControllerRuntime(spec, arrays) if spec is not None else None
        traj = jsampler.ddim_loop(
            pipe._noise_model(params), latent, ctx_u, ctx_c, pipe.grid, pipe.schedule, g,
            is_forward=False, per_step_uncond=per_step,
            hook_factory=rt.hook_factory if rt else None,
            step_callback=rt.step_callback if rt else None, return_all=True)
        return traj, (rt.store if rt is not None and spec.store_all else {})
    return jax.jit(run)


@pytest.fixture(scope="module")
def jax_runs(jpipe):
    p = jpipe
    n = p.grid.n_steps
    out = {}
    traj, clean = p.ddim_invert(_image(), PROMPT)
    out["invert"] = np.asarray(traj), np.asarray(clean)

    g = jsampler.GuidanceConfig(**CFG)
    plain = _jax_ddim_program(p, g)
    ctx_u, ctx_c = p.encode_prompt([PROMPT])
    npi = jnti.negative_prompt_inversion(p, PROMPT)
    out["npi"] = np.asarray(npi)
    for name, per_step in (("generate", jnp.broadcast_to(ctx_u[None], (n,) + ctx_u.shape)),
                           ("npi_generate", npi)):
        traj, _ = plain(p.params["teacher"], jnp.asarray(_latent(1, 3)), ctx_u, ctx_c, per_step,
                        None)
        out[name] = np.asarray(traj), p.decode(traj[-1])

    spec, arrays = jcontrollers.make_controller([SOURCE, TARGET], p.tokenizer, n, **CONTROLLER)
    out["pair"] = _jax_pair(p, dataclasses.replace(spec, store_all=True), arrays, seed=4)
    return out


def _jax_pair(p, spec, arrays, seed):
    """JAX's controlled DDIM of the [source, target] pair from a shared
    numpy latent: (trajectory, images, store)."""
    n = p.grid.n_steps
    ctx_u, ctx_c = p.encode_prompt([SOURCE, TARGET])
    traj, store = _jax_ddim_program(p, jsampler.GuidanceConfig(**CFG), spec)(
        p.params["teacher"], jnp.asarray(_latent(2, seed)), ctx_u, ctx_c,
        jnp.broadcast_to(ctx_u[None], (n,) + ctx_u.shape), arrays)
    return np.asarray(traj), p.decode(traj[-1]), _np_tree(store)


def _forced_loop(pipe, prompts, latent, want_traj, guidance_cfg, is_forward, per_step=None,
                 controller=None):
    """The port's `ddim_loop` on the port pipe's teacher, teacher-forced: each
    step's output (after the controller's step callback) is held to JAX's
    next trajectory row, and that row goes on as the next input. Returns the
    controller runtime."""
    ctx_u, ctx_c, _ = pipe._encode_all(prompts)
    rt = ControllerRuntime(controller[0], controller[1]) if controller else None

    def forced(x, i):
        if rt is not None:
            x = rt.step_callback(x, i)
        _close(x.permute(0, 2, 3, 1), want_traj[i + 1], f"step {i}")
        return _nchw(want_traj[i + 1])
    sampler.ddim_loop(pipe._noise_model(pipe.unets["teacher"]), _nchw(latent), ctx_u, ctx_c,
                      pipe.grid, pipe.schedule, sampler.GuidanceConfig(**guidance_cfg), is_forward,
                      per_step_uncond=per_step, hook_factory=rt.hook_factory if rt else None,
                      step_callback=forced)
    return rt


def test_ddim_invert_matches_jax(port_pipe, jax_runs):
    """The 51-row trajectory (row 0 the clean latent, t ascending, CFG 1.0
    keeping the cond half), teacher-forced and end to end."""
    want_traj, want_clean = jax_runs["invert"]
    traj, clean = port_pipe.ddim_invert(_image(), PROMPT)
    assert tuple(traj.shape) == (51, 1, 16, 16, 4) and tuple(clean.shape) == (1, 16, 16, 4)
    _close(clean, want_clean)
    torch.testing.assert_close(traj[0], clean, atol=0, rtol=0)
    _forced_loop(port_pipe, [PROMPT], want_traj[0], want_traj, dict(guidance_scale=1.0, w_embed_dim=0),
                 True)
    _close(traj, want_traj)


def test_ddim_generate_matches_jax(port_pipe, jax_runs):
    """50 steps at CFG 7.5 from a numpy latent: teacher-forced, then the
    entry point end to end (latents and images)."""
    want_traj, want_images = jax_runs["generate"]
    _forced_loop(port_pipe, [PROMPT], want_traj[0], want_traj, CFG, False)
    images, latents = port_pipe.ddim_generate([PROMPT], latent=_latent(1, 3))
    assert tuple(images.shape) == (1, 32, 32, 3) and images.dtype == torch.float32
    _close(latents, want_traj[-1])
    _close(images, want_images)


def test_npi_matches_jax(port_pipe, jax_runs):
    """NPI's per-step contexts (the cond context broadcast over the steps)
    and the reconstruction `ddim_generate(nti_uncond=...)` gives with them."""
    want_traj, want_images = jax_runs["npi_generate"]
    npi = nti.negative_prompt_inversion(port_pipe, PROMPT)
    assert tuple(npi.shape) == (50, 1, 77, 32)
    _close(npi, jax_runs["npi"])
    _forced_loop(port_pipe, [PROMPT], want_traj[0], want_traj, CFG, False, per_step=npi)
    images, latents = port_pipe.ddim_generate([PROMPT], latent=_latent(1, 3), nti_uncond=npi)
    _close(latents, want_traj[-1])
    _close(images, want_images)


def test_controlled_pair_and_store_match_jax(port_pipe, jax_runs):
    """The 50-step DDIM + prompt-to-prompt baseline: replace + LocalBlend +
    equalizer with `store_all`, CFG batch 4. Teacher-forced (LocalBlend's
    maps accumulate over the same inputs as JAX's), then end to end. The
    store holds one step-averaged map per hooked layer, as JAX's scan form
    does, and `aggregate_attention` gives JAX's maps."""
    want_traj, want_images, want_store = jax_runs["pair"]
    spec, arrays = make_controller([SOURCE, TARGET], port_pipe.tokenizer, 50, **CONTROLLER)
    spec = dataclasses.replace(spec, store_all=True)
    rt = _forced_loop(port_pipe, [SOURCE, TARGET], want_traj[0], want_traj, CFG, False,
                      controller=(spec, arrays))
    assert sorted(rt.store) == sorted(want_store)
    for key, maps in want_store.items():
        assert len(rt.store[key]) == len(maps), key
        for got, want in zip(rt.store[key], maps):
            _close(got, want, key)
    images, latents, store = port_pipe.ddim_generate([SOURCE, TARGET], latent=_latent(2, 4),
                                                     controller=(spec, arrays))
    _close(latents, want_traj[-1])
    _close(images, want_images)
    jstore = {k: [jnp.asarray(m) for m in v] for k, v in want_store.items()}
    for res, places in ((16, ["down", "up"]), (8, ["mid"])):  # the tiny UNet's 256- and 64-token layers
        for is_cross in (True, False):
            want = jcontrollers.aggregate_attention(jstore, res, places, is_cross)
            _close(aggregate_attention(store, res, places, is_cross), want, f"{res} {is_cross}")
    assert not np.allclose(latents[0].numpy(), latents[1].numpy())


@pytest.mark.slow  # a JAX program of its own: keeps this file's time alone near a minute
def test_spatial_replace_matches_jax(jpipe, port_pipe):
    """SpatialReplace over 50 steps: the base row is copied onto the pair for
    the first 40, then the rows part."""
    want_traj, want_images, _ = _jax_pair(
        jpipe, *jcontrollers.spatial_replace_controller(jpipe.grid.n_steps), seed=5)
    controller = spatial_replace_controller(50)
    _forced_loop(port_pipe, [SOURCE, TARGET], want_traj[0], want_traj, CFG, False,
                 controller=controller)
    images, latents = port_pipe.ddim_generate([SOURCE, TARGET], latent=_latent(2, 5),
                                              controller=controller)
    _close(latents, want_traj[-1])
    _close(images, want_images)
    assert not torch.equal(latents[0], latents[1])


# ---------------------------------------------------------------------------
# Null-text inversion on a 4-step grid
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def nti_runs(jpipe, port_pipe):
    """JAX's `null_text_inversion` on a 4-step grid with 2 inner iterations,
    from the port's 4-step DDIM inversion (handed to both), with every
    outer step's inputs and outputs recorded from JAX's own step program."""
    jpipe = dataclasses.replace(jpipe, grid=jsolver.make_solver_grid(n_steps=NTI_STEPS))
    pipe = dataclasses.replace(port_pipe, grid=solver.make_solver_grid(n_steps=NTI_STEPS))
    traj, _ = pipe.ddim_invert(_image(7), PROMPT)
    steps = []
    build = jnti._build_nti_step

    def recording_build(*args):
        fn = build(*args)

        def step(params, *inputs):
            result = fn(params, *inputs)
            steps.append(tuple(np.asarray(x) for x in inputs + tuple(result)))
            return result
        return step
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnti, "_build_nti_step", recording_build)
        per_step, inverted = jnti.null_text_inversion(
            jpipe, None, PROMPT, num_inner_steps=NTI_INNER, trajectory=jnp.asarray(traj.numpy()))
    return pipe, traj, np.asarray(per_step), np.asarray(inverted), steps


def test_nti_steps_match_jax_teacher_forced(nti_runs):
    """Each outer step on JAX's inputs (embedding, current and target latent,
    t, lr, threshold): the optimised embedding, the next latent, the last
    loss and the inner iterations taken."""
    pipe, _, _, _, steps = nti_runs
    step = nti.make_nti_step(pipe, NTI_INNER, 7.5)
    assert len(steps) == NTI_STEPS
    for i, (u, cur, prev, ctx_c, t, lr, th, want_u, want_next, want_loss, want_n) in enumerate(steps):
        got_u, got_next, loss, n_iter = step(torch.tensor(u), _nchw(cur), _nchw(prev),
                                             torch.tensor(ctx_c), int(t), float(lr), float(th))
        assert n_iter == int(want_n) == NTI_INNER, i
        _close(got_u, want_u, f"embedding, step {i}")
        _close(got_next.permute(0, 2, 3, 1), want_next, f"latent, step {i}")
        np.testing.assert_allclose(loss, want_loss, rtol=1e-3, err_msg=f"loss, step {i}")


def test_null_text_inversion_matches_jax(nti_runs):
    """End to end: the per-step embeddings and the inverted latent; then the
    reconstruction through `ddim_generate(nti_uncond=...)` is finite."""
    pipe, traj, want_per_step, want_inverted, _ = nti_runs
    per_step, inverted, inner = nti.null_text_inversion(
        pipe, None, PROMPT, num_inner_steps=NTI_INNER, trajectory=traj, return_inner_steps=True)
    assert tuple(per_step.shape) == (NTI_STEPS, 1, 77, 32) and per_step.dtype == torch.float32
    assert inner == [NTI_INNER] * NTI_STEPS
    _close(per_step, want_per_step)
    _close(inverted, want_inverted)
    torch.testing.assert_close(inverted, traj[-1], atol=0, rtol=0)
    images, _ = pipe.ddim_generate([PROMPT], latent=inverted, nti_uncond=per_step)
    assert bool(torch.isfinite(images).all())


# ---------------------------------------------------------------------------
# SDXL
# ---------------------------------------------------------------------------
@pytest.mark.slow  # the JAX XL bundle's programs: keeps this file's time alone near a minute
def test_sdxl_ddim_generate_matches_jax():
    """The tiny XL bundle's `ddim_generate` on a 10-step grid: the CFG batch
    takes the doubled added conditioning (zero text embeds on the uncond
    half). JAX's bundle with numpy-seeded weights, its init only traced."""
    import flax.linen as nn

    init = nn.Module.init

    def abstract_init(self, rngs, *args):
        return jax.eval_shape(lambda r, a: init(self, r, *a), rngs, args)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", abstract_init)
        jpipe = jtiny_bundle_xl()
    grid = dict(n_steps=10)
    jpipe = dataclasses.replace(jpipe, params=seeded_params(jpipe.params),
                                grid=jsolver.make_solver_grid(**grid))
    pipe = dataclasses.replace(
        tiny_bundle_xl(convert.bundle_state_dicts_from_flax(_np_tree(jpipe.params))),
        grid=solver.make_solver_grid(**grid))
    want_images, want_latents = jpipe.ddim_generate([SOURCE], latent=jnp.asarray(_latent(1, 6)))
    images, latents = pipe.ddim_generate([SOURCE], latent=_latent(1, 6))
    _close(latents, want_latents)
    _close(images, want_images)


# ---------------------------------------------------------------------------
# Full SD1.5 width
# ---------------------------------------------------------------------------
FULL_WEIGHTS = os.path.join(os.path.dirname(__file__), "golden", "synth_sd15")
FULL_TOL = 5e-3  # max abs error over max |want|: the full-shape replay's UNet limit


def _full_close(got, want, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
    assert err <= FULL_TOL, f"{msg}: relative max error {err:.3e}"


def _two_steps_and_an_nti_step_match(jpipe, pipe, image):
    """On 2-step grids: `ddim_invert`, `ddim_generate` from JAX's inversion
    at CFG 7.5, and one NTI step of one inner iteration on JAX's inputs
    (the loss, the embedding, its update's signs and the next latent)."""
    want_traj, want_clean = jpipe.ddim_invert(image, PROMPT)
    traj, clean = pipe.ddim_invert(image, PROMPT)
    _full_close(clean, want_clean, "clean latent")
    _full_close(traj, want_traj, "DDIM inversion")
    want_images, want_latents = jpipe.ddim_generate([PROMPT], latent=want_traj[-1])
    images, latents = pipe.ddim_generate([PROMPT], latent=np.asarray(want_traj[-1]))
    _full_close(latents, want_latents, "DDIM generate latents")
    _full_close(images, want_images, "DDIM generate images")

    ctx_u, ctx_c = jpipe.encode_prompt([PROMPT])
    inputs = (ctx_u, want_traj[-1], want_traj[-2], ctx_c)
    t, lr, threshold = int(jpipe.grid.ddim_timesteps[-1]), 1e-2, 1e-5
    want_u, want_next, want_loss, _ = jnti._build_nti_step(jpipe, 1, 7.5)(
        jpipe.params["teacher"], *inputs, jnp.asarray(t), jnp.asarray(lr), jnp.asarray(threshold))
    u, cur, prev, ctx = (np.asarray(a) for a in inputs)
    got_u, got_next, loss, n_iter = nti.make_nti_step(pipe, 1, 7.5)(
        torch.tensor(u), _nchw(cur), _nchw(prev), torch.tensor(ctx), t, lr, threshold)
    assert n_iter == 1
    np.testing.assert_allclose(loss, float(want_loss), rtol=FULL_TOL)
    _full_close(got_u, want_u, "NTI's embedding")
    # Adam's first update is lr * sign(gradient): the gradients agree in sign
    agree = np.mean(np.sign(got_u.numpy() - u) == np.sign(np.asarray(want_u) - u))
    assert agree >= 0.99, f"update signs agree on {agree:.4f} of the entries"
    _full_close(got_next.permute(0, 2, 3, 1), want_next, "NTI's next latent")


@pytest.mark.slow  # full 860M shapes on the CPU, in both packages
def test_full_width_ddim_steps_and_an_nti_step_match_jax():
    """The teacher, CLIP and VAE of `tools/make_synthetic_pack.py
    ensure_weights` (written into the git-ignored `tests/golden/synth_sd15/`
    when absent), fp32 in both packages on a 2-step grid, through
    `_two_steps_and_an_nti_step_match` with a seeded 512^2 image."""
    import sys

    from invertible_cd_tpu.pipelines.loading import load_bundle_params as jload_bundle_params
    from invertible_cd_tpu_torch.pipelines.loading import load_bundle_params

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    from make_synthetic_pack import ensure_weights

    ensure_weights(FULL_WEIGHTS)
    files = {name: os.path.join(FULL_WEIGHTS, f"{file}.safetensors") for name, file in (
        ("teacher", "teacher"), ("vae", "vae"), ("text", "text_encoder"))}
    jpipe = JInvertibleCD.sd15(dtype=jnp.float32, grid=jsolver.make_solver_grid(n_steps=2))
    jpipe.params = jload_bundle_params(**files, params=jpipe.params)
    pipe = InvertibleCD.sd15(params=load_bundle_params(**files), device="cpu", dtype=torch.float32,
                             grid=solver.make_solver_grid(n_steps=2))
    image = np.random.default_rng(9).integers(0, 256, (512, 512, 3), np.uint8)
    _two_steps_and_an_nti_step_match(jpipe, pipe, image)
