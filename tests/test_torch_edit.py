"""The port's editing modules against the JAX package, without a UNet, fp32 on the CPU.

Covers `edit/aligner.py`, `edit/controllers.py` (arrays, `edit_attention`,
`local_blend`, `ControllerRuntime`, the hook routing), the sampler's
`cons_inversion` and hooked `cons_generation` on a toy noise model, the kohya
LoRA conversion and the loader, the safetensors reader, and
`to_model_pixels` / `load_512`. Inputs are drawn with numpy and handed to
both packages. Tolerances: mappers, masks, word indices and routing exactly;
probabilities atol 1e-6 / rtol 1e-5 (one einsum or elementwise mix apart);
latents atol 1e-4 / rtol 1e-3 as in `test_torch_pipeline.py` (four hops
through softmax attention); the controller runtime against the torch
oracle `_torch_p2p_ref.py` as `test_controller_oracle.py` holds the JAX one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_p2p_ref as ref
from invertible_cd_tpu.diffusion import schedule as jschedule
from invertible_cd_tpu.diffusion import solver as jsolver
from invertible_cd_tpu.edit import aligner as jaligner
from invertible_cd_tpu.edit import controllers as jctrl
from invertible_cd_tpu.models import attention as jattention
from invertible_cd_tpu.models import convert as jconvert
from invertible_cd_tpu.pipelines import loading as jloading
from invertible_cd_tpu.pipelines import pipeline as jpipeline
from invertible_cd_tpu.pipelines import sampler as jsampler
from invertible_cd_tpu.utils import tokenizer as jtokenizer
from invertible_cd_tpu_torch.diffusion import schedule, solver
from invertible_cd_tpu_torch.edit import aligner, controllers as ctrl
from invertible_cd_tpu_torch.models import attention, convert
from invertible_cd_tpu_torch.models.lora import find_lora_targets
from invertible_cd_tpu_torch.models.unet2d import UNet2DCondition, UNetConfig
from invertible_cd_tpu_torch.pipelines import loading, sampler
from invertible_cd_tpu_torch.pipelines.pipeline import load_512, to_model_pixels
from invertible_cd_tpu_torch.utils import tokenizer

ATOL, RTOL = 1e-4, 1e-3
P_ATOL, P_RTOL = 1e-6, 1e-5
PAIR = ["a photo of a corgi on the beach", "a photo of a cat on the beach"]
REFINE_PAIR = ["a photo of a corgi", "a photo of a small fluffy corgi"]
NUM_STEPS = 4


def _bpe_vocab():
    """A small byte-level BPE vocabulary: every byte symbol, its </w> form,
    and a few merges, so most words take several tokens."""
    symbols = list(tokenizer.bytes_to_unicode().values())
    merges = [("c", "a"), ("ca", "t</w>"), ("o", "n</w>"), ("t", "he</w>"), ("h", "e</w>")]
    vocab = {tok: i for i, tok in enumerate(
        symbols + [s + "</w>" for s in symbols]
        + ["ca", "cat</w>", "on</w>", "he</w>", "the</w>", "<|startoftext|>", "<|endoftext|>"])}
    return vocab, merges


def _tokenizers(kind):
    if kind == "hash":
        return tokenizer.HashTokenizer(1000), jtokenizer.HashTokenizer(1000)
    vocab, merges = _bpe_vocab()
    return tokenizer.ClipTokenizer(vocab, merges), jtokenizer.ClipTokenizer(vocab, merges)


# ---------------------------------------------------------------------------
# aligner
# ---------------------------------------------------------------------------
ALIGN_PAIRS = [
    PAIR,
    ["a cat", "a big fluffy cat sitting"],
    ["a red car in the city at night", "a blue truck in the town at night"],
    ["the cat on the mat", "the dog on the mat"],
]


@pytest.mark.parametrize("kind", ["hash", "bpe"])
@pytest.mark.parametrize("pair", ALIGN_PAIRS, ids=[p[1] for p in ALIGN_PAIRS])
def test_aligner_matches_jax(kind, pair):
    tok, jtok = _tokenizers(kind)
    src, tgt = pair
    np.testing.assert_array_equal(
        np.asarray(aligner.needleman_wunsch(tok.tokenize(src), tok.tokenize(tgt))),
        np.asarray(jaligner.needleman_wunsch(jtok.tokenize(src), jtok.tokenize(tgt))))
    for got, want in zip(aligner.get_refinement_mapper(pair, tok),
                         jaligner.get_refinement_mapper(pair, jtok)):
        np.testing.assert_array_equal(got, want)
    assert aligner.word_token_spans(tgt, tok) == jaligner.word_token_spans(tgt, jtok)
    for word in set(src.split(" ") + tgt.split(" ")) | {1, 3}:
        np.testing.assert_array_equal(aligner.get_word_inds(tgt, word, tok),
                                      jaligner.get_word_inds(tgt, word, jtok))
    if len(src.split(" ")) == len(tgt.split(" ")):
        np.testing.assert_array_equal(aligner.get_replacement_mapper(pair, tok),
                                      jaligner.get_replacement_mapper(pair, jtok))
    else:
        with pytest.raises(ValueError, match="equal word counts"):
            aligner.get_replacement_mapper(pair, tok)


# ---------------------------------------------------------------------------
# controllers: arrays, edit_attention, local_blend
# ---------------------------------------------------------------------------
CONTROLLERS = {
    "replace": dict(prompts=PAIR),
    "refine": dict(prompts=REFINE_PAIR, is_replace_controller=False),
    "reweight": dict(prompts=PAIR, equalizer_params={"words": ["cat"], "values": [3.0]}),
    "blend": dict(prompts=PAIR, blend_words=[["corgi"], ["cat"]], start_blend=0.25),
    "substruct": dict(prompts=PAIR, blend_words=[["corgi"], ["cat"]],
                      substruct_words=[["beach"], ["beach"]], blend_th=(0.2, 0.4)),
    "refine_reweight": dict(prompts=REFINE_PAIR, is_replace_controller=False,
                            equalizer_params={"words": ["fluffy"], "values": [0.2]}),
}


def _both_controllers(name, **extra):
    kw = dict(CONTROLLERS[name], cross_replace_steps=0.6, self_replace_steps=0.4, **extra)
    prompts = kw.pop("prompts")
    tok, jtok = _tokenizers("hash")
    spec, arrays = ctrl.make_controller(prompts, tok, NUM_STEPS, **kw)
    jspec, jarrays = jctrl.make_controller(prompts, jtok, NUM_STEPS, **kw)
    return spec, arrays, jspec, jarrays


@pytest.mark.parametrize("name", sorted(CONTROLLERS))
def test_make_controller_matches_jax(name):
    spec, arrays, jspec, jarrays = _both_controllers(name)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    for f in dataclasses.fields(arrays):
        got, want = getattr(arrays, f.name), np.asarray(getattr(jarrays, f.name))
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        assert tuple(got.shape) == want.shape, f.name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f.name)


def _probs(rng, shape):
    logits = rng.standard_normal(shape, dtype=np.float32)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


# (place, is_cross, query_len, key_len): a cross layer, a self layer the
# replace steps touch (<= 32^2 tokens) and one they pass through (> 32^2)
LAYERS = [("down", True, 256, 77), ("up", False, 256, 256), ("down", False, 4096, 16)]


@pytest.mark.parametrize("step", [0, 3])
@pytest.mark.parametrize("layer", LAYERS, ids=["cross", "self256", "self4096"])
@pytest.mark.parametrize("name", ["replace", "refine", "reweight", "refine_reweight"])
def test_edit_attention_matches_jax(name, layer, step):
    spec, arrays, jspec, jarrays = _both_controllers(name)
    place, is_cross, sq, sk = layer
    probs = _probs(np.random.default_rng(sq + step), (2, 2, sq, sk))
    meta = attention.AttnMeta(place, is_cross, 3, sq, sk, 2)
    jmeta = jattention.AttnMeta(place, is_cross, 3, sq, sk, 2)
    got = ctrl.edit_attention(spec, arrays, torch.from_numpy(probs), meta, step).numpy()
    want = np.asarray(jctrl.edit_attention(jspec, jarrays, jnp.asarray(probs), jmeta, step))
    np.testing.assert_allclose(got, want, atol=P_ATOL, rtol=P_RTOL)
    np.testing.assert_array_equal(got[0], probs[0])  # the source row is never edited


@pytest.mark.parametrize("hw", [16, 32])
@pytest.mark.parametrize("name,step", [("blend", 0), ("blend", 2), ("substruct", 1)])
def test_local_blend_matches_jax(name, step, hw):
    spec, arrays, jspec, jarrays = _both_controllers(name)
    rng = np.random.default_rng(hw + step)
    maps = [_probs(rng, (2, 2, 256, 77)) for _ in range(3)]
    x = rng.normal(size=(2, 4, hw, hw)).astype(np.float32)  # NCHW
    got = ctrl.local_blend(spec, arrays, torch.from_numpy(x),
                           [torch.from_numpy(m) for m in maps], step).numpy()
    blend = jax.jit(jctrl.local_blend, static_argnums=(0, 4))
    want = np.asarray(blend(jspec, jarrays, jnp.asarray(x.transpose(0, 2, 3, 1)),
                            [jnp.asarray(m) for m in maps], step))
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), atol=P_ATOL, rtol=P_RTOL)


# the SD1.5 UNet's attention layers in call order: (place, query tokens), each
# a self then a cross layer
SD15_LAYERS = [("down", 4096)] * 2 + [("down", 1024)] * 2 + [("down", 256)] * 2 + [("mid", 64)] \
    + [("up", 256)] * 3 + [("up", 1024)] * 3 + [("up", 4096)] * 3


@pytest.mark.parametrize("store_all", [False, True])
def test_routing_matches_jax_on_sd15_layers(store_all):
    """`applies` decides which layers keep kernel B1: under the edit CLI's
    controller (cross 0.6, self 0.4, blend, equalizer) the 4 hops keep
    4 * 5 + 3 * 11 = 53 layers on it, 4 * 5 = 20 with `store_all`."""
    spec, arrays, jspec, jarrays = _both_controllers("blend", equalizer_params={
        "words": ["cat"], "values": [2.0]})
    spec = dataclasses.replace(spec, store_all=store_all)
    jspec = dataclasses.replace(jspec, store_all=store_all)
    rt, jrt = ctrl.ControllerRuntime(spec, arrays), jctrl.ControllerRuntime(jspec, jarrays)
    fused = 0
    for step in range(NUM_STEPS):
        hook, jhook = sampler._wrap_cond_half(rt.hook_factory(step)), jrt.hook_factory(step)
        for i, (place, sq) in enumerate(SD15_LAYERS):
            for is_cross in (False, True):
                sk = 77 if is_cross else sq
                meta = attention.AttnMeta(place, is_cross, 2 * i + is_cross, sq, sk, 8)
                jmeta = jattention.AttnMeta(place, is_cross, 2 * i + is_cross, sq, sk, 8)
                routed = attention.routes_to_explicit(hook, meta)
                assert routed == jattention.routes_to_explicit(jhook, jmeta), (step, meta)
                fused += not routed
    assert fused == (20 if store_all else 53)


# ---------------------------------------------------------------------------
# ControllerRuntime against the torch oracle of the reference controllers
# ---------------------------------------------------------------------------
# the SD1.5 UNet's <= 32^2 layer inventory in call order, with its 32^2 layers
# at 12^2 tokens to keep the random draws small (the controllers treat every
# map of <= 32^2 tokens alike; LocalBlend reads down_cross[2:4] + up_cross[:3],
# the 16^2 maps)
ORACLE_SCHEDULE = [
    (place, sq, is_cross)
    for place, sqs in (("down", [144, 144, 256, 256]), ("mid", [64]),
                       ("up", [256, 256, 256, 144, 144, 144]))
    for sq in sqs for is_cross in (False, True)
]


@pytest.mark.parametrize("name", ["replace", "refine", "reweight", "refine_reweight", "blend",
                                  "substruct"])
def test_runtime_matches_the_reference_oracle(name):
    """Both sides in lockstep over a simulated SD1.5 layer schedule (<= 32^2
    tokens, 2 heads) for the 4-step loop, as `test_controller_oracle.py`
    drives the JAX runtime: equal edited attention at every layer and equal
    blended latents after every step."""
    kw = dict(CONTROLLERS[name])
    prompts = kw.pop("prompts")
    kw.pop("start_blend", None)
    kw.pop("blend_th", None)
    tok = tokenizer.HashTokenizer()
    spec, arrays = ctrl.make_controller(prompts, tok, NUM_STEPS, cross_replace_steps=0.8,
                                        self_replace_steps=0.4, start_blend=0.0, **kw)
    runtime = ctrl.ControllerRuntime(spec, arrays)
    oracle = ref.make_controller(
        prompts, kw.get("is_replace_controller", True), 0.8, 0.4, jtokenizer.HashTokenizer(),
        NUM_STEPS, blend_words=kw.get("blend_words"), equilizer_params=kw.get("equalizer_params"),
        substruct_words=kw.get("substruct_words"))
    oracle.num_att_layers = len(ORACLE_SCHEDULE)
    rng = np.random.default_rng(7)
    b, h = len(prompts), 2
    for step in range(NUM_STEPS):
        hook = runtime.hook_factory(step)
        for li, (place, sq, is_cross) in enumerate(ORACLE_SCHEDULE):
            sk = 77 if is_cross else sq
            probs = _probs(rng, (b, h, sq, sk))
            meta = attention.AttnMeta(place, is_cross, li, sq, sk, h)
            ours = hook(torch.from_numpy(probs), meta).numpy()
            uncond = torch.from_numpy(rng.standard_normal((b * h, sq, sk), dtype=np.float32))
            theirs = oracle(torch.cat([uncond, torch.from_numpy(probs.reshape(b * h, sq, sk).copy())]),
                            is_cross, place)[b * h:].reshape(b, h, sq, sk).numpy()
            np.testing.assert_allclose(ours, theirs, atol=P_ATOL, rtol=P_RTOL,
                                       err_msg=f"step {step} layer {li}")
        x = rng.normal(size=(b, 4, 8, 8)).astype(np.float32)
        np.testing.assert_allclose(runtime.step_callback(torch.from_numpy(x), step).numpy(),
                                   oracle.step_callback(torch.from_numpy(x.copy())).numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=f"step_callback at step {step}")


def test_aggregate_attention_and_store_only_specs():
    rng = np.random.default_rng(3)
    store = {"down_cross": [_probs(rng, (2, 2, 256, 77)) for _ in range(3)],
             "up_cross": [_probs(rng, (2, 2, 64, 77))]}
    got = ctrl.aggregate_attention({k: [torch.from_numpy(m) for m in v] for k, v in store.items()},
                                   16, ("down", "up"), True, select=1)
    want = jctrl.aggregate_attention({k: [jnp.asarray(m) for m in v] for k, v in store.items()},
                                     16, ("down", "up"), True, select=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=P_ATOL, rtol=P_RTOL)
    assert dataclasses.asdict(ctrl.store_controller(4, 2)) == dataclasses.asdict(
        jctrl.store_controller(4, 2))
    spec, arrays = ctrl.spatial_replace_controller(4, 2, 0.5)
    jspec, jarrays = jctrl.spatial_replace_controller(4, 2, 0.5)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    np.testing.assert_array_equal(arrays.cross_replace_alpha.numpy(),
                                  np.asarray(jarrays.cross_replace_alpha))
    x = rng.normal(size=(2, 4, 8, 8)).astype(np.float32)
    out = ctrl.ControllerRuntime(spec, arrays).step_callback(torch.from_numpy(x), 1)
    np.testing.assert_array_equal(out.numpy(), np.broadcast_to(x[:1], x.shape))



def test_add_step_store_refuses_a_mismatched_step():
    """The step-summed store of the DDIM loop adds a step's maps to the sums
    only where both hold the same store keys and map counts; a step that
    stored fewer maps, or under other keys, raises instead of being cut by
    `zip`."""
    runtime = ctrl.ControllerRuntime(*ctrl.spatial_replace_controller(4, 2, 0.5))
    m = torch.ones((2, 2, 64, 77))
    runtime.store = {"down_cross": [m, m]}
    sums = runtime.add_step_store({"down_cross": [m, 2 * m]})
    assert [float(t[0, 0, 0, 0]) for t in sums["down_cross"]] == [2.0, 3.0]
    for step in ({"down_cross": [m]}, {"up_cross": [m, m]}, {"down_cross": [m, m], "up_cross": [m]}):
        runtime.store = step
        with pytest.raises(ValueError, match="add_step_store"):
            runtime.add_step_store({"down_cross": [m, m]})

# ---------------------------------------------------------------------------
# sampler: cons_inversion and the hooked cons_generation on a toy noise model
# ---------------------------------------------------------------------------
CTX_DIM = 16
TOY_LAYERS = [("down", False), ("down", True), ("up", True)]


def _toy_weights():
    rng = np.random.default_rng(11)
    return {
        "q": rng.normal(size=(2, 4, CTX_DIM)).astype(np.float32),
        "k": rng.normal(size=(2, 4, CTX_DIM)).astype(np.float32),
        "kc": rng.normal(size=(2, CTX_DIM, CTX_DIM)).astype(np.float32) / 4,
        "v": rng.normal(size=(CTX_DIM, 4)).astype(np.float32) / 4,
        # small: the frameworks' fp32 sin/cos of w * 1000 rad differ by a few
        # ulp (test_torch_pipeline.py), and the hops amplify the bias they feed
        "w": rng.normal(size=(8, 4)).astype(np.float32) / 10,
    }


def _toy_noise_model(xp, meta_cls, routes, nhwc):
    """eps = x t/1000 + mean over three 2-head attention layers (a self layer
    and two cross layers over the context, queries and self keys from the
    RMS-normalised latent) + a w-embedding bias, each layer
    through the hook where the hook applies: the same function in both
    frameworks (`xp` is torch or jax.numpy)."""
    w = {k: xp.asarray(v) if xp is jnp else torch.from_numpy(v) for k, v in _toy_weights().items()}

    def softmax(z):
        z = z - z.max(-1, keepdims=True) if xp is jnp else z - z.amax(-1, keepdim=True)
        e = xp.exp(z)
        return e / e.sum(-1, keepdims=True) if xp is jnp else e / e.sum(-1, keepdim=True)

    def nm(latent, t, context, w_emb, hook):
        if nhwc:
            b, hh, ww, c = latent.shape
            x = latent.reshape(b, hh * ww, c)
        else:
            b, c, hh, ww = latent.shape
            x = latent.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        xn = x / xp.sqrt((x * x).mean(-1, keepdims=True) + 1e-6)  # logits O(1) at any scale
        q = xp.einsum("bsc,hcd->bhsd", xn, w["q"])
        out = 0.0
        for i, (place, is_cross) in enumerate(TOY_LAYERS):
            if is_cross:
                k = xp.einsum("bsd,hde->bhse", context, w["kc"])
                v = context @ w["v"]
            else:
                k, v = xp.einsum("bsc,hcd->bhsd", xn, w["k"]), xn
            probs = softmax(xp.einsum("bhqd,bhkd->bhqk", q, k) / CTX_DIM ** 0.5)
            meta = meta_cls(place, is_cross, i, hh * ww, k.shape[2], 2)
            if routes(hook, meta):
                probs = hook(probs, meta)
            out = out + xp.einsum("bhqk,bkc->bqc", probs, v) / 2
        eps = x * (t / 1000.0) + out / len(TOY_LAYERS)
        if w_emb is not None:
            eps = eps + (w_emb @ w["w"])[:, None, :]
        eps = eps.reshape(b, hh, ww, c)
        return eps if nhwc else eps.permute(0, 3, 1, 2)

    return nm


def _grids():
    kw = dict(reverse_timesteps=[259, 519, 779, 999], forward_timesteps=[19, 259, 519, 779])
    return (solver.make_solver_grid(**kw), schedule.make_schedule(),
            jsolver.make_solver_grid(**kw), jschedule.make_schedule())


GUIDANCE = {
    "w": dict(guidance_scale=19.0, w_embed_dim=8, dynamic_guidance=True, tau1=0.8, tau2=0.8,
              edit_pair=True),
    "cfg": dict(guidance_scale=7.5, w_embed_dim=0),
}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    lat = rng.normal(size=(2, 16, 16, 4)).astype(np.float32)
    ctx = rng.normal(size=(2, 2, 77, CTX_DIM)).astype(np.float32)
    return lat, ctx[0], ctx[1]


@pytest.mark.parametrize("path", sorted(GUIDANCE))
def test_cons_inversion_matches_jax(path):
    grid, sched, jgrid, jsched = _grids()
    lat, ctx_u, ctx_c = _inputs(1)
    noise = np.random.default_rng(2).normal(size=lat.shape).astype(np.float32)
    g = dict(GUIDANCE[path], guidance_scale=0.0 if path == "w" else 1.0, edit_pair=False)
    got = sampler.cons_inversion(
        _toy_noise_model(torch, attention.AttnMeta, attention.routes_to_explicit, False),
        torch.from_numpy(lat).permute(0, 3, 1, 2), torch.from_numpy(noise).permute(0, 3, 1, 2),
        torch.from_numpy(ctx_u), torch.from_numpy(ctx_c), grid, sched,
        sampler.GuidanceConfig(**g), return_all=True)
    want = jax.jit(lambda *a: jsampler.cons_inversion(
        _toy_noise_model(jnp, jattention.AttnMeta, jattention.routes_to_explicit, True),
        *a, jgrid, jsched, jsampler.GuidanceConfig(**g), return_all=True))(
        jnp.asarray(lat), jnp.asarray(noise), jnp.asarray(ctx_u), jnp.asarray(ctx_c))
    assert tuple(got.shape) == (5, 2, 16, 16, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    final = sampler.cons_inversion(
        _toy_noise_model(torch, attention.AttnMeta, attention.routes_to_explicit, False),
        torch.from_numpy(lat).permute(0, 3, 1, 2), torch.from_numpy(noise).permute(0, 3, 1, 2),
        torch.from_numpy(ctx_u), torch.from_numpy(ctx_c), grid, sched,
        sampler.GuidanceConfig(**g))
    torch.testing.assert_close(final.permute(0, 2, 3, 1), got[-1], atol=0, rtol=0)


@pytest.mark.parametrize("path", sorted(GUIDANCE))
def test_hooked_cons_generation_matches_jax(path):
    """replace + equalizer + LocalBlend + store_all, with the CLI's cross
    0.6 / self 0.4 steps: trajectory, final latents and every stored map."""
    grid, sched, jgrid, jsched = _grids()
    spec, arrays, jspec, jarrays = _both_controllers("blend", equalizer_params={
        "words": ["cat"], "values": [2.0]})
    spec = dataclasses.replace(spec, store_all=True)
    jspec = dataclasses.replace(jspec, store_all=True)
    rt = ctrl.ControllerRuntime(spec, arrays)
    lat, ctx_u, ctx_c = _inputs(3)
    got = sampler.cons_generation(
        _toy_noise_model(torch, attention.AttnMeta, attention.routes_to_explicit, False),
        torch.from_numpy(lat).permute(0, 3, 1, 2), torch.from_numpy(ctx_u),
        torch.from_numpy(ctx_c), grid, sched, sampler.GuidanceConfig(**GUIDANCE[path]),
        hook_factory=rt.hook_factory, step_callback=rt.step_callback, return_all=True)

    @jax.jit
    def jax_run(jarrays, *inputs):  # the JAX package runs its controllers under jit
        jrt = jctrl.ControllerRuntime(jspec, jarrays)
        traj = jsampler.cons_generation(
            _toy_noise_model(jnp, jattention.AttnMeta, jattention.routes_to_explicit, True),
            *inputs, jgrid, jsched, jsampler.GuidanceConfig(**GUIDANCE[path]),
            hook_factory=jrt.hook_factory, step_callback=jrt.step_callback, return_all=True)
        return traj, jrt.store

    want, jstore = jax_run(jarrays, jnp.asarray(lat), jnp.asarray(ctx_u), jnp.asarray(ctx_c))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    assert not np.allclose(got[-1, 1].numpy(), got[-1, 0].numpy())  # the target row was edited
    assert sorted(rt.store) == sorted(jstore) == ["down_cross", "down_self", "up_cross"]
    for key, maps in jstore.items():
        assert len(rt.store[key]) == len(maps) == NUM_STEPS
        for m, jm in zip(rt.store[key], maps):
            np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=ATOL, rtol=RTOL, err_msg=key)


def test_cond_half_wrapper_keeps_the_routing_predicate():
    hook = ctrl.ControllerRuntime(*_both_controllers("replace")[:2]).hook_factory(0)
    wrapped = sampler._wrap_cond_half(hook)
    assert wrapped.applies is hook.applies and sampler._wrap_cond_half(None) is None
    probs = torch.from_numpy(_probs(np.random.default_rng(5), (4, 2, 256, 77)))
    meta = attention.AttnMeta("down", True, 1, 256, 77, 2)
    out = wrapped(probs, meta)
    torch.testing.assert_close(out[:2], probs[:2], atol=0, rtol=0)  # the uncond half is kept
    torch.testing.assert_close(out[2:], hook(probs[2:], meta), atol=0, rtol=0)


# ---------------------------------------------------------------------------
# weights: kohya LoRA, the loader, the safetensors reader
# ---------------------------------------------------------------------------
def test_kohya_keys_map_as_the_jax_package_maps_them():
    """Every LoRA target of the SD1.5 UNet: kohya's flat name -> the port's
    key equals JAX's `_kohya_module_to_flax` path passed through the weights
    bridge's renames (`unet_state_dict_from_flax`)."""
    with torch.device("meta"):
        targets = find_lora_targets(UNet2DCondition(UNetConfig.sd15()).state_dict())
    assert len(targets) == 278
    for key in targets:
        flat = key[: -len(".weight")].replace(".", "_")
        tree = {}
        node = tree
        for part in jconvert._kohya_module_to_flax(flat).split("/"):
            node = node.setdefault(part, {})
        node["kernel"] = np.zeros((1, 1), np.float32)
        assert list(convert.unet_state_dict_from_flax(tree)) == [key]
        assert convert._kohya_module_to_key(flat) == key


def _tiny_unet_files(tmp_path):
    """A tiny UNet's state dict and two kohya LoRAs (alpha 4, rank 3, both
    linear and conv targets) written as safetensors."""
    from safetensors.torch import save_file

    torch.manual_seed(0)
    unet = UNet2DCondition(UNetConfig.tiny())
    sd = {k: v.detach().clone() for k, v in unet.state_dict().items()}
    save_file(sd, str(tmp_path / "teacher.safetensors"))
    rng = np.random.default_rng(0)
    paths = {}
    for name in ("reverse", "forward"):
        lora = {}
        for key in find_lora_targets(sd):
            w = sd[key]
            lora[key] = {"down": torch.from_numpy(rng.normal(size=(3,) + tuple(w.shape[1:])).astype(np.float32)),
                         "up": torch.from_numpy(rng.normal(size=(w.shape[0], 3)).astype(np.float32))}
        kohya = convert.export_lora_to_kohya(lora, alpha=4.0)
        paths[name] = str(tmp_path / f"{name}.safetensors")
        save_file(kohya, paths[name])
        paths[name + "_lora"] = lora
    return sd, paths


def test_kohya_round_trip_is_the_identity(tmp_path):
    _, paths = _tiny_unet_files(tmp_path)
    lora = paths["reverse_lora"]
    kohya = convert.load_torch_file(paths["reverse"])
    assert any(v.dim() == 4 for k, v in kohya.items() if k.endswith("lora_up.weight"))
    adapters, alphas = convert.convert_lora_from_kohya(kohya)
    assert sorted(adapters) == sorted(lora) and set(alphas.values()) == {4.0}
    for key, ab in lora.items():
        torch.testing.assert_close(adapters[key]["down"], ab["down"], atol=0, rtol=0)
        torch.testing.assert_close(adapters[key]["up"], ab["up"], atol=0, rtol=0)
    # and the JAX converter reads the same file into the same adapters
    jadapters, jalphas = jconvert.convert_lora_from_kohya(kohya)
    flax = {path: {"down": v["down"], "up": v["up"]} for path, v in jadapters.items()}
    for key, ab in convert.lora_from_flax(flax).items():
        torch.testing.assert_close(ab["down"], adapters[key]["down"], atol=0, rtol=0)
        torch.testing.assert_close(ab["up"], adapters[key]["up"], atol=0, rtol=0)


def test_load_bundle_params_matches_jax(tmp_path):
    sd, paths = _tiny_unet_files(tmp_path)
    teacher = str(tmp_path / "teacher.safetensors")
    got = loading.load_bundle_params(teacher=teacher, reverse_lora=paths["reverse"])
    want = jloading.load_bundle_params(teacher=teacher, reverse_lora=paths["reverse"])
    assert got["forward"] is got["teacher"]  # a student without a LoRA shares the teacher
    for name in ("teacher", "reverse"):
        bridged = convert.unet_state_dict_from_flax(jax.tree.map(np.asarray, want[name]))
        assert sorted(bridged) == sorted(got[name]), name
        for key, value in bridged.items():
            np.testing.assert_allclose(got[name][key].numpy(), value.numpy(), atol=1e-6, rtol=1e-5,
                                       err_msg=f"{name} {key}")
    target = "down_blocks.0.resnets.0.conv1.weight"
    assert torch.equal(got["reverse"]["conv_in.weight"], sd["conv_in.weight"])  # not a target
    assert not torch.equal(got["reverse"][target], sd[target])
    with pytest.raises(ValueError, match="without a teacher"):
        loading.load_bundle_params(forward_lora=paths["forward"])
    half = loading.load_bundle_params(teacher=teacher, dtype=torch.bfloat16)
    assert all(v.dtype == torch.bfloat16 for v in half["teacher"].values())


def test_safetensors_reader_matches_the_package(tmp_path):
    from safetensors.torch import load_file, save_file

    rng = np.random.default_rng(0)
    tensors = {
        "f32": torch.from_numpy(rng.normal(size=(3, 4)).astype(np.float32)),
        "f16": torch.from_numpy(rng.normal(size=(2, 3, 4)).astype(np.float16)),
        "bf16": torch.from_numpy(rng.normal(size=(5,)).astype(np.float32)).to(torch.bfloat16),
        "f64": torch.from_numpy(rng.normal(size=(2, 2))),
        "i64": torch.arange(6, dtype=torch.int64).reshape(2, 3),
        "i32": torch.tensor([-1, 7], dtype=torch.int32),
        "u8": torch.arange(10, dtype=torch.uint8),
        "bool": torch.tensor([True, False, True]),
        "scalar": torch.tensor(8.0),
        "empty": torch.zeros((0, 3)),
    }
    path = str(tmp_path / "t.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got, want = convert.load_torch_file(path), load_file(path)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k
    torch.save({"state_dict": tensors}, str(tmp_path / "t.pt"))
    assert all(torch.equal(a, tensors[k]) for k, a in convert.load_torch_file(str(tmp_path / "t.pt")).items())


# ---------------------------------------------------------------------------
# pixels
# ---------------------------------------------------------------------------
def test_to_model_pixels_and_load_512_match_jax():
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (40, 56, 3), np.uint8)
    for image in (img, np.stack([img, img[::-1]]).astype(np.float32)):
        got = to_model_pixels(image)
        assert got.dtype == torch.float32 and got.dim() == 4
        np.testing.assert_allclose(got.numpy(), np.asarray(jpipeline.to_model_pixels(image)),
                                   atol=1e-7, rtol=0)
    for offsets in ({}, dict(left=5, right=3, top=30, bottom=2), dict(left=50, top=2)):
        got = load_512(img, size=64, **offsets)
        want = jpipeline.load_512(img, size=64, **offsets)
        assert got.shape == (64, 64, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
