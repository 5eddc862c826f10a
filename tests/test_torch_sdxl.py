"""The port's SDXL slice against the JAX package, fp32 on the CPU.

The port's tiny XL bundle (`testing.tiny_bundle_xl`) is built from the JAX
tiny XL bundle's params (`invertible_cd_tpu.testing.tiny_bundle_xl`, with
numpy-seeded weights: the UNets, both text encoders, the VAE) through the
weights bridge (`models.convert.bundle_state_dicts_from_flax`). Start
latents, inversion noise and module inputs are drawn with numpy (or by JAX
where the JAX pipeline draws them) and handed to both. Each JAX pipeline
program runs once, in a module-scoped fixture. The full-width configs are
compared by shape only (`jax.eval_shape`, no compute).

Tolerance: atol 1e-4 / rtol 1e-3 on every output, as in
`test_torch_pipeline.py` (fp32 in both frameworks; convolution, matmul and
sampling summation orders differ), with the absolute part scaled by
max(1, max |want| / 10): fp32 rounding grows with the values, and the
latents of the generate and the edits reach |x| = 43-50 at w = 19, where
the two packages differ by up to 2.5e-4 (relative L2 at most 6e-6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invertible_cd_tpu.diffusion.solver import make_solver_grid as jmake_solver_grid
from invertible_cd_tpu.edit import make_controller as jmake_controller
from invertible_cd_tpu.models import convert as jconvert
from invertible_cd_tpu.models import lora as jlora
from invertible_cd_tpu.models.attention import Transformer2D as JTransformer2D
from invertible_cd_tpu.models.clip import CLIPTextConfig as JCLIPTextConfig
from invertible_cd_tpu.models.clip import CLIPTextModel as JCLIPTextModel
from invertible_cd_tpu.models.unet2d import UNet2DCondition as JUNet
from invertible_cd_tpu.models.unet2d import UNetConfig as JUNetConfig
from invertible_cd_tpu.models.unet2d import count_attention_layers as jcount
from invertible_cd_tpu.testing import tiny_bundle_xl as jtiny_bundle_xl
from invertible_cd_tpu_torch.diffusion.solver import make_solver_grid
from invertible_cd_tpu_torch.edit import make_controller
from invertible_cd_tpu_torch.models import convert
from invertible_cd_tpu_torch.models.attention import Transformer2D
from invertible_cd_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from invertible_cd_tpu_torch.models.lora import find_lora_targets
from invertible_cd_tpu_torch.models.unet2d import UNet2DCondition, UNetConfig, count_attention_layers
from invertible_cd_tpu_torch.models.vae import VAEConfig
from invertible_cd_tpu_torch.pipelines.loading import load_bundle_params
from invertible_cd_tpu_torch.pipelines.sdxl import InvertibleCDXL
from invertible_cd_tpu_torch.testing import tiny_bundle_xl

from _torch_jax_params import seeded_params

ATOL, RTOL = 1e-4, 1e-3
SOURCE, TARGET = "a photo of a cat on the grass", "a photo of a dog on the grass"
CONTROLLER = dict(num_steps=2, cross_replace_steps=0.6, self_replace_steps=0.4,
                  blend_words=[["cat"], ["dog"]], equalizer_params={"words": ["dog"], "values": [2.0]})
RNG = np.random.default_rng(0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's tiny models (see
    `test_torch_baselines.py`): under the suite's parallel workers more
    threads oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randn(*shape):
    return RNG.normal(size=shape).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _image(seed=0):
    return np.random.default_rng(seed).integers(0, 255, (32, 32, 3), np.uint8)


def _close(got, want, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    atol = ATOL * max(1.0, float(np.abs(want).max()) / 10)
    np.testing.assert_allclose(got, want, atol=atol, rtol=RTOL, err_msg=msg)


def _state_shapes_from_flax(tree):
    """The state-dict key and shape of every leaf of a Flax param tree of
    abstract arrays, by the bridge's renames (`models.convert`), without
    materialising a tensor."""
    shapes = {}
    for keypath, leaf in jax.tree_util.tree_flatten_with_path(tree["params"])[0]:
        path = [k.key for k in keypath]
        names = [convert._module_name(p) for p in path[:-1] if p != "GroupNorm_0"]
        shape = tuple(leaf.shape)
        if path[-1] == "kernel":  # conv HWIO -> OIHW, dense (in, out) -> (out, in)
            shape = (shape[3], shape[2], shape[0], shape[1]) if len(shape) == 4 else shape[::-1]
        leaf_name = "weight" if path[-1] in ("kernel", "scale", "embedding") else path[-1]
        shapes[".".join(names + [leaf_name])] = shape
    return shapes


def _meta_shapes(module_fn):
    with torch.device("meta"):
        module = module_fn()
    return module, {k: tuple(v.shape) for k, v in module.state_dict().items()}


# ---------------------------------------------------------------------------
# full-width configs, by shape
# ---------------------------------------------------------------------------
def test_sdxl_unet_config_matches_jax_by_shape():
    """`UNetConfig.sdxl()`: 140 attention layers as JAX counts them, every
    parameter's key and shape equal to the JAX module's through the bridge,
    and the LoRA merge reaching the same 2.6B-model targets (the linear
    proj_in/proj_out of every transformer and all depth-10 blocks
    included)."""
    cfg = UNetConfig.sdxl()
    assert count_attention_layers(cfg) == jcount(JUNetConfig.sdxl()) == 140
    jcfg = JUNetConfig.sdxl()
    sample = jnp.zeros((1, 16, 16, 4))
    added = {"text_embeds": jnp.zeros((1, 1280)), "time_ids": jnp.zeros((1, 6))}
    abstract = jax.eval_shape(lambda: JUNet(jcfg).init(
        jax.random.PRNGKey(0), sample, jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 2048)),
        jnp.zeros((1, 512)), added))
    want = _state_shapes_from_flax(abstract)
    unet, got = _meta_shapes(lambda: UNet2DCondition(cfg))
    assert got == want
    assert sum(int(np.prod(s)) for s in got.values()) > 2.5e9
    assert got["add_embedding.linear_1.weight"] == (1280, 2816)
    assert got["mid_block.attentions.0.transformer_blocks.9.attn2.to_k.weight"] == (1280, 2048)

    jtargets = {".".join([convert._module_name(p) for p in path[1:-1]] + ["weight"])
                for path in jlora.find_lora_targets(abstract)}
    targets = set(find_lora_targets(unet.state_dict()))
    assert targets == jtargets
    assert "down_blocks.1.attentions.0.proj_in.weight" in targets
    assert got["down_blocks.1.attentions.0.proj_in.weight"] == (640, 640)  # linear, not 1x1 conv
    assert "up_blocks.0.attentions.2.transformer_blocks.9.ff.net.2.weight" in targets


def test_big_g_and_vae_configs_match_jax_by_shape():
    """bigG: the config, and through the bridge the key and shape of every
    parameter outside the 32 identical layers and of the first and the last
    layer (the bridge copies what it converts, so the 30 between stay
    abstract); the port builds exactly layers 0-31."""
    jcfg = JCLIPTextConfig.open_clip_big_g()
    cfg = CLIPTextConfig.open_clip_big_g()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    abstract = jax.eval_shape(lambda: JCLIPTextModel(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 77), jnp.int32)))["params"]
    kept = {k: v for k, v in abstract.items() if k not in {f"layers_{i}" for i in range(1, 31)}}
    want = {k: tuple(v.shape) for k, v in convert.clip_state_dict_from_flax(
        jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape), kept)).items()}
    _, got = _meta_shapes(lambda: CLIPTextModel(cfg))
    assert {k: v for k, v in got.items() if k in want} == want
    assert {k.split(".")[3] for k in got if k.startswith("text_model.encoder.layers.")} == {
        str(i) for i in range(32)}
    assert len(got) == len(want) + 30 * 16  # 16 tensors a layer
    assert want["text_projection.weight"] == (1280, 1280)
    assert VAEConfig.sdxl().scaling_factor == 0.13025


def test_kohya_keys_on_sdxl_module_names_map_as_the_jax_package_maps_them():
    """Every LoRA target of the SDXL UNet (linear proj_in/proj_out,
    transformer blocks 0-9): kohya's flat name -> the port's key equals
    JAX's `_kohya_module_to_flax` path through the bridge's renames."""
    with torch.device("meta"):
        targets = find_lora_targets(UNet2DCondition(UNetConfig.sdxl()).state_dict())
    assert len(targets) == 788  # every adapter of the 2.6B UNet, as many as JAX finds
    for key in targets:
        flat = key[: -len(".weight")].replace(".", "_")
        node = tree = {}
        for part in jconvert._kohya_module_to_flax(flat).split("/"):
            node = node.setdefault(part, {})
        node["kernel"] = np.zeros((1, 1), np.float32)
        assert list(convert.unet_state_dict_from_flax(tree)) == [key]
        assert convert._kohya_module_to_key(flat) == key


def test_load_bundle_params_reads_the_second_text_encoder(tmp_path):
    """`text_2`: a bigG-form encoder's transformers state dict (with
    `text_projection` and the `position_ids` buffer transformers saves) is
    read as it is, less the buffer, and loads strictly."""
    from safetensors.torch import save_file

    cfg = CLIPTextConfig(vocab_size=1000, hidden_size=32, num_layers=2, num_heads=2,
                         intermediate_size=64, hidden_act="gelu", projection_dim=16)
    state = CLIPTextModel(cfg).state_dict()
    save_file({**state, "text_model.embeddings.position_ids": torch.arange(77)[None]},
              str(tmp_path / "text_encoder_2.safetensors"))
    params = load_bundle_params(text_2=str(tmp_path / "text_encoder_2.safetensors"))
    assert list(params) == ["text_2"] and params["text_2"].keys() == state.keys()
    for k, v in state.items():
        torch.testing.assert_close(params["text_2"][k], v, atol=0, rtol=0)
    CLIPTextModel(cfg).load_state_dict(params["text_2"], strict=True)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------
def test_linear_projection_transformer2d_at_depth_2():
    dim, ctx_dim, heads = 64, 48, 4
    x, ctx = _randn(2, 8, 8, dim), _randn(2, 77, ctx_dim)
    jblock = JTransformer2D(heads, depth=2, use_linear_projection=True)
    params = jax.jit(lambda x, c: jblock.init(jax.random.PRNGKey(2), x, c, "down", [0], None))(
        jnp.asarray(x), jnp.asarray(ctx))
    want = jax.jit(lambda p, x, c: jblock.apply(p, x, c, "down", [0], None))(
        params, jnp.asarray(x), jnp.asarray(ctx))
    block = Transformer2D(dim, heads, ctx_dim, depth=2, use_linear_projection=True)
    block.load_state_dict(convert.unet_state_dict_from_flax(_np_tree(params)))
    assert isinstance(block.proj_in, torch.nn.Linear)
    counter = [0]
    with torch.no_grad():
        got = _nhwc(block(_nchw(x), torch.from_numpy(ctx), "down", counter))
    _close(got, want)
    assert counter == [4]  # a self- and a cross-attention layer per block


def test_gelu_clip_with_projected_pooled():
    """bigG's form at a tiny width: exact gelu and the projected pooled
    embedding, against the JAX encoder on the same weights and tokens."""
    jcfg = JCLIPTextConfig(vocab_size=1000, hidden_size=32, num_layers=2, num_heads=2,
                           intermediate_size=64, hidden_act="gelu", projection_dim=16)
    jmodel = JCLIPTextModel(jcfg)
    tokens = np.random.default_rng(3).integers(0, 1000, (3, 77)).astype(np.int32)
    tokens[:, 9] = 49407 % 1000  # an end token inside the vocabulary: the tiny eos id is out of it
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(4), jnp.zeros((1, 77), jnp.int32))
    want = jax.jit(jmodel.apply)(params, jnp.asarray(tokens))
    model = CLIPTextModel(CLIPTextConfig(**dataclasses.asdict(jcfg)))
    model.load_state_dict(convert.clip_state_dict_from_flax(_np_tree(params)))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long())
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key], want[key], key)


# ---------------------------------------------------------------------------
# the tiny XL bundle
# ---------------------------------------------------------------------------
GRID = dict(reverse_timesteps=[499, 999], forward_timesteps=[19, 499])


@pytest.fixture(scope="module")
def jpipe():
    """The JAX package's tiny XL bundle, `invertible_cd_tpu.testing.
    tiny_bundle_xl()`, with numpy-seeded weights (`seeded_params`; its
    modules' `init` only traced, which Flax otherwise runs op by op) and
    teacher, reverse and forward students of their own, on a 2-hop grid
    (reverse 999 -> 499 -> 0, forward 19 -> 499 -> 999): each compiled
    program unrolls half the hops of the 4-hop grid (whose loop the SD1.5
    tests and the SDXL replay cover), and the edit protocol's two branches,
    the source context and w = 0 at t = 999 and the target's at w = 19 at
    t = 499, both still run."""
    import flax.linen as nn

    init = nn.Module.init

    def abstract_init(self, rngs, *args):
        return jax.eval_shape(lambda r, a: init(self, r, *a), rngs, args)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", abstract_init)
        pipe = jtiny_bundle_xl()
    return dataclasses.replace(pipe, params=seeded_params(pipe.params),
                               grid=jmake_solver_grid(**GRID))


@pytest.fixture(scope="module")
def port_pipe(jpipe):
    pipe = tiny_bundle_xl(convert.bundle_state_dicts_from_flax(_np_tree(jpipe.params)))
    return dataclasses.replace(pipe, grid=make_solver_grid(**GRID))


def _edit_guidance(pipe):
    """The SDXL edit protocol's guidance: dynamic w = 19, tau1 = tau2 = 0.7."""
    return pipe.default_guidance(guidance_scale=19.0, dynamic_guidance=True, tau1=0.7, tau2=0.7)


@pytest.fixture(scope="module")
def jax_runs(jpipe):
    """Each JAX program once: generate (under the edit protocol's guidance
    and amplify prompt, the program the amplify edit runs too), invert, the
    amplify edit and the controlled edit (their inversion is the invert
    program)."""
    p = jpipe
    out = {"latent": np.asarray(p.init_latent(jax.random.PRNGKey(150), 2)),
           "noise": np.asarray(jax.random.normal(jax.random.PRNGKey(1), (1, 16, 16, 4)))}
    images, latents = p.generate([SOURCE, TARGET], latent=jnp.asarray(out["latent"]),
                                 guidance=_edit_guidance(p), amplify_prompt=[SOURCE])
    out["generate"] = (np.asarray(images), np.asarray(latents))
    inv, clean = p.invert(_image(), SOURCE, key=jax.random.PRNGKey(1))
    out["invert"] = (np.asarray(inv), np.asarray(clean))
    images, latents = p.edit(_image(), SOURCE, TARGET, key=jax.random.PRNGKey(1))
    out["edit"] = (np.asarray(images), np.asarray(latents))
    spec, arrays = jmake_controller([SOURCE, TARGET], p.tokenizer, **CONTROLLER)
    images, latents = p.edit(_image(5), SOURCE, TARGET, (spec, arrays), key=jax.random.PRNGKey(1))
    out["edit_controlled"] = (np.asarray(images), np.asarray(latents))
    return out


def test_encode_prompt_xl_time_ids_and_zero_uncond(jpipe, port_pipe):
    prompts = [SOURCE, "", "an astronaut riding a horse"]
    np.testing.assert_array_equal(port_pipe.tokenizer_2(prompts), jpipe.tokenizer_2(prompts))
    want_ctx, want_pooled = jpipe.encode_prompt_xl(prompts)
    ctx, pooled = port_pipe.encode_prompt_xl(prompts)
    assert tuple(ctx.shape) == (3, 77, 64) and tuple(pooled.shape) == (3, 16)
    _close(ctx, want_ctx, "context")
    _close(pooled, want_pooled, "pooled")
    np.testing.assert_array_equal(port_pipe.add_time_ids(2).numpy(),
                                  np.asarray(jpipe.add_time_ids(2)))
    np.testing.assert_array_equal(
        port_pipe.add_time_ids(1, original_size=(48, 40), crop=(2, 3)).numpy(),
        np.asarray(jpipe.add_time_ids(1, original_size=(48, 40), crop=(2, 3))))
    ctx_u, ctx_c, added = port_pipe._encode_all(prompts[:2])
    assert not ctx_u.any() and ctx_u.shape == ctx_c.shape
    _, _, jadded = jpipe._encode_all(prompts[:2])
    for key in ("text_embeds", "time_ids"):
        _close(added[key], jadded[key], key)


def test_unet_epsilon_with_added_cond(jpipe, port_pipe):
    """The UNet through each package's noise model, which broadcasts the
    added conditioning to the call's batch: on a doubled CFG batch [uncond;
    cond] the uncond half gets zero text embeds and both halves the time ids;
    the cond half is the UNet on the added conditioning as given."""
    x, ctx, w = _randn(2, 16, 16, 4), _randn(2, 77, 64), _randn(2, 8)
    added = {"text_embeds": _randn(2, 16), "time_ids": np.tile(
        np.array([[32, 32, 0, 0, 32, 32]], np.float32), (2, 1))}
    x, ctx, w = (np.concatenate([a, a]) for a in (x, ctx, w))

    @jax.jit
    def jax_eps(x, ctx, w, added):
        return jpipe._noise_model(jpipe.params["reverse"], added)(x, 779, ctx, w, None)
    want = np.asarray(jax_eps(x, ctx, w, added))
    nm = port_pipe._noise_model(port_pipe.unets["reverse"],
                                {k: torch.from_numpy(v) for k, v in added.items()})
    with torch.no_grad():
        got = _nhwc(nm(_nchw(x), 779, torch.from_numpy(ctx), torch.from_numpy(w)))
    _close(got, want)
    assert not np.allclose(got[:2], got[2:])  # zero text embeds on the uncond half


def test_generate_matches_jax(port_pipe, jax_runs):
    """The [source, target] pair from one shared latent, w = 19 dynamic
    with tau 0.7 and the source context while t > 700."""
    images, latents = port_pipe.generate([SOURCE, TARGET], latent=jax_runs["latent"],
                                         guidance=_edit_guidance(port_pipe),
                                         amplify_prompt=[SOURCE])
    assert tuple(images.shape) == (2, 32, 32, 3) and tuple(latents.shape) == (2, 16, 16, 4)
    _close(latents, jax_runs["generate"][1], "latents")
    _close(images, jax_runs["generate"][0], "images")


def test_invert_matches_jax(port_pipe, jax_runs):
    inv, clean = port_pipe.invert(_image(), SOURCE, noise=jax_runs["noise"])
    _close(clean, jax_runs["invert"][1], "clean latent")
    _close(inv, jax_runs["invert"][0], "inverted latent")


def test_amplify_edit_matches_jax(port_pipe, jax_runs):
    """Without a controller: inversion at w = 0, then the [source, target]
    pair at dynamic w = 19, tau 0.7, the source context amplified while
    t > 700."""
    images, latents = port_pipe.edit(_image(), SOURCE, TARGET, noise=jax_runs["noise"])
    assert tuple(images.shape) == (2, 32, 32, 3) and tuple(latents.shape) == (2, 16, 16, 4)
    _close(latents, jax_runs["edit"][1], "latents")
    _close(images, jax_runs["edit"][0], "images")
    assert not np.allclose(latents[0].numpy(), latents[1].numpy())


def test_controlled_edit_matches_jax(port_pipe, jax_runs):
    """With a controller: SD1.5's prompt-to-prompt path on the XL bundle."""
    spec, arrays = make_controller([SOURCE, TARGET], port_pipe.tokenizer, **CONTROLLER)
    images, latents = port_pipe.edit(_image(5), SOURCE, TARGET, (spec, arrays),
                                     noise=jax_runs["noise"])
    _close(latents, jax_runs["edit_controlled"][1], "latents")
    _close(images, jax_runs["edit_controlled"][0], "images")


def test_entry_point_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InvertibleCDXL.sdxl()
