"""The port's int8 W8A8 inference against the JAX package, on the CPU.

On the CPU the port's int8 layers take kernel Q1's plain version
(`ops.quant.int8_gemm_plain`: the integer products in float64, exact, then
the same fp32 epilogue), so they compute what XLA's int32 products do.

The operations (numpy-seeded inputs), against JAX compiled (`jax.jit`), as
its pipelines run it (XLA turns the division by 127 into a multiply by its
reciprocal there, and the port does the same):
  * `quantize_int8` per tensor, per row and per channel: codes and scales
    equal to JAX's on fp32 input (the same IEEE steps);
  * the int8 dense and convolution products against `quant_dot_general` /
    `quant_conv_general_dilated`: expected bitwise, asserted at rtol 1e-6 on
    fp32 and within 1 bf16 ulp on bf16 (XLA folds the conv's two constant
    1/127 factors into one 1/127^2, which moves the dequantising factor by
    an ulp); the bias, added after in the layer's dtype, is held apart
    (in an fp32 program XLA fuses that add into an FMA, the port does not);
  * outside an int8 scope the Q-layers are bitwise `nn.Linear` /
    `nn.Conv2d`; the scope nests, resets and rejects an unknown mode; the
    gradient through an int8 layer is zero, and NTI's inner step is float
    under every mode.

The pipelines, on the JAX tiny bundle's weights through the bridge, with
the start latents and noise drawn by JAX: the int8, int8_vae and
int8_static generates and the int8 edit against JAX's within JAX's own
flip-noise envelope (`tests/test_parallel_inference.py:177-178`: mean
|diff| < 2e-2, max < 2e-1 on images: one int8 bucket that flips at a
rounding boundary moves a few pixels); the calibrated amaxes against JAX's
`quant_stats` leaves by module path (rtol 1e-5; 1e-4 for the w = 19
student, `AMAX_RTOL`); int8_vae latents and the
"off" path after calibration bit-identical to "off". The three CLIs'
`--quantize` on `--model tiny`.
"""
import dataclasses
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F
from PIL import Image

from invertible_cd_tpu import models as jmodels
from invertible_cd_tpu.diffusion import solver as jsolver
from invertible_cd_tpu.edit import make_controller as jmake_controller
from invertible_cd_tpu.ops import quant as jquant
from invertible_cd_tpu.pipelines.pipeline import InvertibleCD as JInvertibleCD
from invertible_cd_tpu.utils.tokenizer import HashTokenizer as JHashTokenizer
from invertible_cd_tpu_torch.cli import edit as edit_cli
from invertible_cd_tpu_torch.cli import generate as generate_cli
from invertible_cd_tpu_torch.cli import serve as serve_cli
from invertible_cd_tpu_torch.diffusion.solver import make_solver_grid
from invertible_cd_tpu_torch.edit import make_controller
from invertible_cd_tpu_torch.models import convert
from invertible_cd_tpu_torch.models.layers import QConv2d, QLinear
from invertible_cd_tpu_torch.ops import quant
from invertible_cd_tpu_torch.pipelines import nti
from invertible_cd_tpu_torch.pipelines.pipeline import QUANT_MODES, to_uint8
from invertible_cd_tpu_torch.testing import tiny_bundle

from _torch_jax_params import seeded_params

ENVELOPE_MEAN, ENVELOPE_MAX = 2e-2, 2e-1
PROMPTS = ["a photo of a cat", "a red fox in the snow"]
SOURCE, TARGET = "a photo of a cat on the grass", "a photo of a dog on the grass"
CONTROLLER = dict(num_steps=1, cross_replace_steps=0.6, self_replace_steps=0.4,
                  blend_words=[["cat"], ["dog"]])
TINY = ["--model", "tiny", "--device", "cpu"]
GRID = dict(reverse_timesteps=[999], forward_timesteps=[19])


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's tiny models (see
    `test_torch_baselines.py`)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rng(seed):
    return np.random.default_rng(seed)


def _activations(rng, shape):
    """N(0, 1) with a few large entries, so scales and clipping matter."""
    x = rng.standard_normal(shape).astype(np.float32)
    x.reshape(-1)[:: max(1, x.size // 7)] *= 9.0
    return x


def _assert_matches(got: np.ndarray, want: np.ndarray, dtype):
    """fp32: rtol 1e-6; bf16: within 1 ulp (the two are expected bitwise)."""
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        return
    g = torch.from_numpy(np.ascontiguousarray(got, np.float32)).bfloat16().view(torch.int16).int()
    w = torch.from_numpy(np.ascontiguousarray(want, np.float32)).bfloat16().view(torch.int16).int()
    assert (g - w).abs().max().item() <= 1


def _jdtype(dtype):
    return jnp.float32 if dtype == torch.float32 else jnp.bfloat16


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# the operations
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["per_tensor", "per_row", "per_channel"])
def test_quantize_int8_matches_jax(kind):
    rng = _rng(0)
    if kind == "per_channel":  # an OIHW conv weight; JAX's is HWIO
        w = _activations(rng, (6, 5, 3, 3))
        q, s = quant.quantize_int8(torch.from_numpy(w), axes=(1, 2, 3))
        jq, js = jax.jit(jquant.quantize_int8, static_argnums=1)(
            jnp.asarray(w.transpose(2, 3, 1, 0)), (0, 1, 2))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq).transpose(3, 2, 0, 1))
    else:
        x = _activations(rng, (7, 40))
        axes = None if kind == "per_tensor" else (1,)
        q, s = quant.quantize_int8(torch.from_numpy(x), axes=axes)
        jq, js = jax.jit(jquant.quantize_int8, static_argnums=1)(jnp.asarray(x), axes)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.dtype == torch.int8 and q.abs().max().item() == 127
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_quantize_int8_zero_tensor_is_safe():
    q, s = quant.quantize_int8(torch.zeros(4, 4))
    jq, js = jax.jit(jquant.quantize_int8)(jnp.zeros((4, 4)))
    assert torch.equal(q, torch.zeros(4, 4, dtype=torch.int8))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert torch.isfinite(s).all() and s.item() == np.float32(1.0 / 127.0)


@pytest.mark.parametrize("scale", [0.0, 7.5, 19.0])
def test_bf16_guidance_embedding_matches_jax(scale):
    """`guidance_scale_embedding(..., dtype=bf16)` (the w-embedding
    `collect_quant_stats` calibrates with): JAX rounds only w * 1000 to
    bf16, its numpy-scalar frequency product promoting the rest to fp32.
    atol 2e-3: sin/cos of up to 19000 rad differ by a few fp32 ulp."""
    from invertible_cd_tpu.diffusion.guidance import guidance_scale_embedding as jembed
    from invertible_cd_tpu_torch.diffusion.guidance import guidance_scale_embedding as embed

    got = embed(torch.full((2,), scale), 8, dtype=torch.bfloat16)
    want = jembed(jnp.full((2,), scale, jnp.float32), 8, dtype=jnp.bfloat16)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_int8_linear_matches_jax(dtype):
    """(batch, tokens, features) input, one scale per token, bias after."""
    rng = _rng(1)
    x, w, b = _activations(rng, (2, 5, 40)), _activations(rng, (24, 40)) / 6, rng.standard_normal(24)
    xt, wt, bt = (torch.from_numpy(np.asarray(a, np.float32)).to(dtype) for a in (x, w, b))
    got = quant.int8_linear(xt, wt)
    assert got.dtype == dtype and got.shape == (2, 5, 24)
    assert torch.equal(quant.int8_linear(xt, wt, bt), got + bt)  # the bias after, in the dtype
    jd = _jdtype(dtype)
    with jquant.quant_scope("int8"):  # read while tracing: jit inside the scope
        want = jax.jit(lambda a, k: jquant.quant_dot_general(a, k, (((2,), (0,)), ((), ()))))(
            jnp.asarray(x, jd), jnp.asarray(w.T, jd))
    assert want.dtype == jd
    _assert_matches(got.float().numpy(), _np(want), dtype)


CONVS = {  # (C, N, kernel, stride, padding; "0101" = Downsample2D's asymmetric pad)
    "3x3_s1_p1": (8, 6, 3, 1, 1),
    "3x3_s2_pad0101": (8, 6, 3, 2, "0101"),
    "1x1": (8, 5, 1, 1, 0),
    "c3_3x3": (3, 8, 3, 1, 1),
    "c4_3x3": (4, 8, 3, 1, 1),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", list(CONVS))
def test_int8_conv2d_matches_jax(case, dtype):
    c, n, k, stride, pad = CONVS[case]
    rng = _rng(2)
    x, w, b = _activations(rng, (2, 9, 9, c)), _activations(rng, (k, k, c, n)) / 5, rng.standard_normal(n)
    if pad == "0101":
        x = np.pad(x, ((0, 0), (0, 1), (0, 1), (0, 0)))
        pad = 0
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(dtype)
    wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).to(dtype)
    bt = torch.from_numpy(b.astype(np.float32)).to(dtype)
    got = quant.int8_conv2d(xt, wt, None, (stride, stride), (pad, pad))
    assert torch.equal(quant.int8_conv2d(xt, wt, bt, (stride, stride), (pad, pad)),
                       got + bt[None, :, None, None])  # the bias after, in the dtype
    jd = _jdtype(dtype)
    with jquant.quant_scope("int8"):
        want = jax.jit(lambda a, k: jquant.quant_conv_general_dilated(
            a, k, (stride, stride), [(pad, pad), (pad, pad)],
            dimension_numbers=("NHWC", "HWIO", "NHWC")))(jnp.asarray(x, jd), jnp.asarray(w, jd))
    assert got.dtype == dtype and want.dtype == jd
    _assert_matches(got.permute(0, 2, 3, 1).float().numpy(), _np(want), dtype)


def test_int8_conv2d_static_amax_matches_jax():
    """"int8_static": the calibrated amax (floored at 1e-12) replaces the
    dynamic one; activations beyond it clip."""
    rng = _rng(3)
    x, w = _activations(rng, (1, 6, 6, 4)), _activations(rng, (3, 3, 4, 8)) / 5
    amax = np.float32(np.abs(x).max() / 2)
    got = quant.int8_conv2d(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                            torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), None, (1, 1), (1, 1),
                            amax=torch.tensor(amax))
    with jquant.quant_scope("int8_static"):
        token = jquant._STATIC_AMAX.set(jnp.asarray(amax))
        try:
            want = jax.jit(lambda a, k: jquant.quant_conv_general_dilated(
                a, k, (1, 1), [(1, 1), (1, 1)], dimension_numbers=("NHWC", "HWIO", "NHWC")))(
                    jnp.asarray(x), jnp.asarray(w))
        finally:
            jquant._STATIC_AMAX.reset(token)
    _assert_matches(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), torch.float32)


def test_int8_gemm_plain_is_exact_and_nhwc():
    """Q1's plain version: the int32 accumulators of a K = 36 (C = 4)
    stride-2 conv equal an int64 reference; the epilogue multiplies the
    scales first."""
    rng = _rng(4)
    a = torch.from_numpy(rng.integers(-127, 128, (2, 7, 7, 4)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (3, 3, 3, 4)).astype(np.int8))
    acc = quant.int8_gemm_acc(a, b, (2, 2), (1, 1))
    assert acc.dtype == torch.int32 and tuple(acc.shape) == (2, 4, 4, 3)
    ap = F.pad(a.long().permute(0, 3, 1, 2), (1, 1, 1, 1))
    want = torch.zeros(2, 3, 4, 4, dtype=torch.long)
    for i in range(4):
        for j in range(4):
            patch = ap[:, :, 2 * i:2 * i + 3, 2 * j:2 * j + 3]
            want[:, :, i, j] = torch.einsum("bchw,nhwc->bn", patch, b.long())
    assert torch.equal(acc.long(), want.permute(0, 2, 3, 1))
    s_row, s_col = torch.tensor([0.013]), torch.tensor([0.5, 0.02, 3.0])
    out = quant.int8_gemm(a, b, s_row, s_col, (2, 2), (1, 1), torch.float32)
    assert torch.equal(out, acc.float() * (s_row * s_col))


def _layers(seed=5):
    torch.manual_seed(seed)
    lin, qlin = nn.Linear(12, 7), QLinear(12, 7)
    conv, qconv = nn.Conv2d(4, 6, 3, stride=2, padding=1), QConv2d(4, 6, 3, stride=2, padding=1)
    qlin.load_state_dict(lin.state_dict())
    qconv.load_state_dict(conv.state_dict())
    return lin, qlin, conv, qconv


def test_q_layers_outside_an_int8_scope_are_the_plain_layers():
    """Bitwise `nn.Linear` / `nn.Conv2d` with no scope, under "off" and
    under "calibrate" (which records the conv's input amax); same keys."""
    lin, qlin, conv, qconv = _layers()
    x, img = torch.randn(3, 12), torch.randn(2, 4, 9, 9)
    assert set(qlin.state_dict()) == set(lin.state_dict())
    assert set(qconv.state_dict()) == set(conv.state_dict())
    root = nn.ModuleDict({"lin": qlin, "conv": qconv})
    stats = {}
    for mode in (None, "off", "calibrate"):
        with (quant.quant_scope(mode, stats if mode == "calibrate" else None, root=root)
              if mode else torch.no_grad()):
            assert torch.equal(qlin(x), lin(x))
            assert torch.equal(qconv(img), conv(img))
    assert set(stats) == {"conv"} and torch.equal(stats["conv"], img.abs().amax())


def test_calibrate_records_running_max_by_module_name():
    model = nn.Sequential(QConv2d(3, 4, 3, padding=1), nn.ReLU(), QConv2d(4, 2, 1))
    stats = {}
    xs = [torch.randn(1, 3, 5, 5) * s for s in (1.0, 3.0, 2.0)]
    with quant.quant_scope("calibrate", stats, root=model):
        outs = [model(x) for x in xs]
    assert set(stats) == {"0", "2"}
    assert torch.equal(stats["0"], torch.stack([x.abs().amax() for x in xs]).amax())
    assert torch.equal(outs[0], model(xs[0]))  # float maths while calibrating
    with quant.quant_scope("int8_static", {"0": stats["0"]}, root=model):
        static = model(xs[0])
    with quant.quant_scope("int8", root=model):
        dynamic = model(xs[0])
    assert not torch.equal(static, dynamic)  # conv 0 reads its calibrated amax
    with quant.quant_scope("int8_static", {}, root=model):
        assert torch.equal(model(xs[0]), dynamic)


def test_grouped_and_dilated_convs_fall_through():
    torch.manual_seed(6)
    x = torch.randn(1, 4, 8, 8)
    for kw in (dict(groups=2), dict(dilation=2)):
        q = QConv2d(4, 4, 3, padding=2, **kw)
        with quant.quant_scope("int8"):
            got = q(x)
        assert torch.equal(got, F.conv2d(x, q.weight, q.bias, 1, 2, **kw))


def test_scope_nests_resets_and_rejects_unknown_modes():
    assert quant.current_quant_mode() == "off"
    with quant.quant_scope("int8"):
        with quant.quant_scope("int8_static"):
            assert quant.current_quant_mode() == "int8_static"
        assert quant.current_quant_mode() == "int8"
    with pytest.raises(RuntimeError):
        with quant.quant_scope("int8"):
            raise RuntimeError("boom")
    assert quant.current_quant_mode() == "off"
    with pytest.raises(ValueError):
        with quant.quant_scope("fp4"):
            pass
    pipe = tiny_bundle(None)
    pipe.quantize = "fp4"
    with pytest.raises(ValueError, match="quantize"):
        pipe._unet_quant_mode()
    with pytest.raises(ValueError, match="quantize"):
        dataclasses.replace(pipe, quantize="fp8")


def test_int8_layers_have_zero_gradient():
    """As JAX's round: an int8 scope trains nothing (the bias, added after
    the product, keeps its gradient)."""
    _, qlin, _, qconv = _layers()
    x, img = torch.randn(3, 12, requires_grad=True), torch.randn(1, 4, 9, 9, requires_grad=True)
    with quant.quant_scope("int8"):
        (qlin(x).sum() + qconv(img).sum()).backward()
    for t in (x, img, qlin.weight, qconv.weight):
        assert t.grad is not None and torch.equal(t.grad, torch.zeros_like(t))
    assert qlin.bias.grad.abs().sum() > 0


# ---------------------------------------------------------------------------
# the pipelines: the JAX tiny bundle with numpy-seeded weights, on a 1-hop grid
# ---------------------------------------------------------------------------
def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_pipe():
    """The JAX package's tiny SD1.5 bundle with numpy-seeded weights (Flax's
    init, op by op, would cost most of a minute) on the 1-hop grid (each of
    JAX's compiled pipeline programs here costs seconds a hop)."""
    unet_cfg, clip_cfg = jmodels.UNetConfig.tiny(), jmodels.CLIPTextConfig.tiny()
    pipe = JInvertibleCD.sd15(dtype=jnp.float32, unet_cfg=unet_cfg, clip_cfg=clip_cfg,
                              vae_cfg=jmodels.VAEConfig.tiny(), latent_size=(16, 16),
                              tokenizer=JHashTokenizer(clip_cfg.vocab_size),
                              grid=jsolver.make_solver_grid(**GRID))
    return dataclasses.replace(pipe, params=seeded_params(pipe.params))


@pytest.fixture(scope="module")
def port_pipe(jax_pipe):
    port = tiny_bundle(convert.bundle_state_dicts_from_flax(_np_tree(jax_pipe.params)))
    port.grid = make_solver_grid(**GRID)
    return port


@pytest.fixture(scope="module")
def latent():
    return np.asarray(jnp.broadcast_to(jax.random.normal(jax.random.PRNGKey(150), (1, 16, 16, 4)),
                                       (len(PROMPTS), 16, 16, 4)))


def _generate(pipe, mode, latent_np, jax_side: bool):
    pipe.quantize = mode
    try:
        if jax_side:
            imgs, lat = pipe.generate(PROMPTS, latent=jnp.asarray(latent_np))
            return np.asarray(imgs), np.asarray(lat)
        imgs, lat = pipe.generate(PROMPTS, latent=torch.from_numpy(latent_np))
        return imgs.numpy(), lat.numpy()
    finally:
        pipe.quantize = "off"


@pytest.fixture(scope="module")
def port_off(port_pipe, latent):
    return _generate(port_pipe, "off", latent, jax_side=False)


def _envelope(got, want):
    diff = np.abs(got - want)
    assert diff.mean() < ENVELOPE_MEAN, f"mean {diff.mean()} exceeds flip noise"
    assert diff.max() < ENVELOPE_MAX, f"max {diff.max()} exceeds flip noise"


def test_int8_generate_matches_jax(port_pipe, jax_pipe, latent, port_off):
    """Images within the flip envelope. (The latents are not held: the x0
    prediction at t = 999 multiplies a flipped bucket's noise by
    1/sqrt(alpha_bar) ~ 14.)"""
    images, _ = _generate(port_pipe, "int8", latent, jax_side=False)
    want_images, _ = _generate(jax_pipe, "int8", latent, jax_side=True)
    assert np.isfinite(images).all() and np.abs(images - port_off[0]).max() > 0
    _envelope(images, want_images)


def test_int8_vae_generate_matches_jax(port_pipe, jax_pipe, latent, port_off):
    """int8_vae: the port's images against JAX's int8 VAE decode of the
    port's latents (its float UNets are held to JAX's by
    `test_torch_pipeline.py`; the decode program costs a fraction of a
    generate's), within the envelope."""
    images, lat = _generate(port_pipe, "int8_vae", latent, jax_side=False)
    jax_pipe.quantize = "int8_vae"
    try:
        want = jax_pipe.decode(jnp.asarray(lat))
    finally:
        jax_pipe.quantize = "off"
    assert np.abs(images - port_off[0]).max() > 0
    _envelope(images, want)


def test_int8_vae_latents_equal_off_and_static_without_stats_equals_int8(port_pipe, latent, port_off):
    images, lat = _generate(port_pipe, "int8_vae", latent, jax_side=False)
    np.testing.assert_array_equal(lat, port_off[1])
    assert np.abs(images - port_off[0]).max() > 0
    assert not port_pipe.quant_stats
    np.testing.assert_array_equal(_generate(port_pipe, "int8_static", latent, jax_side=False)[0],
                                  _generate(port_pipe, "int8", latent, jax_side=False)[0])


def _jax_stats_by_port_name(tree, vae: bool):
    """JAX's quant_stats leaves {flax path: act_amax} -> {port module name:
    amax}, each path named by the weights bridge's own mapping (a conv
    kernel at that path)."""
    to_port = convert.vae_state_dict_from_flax if vae else convert.unet_state_dict_from_flax
    out = {}
    for path, value in convert._leaves(tree):
        assert path[-1] == "act_amax"
        fake = node = {}
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node["kernel"] = np.zeros((1, 1, 1, 1), np.float32)
        (key,) = to_port(fake)
        out[key[: -len(".weight")]] = np.float32(value)
    return out


@pytest.fixture(scope="module")
def calibrated(port_pipe, jax_pipe, latent):
    """Both packages' `collect_quant_stats`, then their int8_static
    generates; the port's on a copy of the bundle with stats of its own.

    The port calibrates from JAX's draws for PRNGKey(3) (start latent and
    inversion noise). Its "off" reference trajectories (generate, then the
    invert of its images) are handed to JAX's `collect_quant_stats` in place
    of JAX's own (its `generate` / `invert` patched for the call): the hop
    inputs are cast to bf16 before calibrating, in both packages, so a 1e-6
    fp32 difference in a trajectory could become a 2^-8 step in an amax;
    the trajectories themselves are held by `test_torch_pipeline.py` and
    `test_torch_edit_pipeline.py`."""
    key = jax.random.PRNGKey(3)
    z = torch.from_numpy(np.asarray(jax_pipe.init_latent(key, len(PROMPTS))))
    noise = torch.from_numpy(np.asarray(
        jax.random.normal(jax.random.fold_in(key, 1), (len(PROMPTS), 16, 16, 4))))
    pipe = dataclasses.replace(port_pipe, quant_stats={})
    before = _generate(pipe, "off", latent, jax_side=False)
    pipe.collect_quant_stats(PROMPTS, latent=z, noise=noise)
    images, traj = pipe.generate(PROMPTS, latent=z, return_trajectory=True)
    inv_traj, _ = pipe.invert(images * 255.0, PROMPTS, noise=noise,
                              guidance=pipe.default_guidance(guidance_scale=0.0),
                              return_trajectory=True)
    jax_pipe.generate = lambda *a, **k: (jnp.asarray(images.numpy()), jnp.asarray(traj.numpy()))
    jax_pipe.invert = lambda *a, **k: (jnp.asarray(inv_traj.numpy()), None)
    try:
        jax_pipe.collect_quant_stats(PROMPTS, key=key)
    finally:
        del jax_pipe.generate, jax_pipe.invert
    out = {
        "pipe": pipe, "before": before,
        "port": _generate(pipe, "int8_static", latent, jax_side=False),
        "jax": _generate(jax_pipe, "int8_static", latent, jax_side=True),
        "jax_stats": {m: _np_tree(jax_pipe.params[m]["quant_stats"]) for m in ("reverse", "forward", "vae")},
    }
    for m in ("reverse", "forward", "vae"):
        jax_pipe.params[m] = {k: v for k, v in jax_pipe.params[m].items() if k != "quant_stats"}
    jax_pipe._jit_cache.clear()
    return out


# rtol per model: the forward student (w = 0) and the VAE see identical
# inputs in both packages, so their amaxes differ by fp32 summation order
# only; the reverse student's w = 19 embedding takes sin/cos of up to
# 19000 rad, where the two frameworks differ by up to 2e-3 (the w-embedding
# test's tolerance in `test_torch_pipeline.py`), which moves its deep
# activations' amaxes by up to ~3e-5 relative
AMAX_RTOL = {"reverse": 1e-4, "forward": 1e-5, "vae": 1e-5}


@pytest.mark.parametrize("model", ["reverse", "forward", "vae"])
def test_calibrated_amaxes_match_jax(model, calibrated):
    want = _jax_stats_by_port_name(calibrated["jax_stats"][model], vae=model == "vae")
    got = {k: v.item() for k, v in calibrated["pipe"].quant_stats[model].items()}
    assert set(got) == set(want) and len(got) > 10
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=AMAX_RTOL[model], err_msg=name)


def test_int8_static_generate_matches_jax_and_off_is_unchanged(calibrated, port_off, latent):
    images = calibrated["port"][0]
    assert np.abs(images - port_off[0]).max() > 0
    _envelope(images, calibrated["jax"][0])
    np.testing.assert_array_equal(calibrated["before"][0], port_off[0])
    after = _generate(calibrated["pipe"], "off", latent, jax_side=False)
    np.testing.assert_array_equal(after[0], port_off[0])
    np.testing.assert_array_equal(after[1], port_off[1])


@pytest.mark.slow  # the JAX XL bundle's own programs: over the file's budget
def test_tiny_sdxl_int8_generate_matches_jax():
    """The tiny XL bundle (added conditioning; its VAE in fp32, so Q1's
    fp32 epilogue) under int8, from the same start latent, against JAX's:
    images within the envelope."""
    import flax.linen as nn

    from invertible_cd_tpu.testing import tiny_bundle_xl as jtiny_bundle_xl
    from invertible_cd_tpu_torch.testing import tiny_bundle_xl

    init = nn.Module.init

    def abstract_init(self, rngs, *args):
        return jax.eval_shape(lambda r, a: init(self, r, *a), rngs, args)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", abstract_init)
        jxl = jtiny_bundle_xl()
    jxl = dataclasses.replace(jxl, params=seeded_params(jxl.params),
                              grid=jsolver.make_solver_grid(**GRID), quantize="int8")
    xl = dataclasses.replace(tiny_bundle_xl(convert.bundle_state_dicts_from_flax(_np_tree(jxl.params))),
                             grid=make_solver_grid(**GRID), quantize="int8")
    z = np.asarray(jxl.init_latent(jax.random.PRNGKey(150), 2))
    want, _ = jxl.generate(PROMPTS, latent=jnp.asarray(z))
    got, _ = xl.generate(PROMPTS, latent=torch.from_numpy(z))
    assert xl.vae.dtype == torch.float32 and torch.isfinite(got).all()
    _envelope(got.numpy(), np.asarray(want))


def _image(seed=0):
    return _rng(seed).integers(0, 255, (32, 32, 3), np.uint8)


@pytest.mark.slow  # two more JAX programs (~25 s cold): over the file's budget
def test_int8_edit_matches_jax(port_pipe, jax_pipe):
    """The edit under int8: its inversion's clean latent (the int8 VAE
    encode) and its controlled [source, target] pair from JAX's inverted
    latent against JAX's edit, within the envelope. The pair is
    teacher-forced: the forward hops scale a flipped bucket's noise
    prediction up (mean |diff| ~7e-2 on the unit-variance inverted latent
    here), which the envelope, set on a generate, does not cover."""
    img, key = _image(5), jax.random.PRNGKey(2)
    noise = np.asarray(jax.random.normal(key, (1, 16, 16, 4)))
    jax_pipe.quantize = "int8"
    try:
        jinv, jclean = jax_pipe.invert(img, SOURCE, key=key)
        want, _ = jax_pipe.edit(img, SOURCE, TARGET,
                                jmake_controller([SOURCE, TARGET], jax_pipe.tokenizer, **CONTROLLER),
                                key=key)
    finally:
        jax_pipe.quantize = "off"
    ctrl = make_controller([SOURCE, TARGET], port_pipe.tokenizer, **CONTROLLER)
    g = port_pipe.default_guidance(guidance_scale=19.0, dynamic_guidance=True, tau1=0.8, tau2=0.8,
                                   edit_pair=True)  # `InvertibleCD.edit`'s default
    port_pipe.quantize = "int8"
    try:
        _, clean = port_pipe.invert(img, SOURCE, noise=noise)
        pair, _ = port_pipe.generate([SOURCE, TARGET], guidance=g, controller=ctrl,
                                     latent=np.broadcast_to(np.asarray(jinv)[:1], (2, 16, 16, 4)))
        edited, _ = port_pipe.edit(img, SOURCE, TARGET, ctrl, noise=noise)
    finally:
        port_pipe.quantize = "off"
    _envelope(clean.numpy(), np.asarray(jclean))
    _envelope(pair.numpy(), np.asarray(want))
    assert edited.shape == (2, 32, 32, 3) and torch.isfinite(edited).all()


def test_nti_inner_step_stays_float_under_int8(port_pipe):
    """NTI's optimisation (cond prediction, inner Adam step, the advance)
    applies the teacher outside any scope, as JAX's `nti.py:33-37`: the same
    bits under "int8" as under "off"; its DDIM inversion is quantised."""
    pipe = port_pipe
    ctx_u, ctx_c = pipe.encode_prompt([SOURCE])
    rng = _rng(7)
    cur = torch.from_numpy(rng.standard_normal((1, 4, 16, 16)).astype(np.float32))
    prev = torch.from_numpy(rng.standard_normal((1, 4, 16, 16)).astype(np.float32))
    outs = {}
    for mode in ("off", "int8"):
        pipe.quantize = mode
        try:
            step = nti.make_nti_step(pipe, 1, 7.5)
            outs[mode] = step(ctx_u, cur, prev, ctx_c, 981, 1e-2, 0.0)
            with torch.no_grad():
                outs[mode + "_eps"] = pipe._noise_model(pipe.unets["teacher"])(cur, 981, ctx_c, None)
        finally:
            pipe.quantize = "off"
    for i in range(2):  # the optimised embedding and the next latent
        assert torch.equal(outs["off"][i], outs["int8"][i])
    assert outs["off"][3] == outs["int8"][3] == 1
    assert not torch.equal(outs["off_eps"], outs["int8_eps"])  # the DDIM paths are quantised


# ---------------------------------------------------------------------------
# the CLIs' --quantize on the tiny model
# ---------------------------------------------------------------------------
def _jpeg(image: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="JPEG")
    return buf.getvalue()


def test_cli_quantize_flags_take_the_jax_choices():
    for cli, req in ((generate_cli, ["--out", "x"]), (edit_cli, ["--out", "x"]), (serve_cli, [])):
        assert cli.parse_args(req).quantize == "off"
        for mode in QUANT_MODES:
            assert cli.parse_args(req + ["--quantize", mode]).quantize == mode
        with pytest.raises(SystemExit):
            cli.parse_args(req + ["--quantize", "int4"])


@pytest.mark.slow  # a CLI run: over the file's budget
def test_generate_cli_int8_static_calibrates_once(tmp_path):
    out = str(tmp_path / "gen")
    argv = TINY + ["--quantize", "int8_static", "--prompt", "a cat", "--out", out]
    generate_cli.main(argv)
    pipe = generate_cli.build_pipeline(generate_cli.parse_args(argv))
    assert pipe.quantize == "int8_static" and set(pipe.quant_stats) == {"reverse", "forward", "vae"}
    g = pipe.default_guidance(guidance_scale=19.0, dynamic_guidance=True, tau1=0.8, tau2=0.8)
    imgs, _ = pipe.generate(["a cat"], generator=torch.Generator().manual_seed(150), guidance=g)
    with open(os.path.join(out, "manifest.json")) as f:
        (path,) = json.load(f)["files"]
    with open(path, "rb") as f:
        assert f.read() == _jpeg(to_uint8(imgs)[0])


@pytest.mark.slow  # a CLI run: over the file's budget
def test_edit_cli_int8_restores_a_given_bundles_mode(tmp_path, port_pipe):
    src = tmp_path / "in.png"
    Image.fromarray(_image(3)).save(src)
    files = {}
    for mode in ("off", "int8"):
        out = str(tmp_path / mode)
        edit_cli.main(TINY + ["--quantize", mode, "--image", str(src), "--source", SOURCE,
                              "--target", TARGET, "--out", out], _pipe=port_pipe)
        assert port_pipe.quantize == "off"
        with open(os.path.join(out, "results.json")) as f:
            with open(json.load(f)["results"][0]["file"], "rb") as g:
                files[mode] = g.read()
    assert files["off"] != files["int8"]


@pytest.mark.slow  # a CLI run: over the file's budget
def test_serve_cli_int8_serves_the_int8_image(port_pipe):
    args = serve_cli.parse_args(["--model", "tiny", "--device", "cpu", "--quantize", "int8",
                                 "--port", "0", "--batch_size", "1", "--max_delay_ms", "1"])
    pipe = dataclasses.replace(port_pipe, quant_stats={})
    server, ex = serve_cli.make_server(args, pipe=pipe)
    try:
        assert pipe.quantize == "int8"
        served = torch.as_tensor(ex.submit("a cat", seed=7).result(timeout=120))
        want, _ = pipe.generate(["a cat"], latent=ex._latents([7]), guidance=ex.guidance)
        pipe.quantize = "off"
        off, _ = pipe.generate(["a cat"], latent=ex._latents([7]), guidance=ex.guidance)
    finally:
        ex.shutdown()
        server.server_close()
    assert torch.equal(served, want[0]) and not torch.equal(served, off[0])
