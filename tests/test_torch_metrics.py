"""The port's metric suite against the JAX package's, fp32 on the CPU.

Both packages get the same numpy-seeded weights (`traced_init` +
`seeded_params`, passed to the port through
`models.convert.metric_state_dict_from_flax`) and the same numpy inputs.
Each JAX module is compiled once per file. Tolerances, stated at each
comparison: rtol 1e-4 / atol 1e-5 on fp32 features and scores (the same
fp32 operations in another order); atol 1e-5 on resized images in [0, 1]
(one weighted sum of up to a few dozen pixels per output); 1e-6 relative
on a Fréchet distance computed from the same features (the same float64
numpy code). The published-checkpoint converters are held to JAX's
converters on state dicts this file writes itself.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invertible_cd_tpu.metrics import basic as jbasic
from invertible_cd_tpu.metrics import fid as jfid
from invertible_cd_tpu.metrics import frechet as jfrechet
from invertible_cd_tpu.metrics import image_reward as jir
from invertible_cd_tpu.metrics import inception as jinception
from invertible_cd_tpu.metrics import lpips as jlpips
from invertible_cd_tpu.metrics import scores as jscores
from invertible_cd_tpu.metrics import vit as jvit
from invertible_cd_tpu.models import convert as jconvert
from invertible_cd_tpu.utils import tokenizer as jtokenizer
from invertible_cd_tpu_torch import testing
from invertible_cd_tpu_torch.metrics import basic, frechet, image_reward, inception, lpips, resize
from invertible_cd_tpu_torch.metrics import scores, vit
from invertible_cd_tpu_torch.metrics.fid import FIDScorer
from invertible_cd_tpu_torch.models import convert
from invertible_cd_tpu_torch.utils import tokenizer

from _torch_jax_params import seeded_params, traced_init

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's small modules (see
    `test_torch_baselines.py`): under the suite's parallel workers more
    threads oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bridge(variables):
    return convert.metric_state_dict_from_flax(jax.tree.map(np.asarray, variables))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# resize, basic, Fréchet
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("size_in,size_out,method", [
    ((512, 512), (224, 224), "cubic"),   # the ViTs' preprocessing: antialiased downsample
    ((256, 256), (299, 299), "bilinear"),  # FID-Inception's input resize
    ((32, 32), (28, 28), "cubic"),       # the tiny ViTs'
    ((40, 48), (224, 224), "bilinear"),  # LPIPS's resize of a non-square image
])
def test_resize_matches_jax_image_resize(size_in, size_out, method):
    """atol 1e-5 on images in [0, 1]; the port builds JAX's weight matrices
    in JAX's float32 arithmetic."""
    x = np.random.default_rng(0).uniform(size=(2, *size_in, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *size_out, 3), method))
    got = resize.resize(_nchw(x), size_out, method).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        resize.resize(_nchw(x), size_out, "lanczos3")


def test_frechet_and_basic_match_jax_and_the_sqrtm_formula():
    """Fréchet distance and the pixel metrics against JAX's (1e-12: the same
    float64 numpy code) and against scipy's sqrtm formula (1e-6 relative)."""
    import scipy.linalg

    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(50, 5)), rng.normal(size=(60, 5)) * 1.5 + 0.3
    mu1, s1 = frechet.compute_statistics(a)
    mu2, s2 = frechet.compute_statistics(b)
    jm1, js1 = jfrechet.compute_statistics(a)
    np.testing.assert_array_equal(mu1, jm1)
    np.testing.assert_array_equal(s1, js1)
    d = frechet.frechet_distance(mu1, s1, mu2, s2)
    np.testing.assert_allclose(d, jfrechet.frechet_distance(mu1, s1, mu2, s2), rtol=1e-12)
    np.testing.assert_allclose(frechet.frechet_from_features(a, b), d, rtol=1e-12)
    covmean = scipy.linalg.sqrtm(s1 @ s2).real
    ref = (mu1 - mu2) @ (mu1 - mu2) + np.trace(s1) + np.trace(s2) - 2 * np.trace(covmean)
    np.testing.assert_allclose(d, ref, rtol=1e-6)
    assert abs(frechet.frechet_distance(mu1, s1, mu1, s1)) < 1e-9

    x = rng.uniform(0, 255, (2, 4, 4, 3))
    y = x + rng.normal(size=x.shape)
    assert basic.mse(x, y) == jbasic.mse(x, y) and basic.psnr(x, y) == jbasic.psnr(x, y)
    np.testing.assert_array_equal(basic.batch_psnr(x, y), jbasic.batch_psnr(x, y))
    assert basic.psnr(x, x) == float("inf")


# ---------------------------------------------------------------------------
# FID-Inception
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def inception_world():
    """Seeded Inception variables (positive BatchNorm variances) and the
    JAX module with its 299^2 input resize, compiled once for batch 2."""
    variables = seeded_params(traced_init(
        jinception.InceptionV3Features(resize_input=False), jnp.zeros((1, 75, 75, 3))))
    jax_scorer = jfid.FIDScorer(variables)
    port_scorer = FIDScorer.from_state_dict(_bridge(variables), device="cpu")
    return variables, jax_scorer, port_scorer


def test_inception_at_75_matches_jax(inception_world):
    """Inception v3's smallest input (75^2), batch 2, without the resize:
    features rtol 1e-4 / atol 1e-5."""
    variables = inception_world[0]
    x = np.random.default_rng(2).uniform(size=(2, 75, 75, 3)).astype(np.float32)
    jmod = jinception.InceptionV3Features(resize_input=False)
    want = np.asarray(jax.jit(jmod.apply)(variables, jnp.asarray(x)))
    model = inception.InceptionV3Features(resize_input=False)
    model.load_state_dict(_bridge(variables))
    with torch.inference_mode():
        got = model(_nchw(x))
    assert got.shape == (2, 2048) and np.isfinite(want).all() and np.abs(want).max() > 0
    _close(got, want)


def test_fid_scorer_at_299_matches_jax(inception_world, tmp_path):
    """`FIDScorer.features` on two 64^2 uint8 images (the host's LANCZOS
    256^2 crop, then the in-model 299^2 bilinear resize): rtol 1e-4 / atol
    1e-5. The port's stats npz holds JAX's statistics of its features (bit
    for bit), and read as JAX reads one, it scores JAX's features of the
    same images at ~0; the distance from the same features 1e-6 relative."""
    _, jax_scorer, port_scorer = inception_world
    rng = np.random.default_rng(3)
    a = [rng.integers(0, 256, (64, 64, 3), np.uint8) for _ in range(2)]
    want = jax_scorer.features(a)
    got = port_scorer.features(a)
    _close(got, want)
    port_npz = str(tmp_path / "port.npz")
    port_scorer.save_statistics(a, port_npz)
    with np.load(port_npz) as f:
        mu, sigma = jfrechet.compute_statistics(got)
        np.testing.assert_array_equal(f["mu"], mu)
        np.testing.assert_array_equal(f["sigma"], sigma)
    with np.load(port_npz) as f:  # as JAX's `FIDScorer.fid` reads a stats file
        fid = jfrechet.frechet_distance(*jfrechet.compute_statistics(want), f["mu"], f["sigma"])
    assert abs(fid) < 1e-4 * np.trace(sigma), fid
    f1 = rng.normal(size=(6, 64)).astype(np.float32)
    f2 = f1 + 0.1 * rng.normal(size=f1.shape).astype(np.float32)
    np.testing.assert_allclose(frechet.frechet_from_features(f1, f2),
                               jfrechet.frechet_from_features(f1, f2), rtol=1e-6)


# ---------------------------------------------------------------------------
# LPIPS, the ViTs, BERT and ImageReward
# ---------------------------------------------------------------------------
def test_lpips_matches_jax():
    """LPIPS at 32^2 on image pairs in [-1, 1]: (B,) distances rtol 1e-4 /
    atol 1e-5; zero for identical images."""
    rng = np.random.default_rng(4)
    a, b = (rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    jmod = jlpips.LPIPS()
    variables = seeded_params(traced_init(jmod, jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 32, 32, 3))))
    want = np.asarray(jax.jit(jmod.apply)(variables, a, b))
    model = lpips.LPIPS()
    model.load_state_dict(_bridge(variables))
    with torch.inference_mode():
        got = model(_nchw(a), _nchw(b))
        same = model(_nchw(a), _nchw(a))
    _close(got, want)
    assert float(same.abs().max()) == 0.0


@pytest.mark.parametrize("kind", ["clip", "dino"])
def test_vit_encoder_matches_jax(kind):
    """The tiny CLIP ViT (pre-LN, quick-gelu, no patch bias, projection) and
    a tiny DINOv2-style ViT (layer scale, gelu, eps 1e-6, no projection) on
    preprocessed 28^2 inputs: rtol 1e-4 / atol 1e-5."""
    jcfg = jvit.ViTConfig.tiny()
    if kind == "dino":
        jcfg = dataclasses.replace(jcfg, projection_dim=None, layer_scale_init=1e-5, pre_ln=False,
                                   norm_eps=1e-6, hidden_act="gelu")
    cfg = vit.ViTConfig(**dataclasses.asdict(jcfg))
    x01 = np.random.default_rng(5).uniform(size=(2, 40, 36, 3)).astype(np.float32)
    jmod = jvit.ViTEncoder(jcfg)
    variables = seeded_params(traced_init(jmod, jnp.zeros((1, 28, 28, 3))))
    mean, std = jvit.CLIP_IMAGE_MEAN, jvit.CLIP_IMAGE_STD
    want = np.asarray(jax.jit(lambda p, x: jmod.apply(p, jvit.preprocess_for(x, 28, mean, std)))(
        variables, x01))
    model = vit.ViTEncoder(cfg)
    model.load_state_dict(_bridge(variables))
    with torch.inference_mode():
        got = model(vit.preprocess_for(_nchw(x01), 28, mean, std))
    assert got.shape == (2, 16 if kind == "clip" else 32)
    _close(got, want)


VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "photo", "of", "the", "cat", "dog",
         "##s", "##ing", "run", "caf", "!", ",", ".", "$", "大", "big"]


def _vocab_file(tmp_path):
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    return str(path)


def test_bert_wordpiece_tokenizer_matches_jax(tmp_path):
    """Lowercasing, accent stripping, punctuation and CJK splits, WordPiece
    continuations, [UNK], truncation to max_len with [SEP] last: the same
    ids as JAX's tokenizer on the same vocab.txt."""
    path = _vocab_file(tmp_path)
    texts = ["A photo of the Cats!", "running dogs, $5 CAFÉ.", "大big zebra",
             " ".join(["cat"] * 50), ""]
    for max_len in (35, 8):
        got = tokenizer.BertWordPieceTokenizer(path, max_len=max_len)(texts)
        want = jtokenizer.BertWordPieceTokenizer(path, max_len=max_len)(texts)
        np.testing.assert_array_equal(got, want)
    ids = tokenizer.BertWordPieceTokenizer(path)(["A cats!"])[0]
    assert ids[:6].tolist() == [2, 5, 9, 11, 15, 3] and not ids[6:].any()


@pytest.fixture(scope="module")
def ir_world():
    """The tiny ImageReward (the JAX tests' config) with seeded weights, in
    both packages."""
    jvcfg = dataclasses.replace(jvit.ViTConfig.tiny(), projection_dim=None)
    jbcfg = jir.BertConfig.tiny(encoder_width=jvcfg.hidden_size)
    jmod = jir.ImageReward(jvcfg, jbcfg)
    variables = seeded_params(traced_init(jmod, jnp.zeros((1, 28, 28, 3)), jnp.zeros((1, 12), jnp.int32)))
    model = image_reward.ImageReward(vit.ViTConfig(**dataclasses.asdict(jvcfg)),
                                     image_reward.BertConfig(**dataclasses.asdict(jbcfg)))
    model.load_state_dict(_bridge(variables))
    return jmod, variables, model.eval(), jax.jit(jmod.apply)


def test_image_reward_matches_jax(ir_world):
    """Scores of the tiny model with a text mask: rtol 1e-4 / atol 1e-5."""
    jmod, variables, model, apply = ir_world
    rng = np.random.default_rng(6)
    images = rng.uniform(size=(2, 28, 28, 3)).astype(np.float32)
    ids = rng.integers(0, 999, (2, 12)).astype(np.int32)
    mask = np.arange(12)[None] < np.array([[5], [9]])
    want = np.asarray(apply(variables, images, ids, mask))
    with torch.inference_mode():
        got = model(_nchw(images), torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert got.shape == (2,)
    _close(got, want)


def test_image_reward_text_mask_cases():
    """JAX's `[SEP]` rule (`tests/test_metrics.py`): the last [SEP] ends the
    valid span (a real id 0 inside it stays valid), no [SEP] keeps the row;
    without `sep_id` the pad id masks, CLS always valid."""
    class Sep:
        sep_id = 3
        pad_id = 0

    class Pad:
        pad_token_id = 7

    ids = np.array([[2, 9, 0, 3, 0, 0], [2, 3, 0, 0, 0, 0], [2, 9, 9, 9, 9, 9]])
    want = [[True] * 4 + [False] * 2, [True] * 2 + [False] * 4, [True] * 6]
    assert image_reward._text_mask_from_ids(ids, Sep()).tolist() == want
    assert jir._text_mask_from_ids(ids, Sep()).tolist() == want
    pads = np.array([[1, 2, 7, 7], [7, 2, 3, 4]])
    want = [[True, True, False, False], [True] * 4]
    assert image_reward._text_mask_from_ids(pads, Pad()).tolist() == want
    assert image_reward._text_mask_from_ids(pads, object()).all()


def test_image_reward_masked_positions_do_not_leak(ir_world):
    """Garbage in masked positions leaves the score as it was (1e-6); without
    the mask it changes it."""
    model = ir_world[2]
    images = torch.from_numpy(np.random.default_rng(7).uniform(size=(1, 3, 28, 28)).astype(np.float32))
    ids = torch.zeros((1, 12), dtype=torch.long)
    ids[0, :4] = torch.tensor([2, 50, 60, 3])
    garbage = ids.clone()
    garbage[0, 6:] = 123
    mask = torch.arange(12)[None] < 4
    with torch.inference_mode():
        a, b = model(images, ids, mask), model(images, garbage, mask)
        c, d = model(images, ids), model(images, garbage)
    torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
    assert abs(float(c[0]) - float(d[0])) > 1e-8


# ---------------------------------------------------------------------------
# Evaluators
# ---------------------------------------------------------------------------
def test_evaluators_calc_all_and_calc_inversion_match_jax(ir_world, tmp_path):
    """JAX's `make_random_evaluators` (tiny; its modules' inits traced and
    seeded) with the weights bridged into the port's `Evaluators`, plus the
    tiny ImageReward behind a BERT tokenizer on both sides: every key of
    `calc_all` and `calc_inversion` rtol 1e-4 / atol 1e-5; identical images
    give similarity 1 (numpy or tensor inputs)."""
    import flax.linen as nn

    init = nn.Module.init
    with pytest.MonkeyPatch.context() as mp:  # Flax's init runs op by op: seed a traced one
        mp.setattr(nn.Module, "init", lambda self, key, *args: seeded_params(
            jax.eval_shape(lambda: init(self, key, *args))))
        jev = jscores.make_random_evaluators()
    jmod, variables, model, _ = ir_world
    path = _vocab_file(tmp_path)
    jev.image_reward_fn = jir.make_image_reward_fn(jmod, variables, jtokenizer.BertWordPieceTokenizer(path))

    def port(module_cls, cfg, params):
        m = module_cls(cfg) if cfg is not None else module_cls()
        m.load_state_dict(params)
        return m.eval()
    vcfg = vit.ViTConfig(**dataclasses.asdict(jev.clip_vision[0].cfg))
    dcfg = vit.ViTConfig(**dataclasses.asdict(jev.dino[0].cfg))
    tcfg = jev.clip_text[0].cfg
    from invertible_cd_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel

    ev = scores.Evaluators(
        clip_vision=port(vit.ViTEncoder, vcfg, _bridge(jev.clip_vision[1])),
        clip_text=port(CLIPTextModel, CLIPTextConfig(**dataclasses.asdict(tcfg)),
                       convert.clip_state_dict_from_flax(jax.tree.map(np.asarray, jev.clip_text[1]))),
        clip_tokenizer=tokenizer.HashTokenizer(vocab_size=tcfg.vocab_size),
        dino=port(vit.ViTEncoder, dcfg, _bridge(jev.dino[1])),
        lpips=port(lpips.LPIPS, None, _bridge(jev.lpips[1])),
        image_reward_fn=image_reward.make_image_reward_fn(
            model, tokenizer.BertWordPieceTokenizer(path)),
        clip_size=28, dino_size=28)
    rng = np.random.default_rng(8)
    a, b = (rng.uniform(size=(1, 32, 32, 3)).astype(np.float32) for _ in range(2))
    src, tgt = ["a photo of a cat"], ["a photo of the dogs"]
    got, want = ev.calc_all(a, b, src, tgt), jev.calc_all(a, b, src, tgt)
    assert got.keys() == want.keys() and all(v is not None for v in got.values())
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=ATOL, err_msg=key)
    got, want = ev.calc_inversion(a, b), jev.calc_inversion(a, b)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=ATOL, err_msg=key)
    assert abs(ev.clip_image_image(a, torch.from_numpy(a)) - 1.0) < 1e-5  # tensors too
    assert abs(ev.dino_image_image(a, a) - 1.0) < 1e-5


def test_make_random_evaluators_tiny():
    """The port's seeded tiny evaluators: 28^2 ViT inputs as JAX patches
    them, ImageReward gated, identical images at similarity 1 (1e-5)."""
    ev = scores.make_random_evaluators(seed=1, device="cpu")
    assert ev.clip_size == ev.dino_size == 28 and ev.image_reward_fn is None
    a = np.random.default_rng(9).uniform(size=(1, 32, 32, 3)).astype(np.float32)
    out = ev.calc_all(a, a, ["a cat"], ["a dog"])
    assert out["editing_image_reward"] is None and -1 <= out["editing_clip_image_text"] <= 1
    assert abs(out["preservation_clip_image_image"] - 1) < 1e-5
    assert abs(out["preservation_dinov2"] - 1) < 1e-5

def test_scorers_compute_in_full_fp32(published, monkeypatch):
    """Every scorer's convolutions and matmuls, and `resize`, run with TF32
    off even where the caller allows it (PyTorch's cuDNN default is TF32 on;
    here matmuls are let down to bf16 too), and the caller's settings come
    back afterwards."""
    from invertible_cd_tpu_torch.utils.tokenizer import HashTokenizer

    modules, _ = published
    seen = {}

    def recorder(name):
        def record(*_):
            seen.setdefault(name, set()).add(
                (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()))
        return record

    hooks = [next(m for m in mod.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)))
             .register_forward_pre_hook(recorder(name)) for name, mod in modules.items()]
    matrix = resize._matrix
    monkeypatch.setattr(resize, "_matrix", lambda *a: recorder("resize")() or matrix(*a))
    ev = scores.Evaluators(
        clip_vision=modules["clip_vision"], clip_text=modules["clip_text"],
        clip_tokenizer=HashTokenizer(vocab_size=modules["clip_text"].cfg.vocab_size),
        dino=modules["dino"], lpips=modules["lpips"], clip_size=28, dino_size=28)
    x = np.random.default_rng(10).uniform(size=(1, 32, 32, 3)).astype(np.float32)
    saved = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("medium")
    try:
        ev.calc_all(x, x, ["a cat"], ["a dog"])
        ev.calc_inversion(x, x)
        FIDScorer(modules["inception"]).features([(x[0] * 255).astype(np.uint8)])
        with torch.inference_mode():
            modules["image_reward"](_nchw(x), torch.tensor([[2, 5, 3]]))
        outside = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
    finally:
        torch.backends.cudnn.allow_tf32, _ = saved
        torch.set_float32_matmul_precision(saved[1])
        for h in hooks:
            h.remove()
    assert set(seen) == set(modules) | {"resize"}
    assert all(states == {(False, "highest")} for states in seen.values()), seen
    assert outside == (True, "medium")


def test_evaluators_gate_missing_scorers():
    """A scorer without weights gives None under JAX's keys."""
    ev = scores.Evaluators()
    a = np.zeros((1, 8, 8, 3), np.float32)
    assert ev.calc_all(a, a, ["x"], ["y"]) == {
        "preservation_clip_image_image": None, "preservation_dinov2": None,
        "editing_clip_image_text": None, "editing_image_reward": None}
    out = ev.calc_inversion(a, a)
    assert out["dinov2"] is None and out["lpips"] is None and out["psnr"] > 100


# ---------------------------------------------------------------------------
# published checkpoints
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def published():
    """Seeded tiny scorers and their state dicts in the published formats."""
    modules = scores.scorer_modules(tiny=True, seed=9)
    return modules, testing.published_state_dicts(modules)


def _jax_side(flag, sd):
    """JAX's converter of the checkpoint behind `flag`, bridged to the port's keys."""
    if flag == "inception_weights":
        return _bridge(jconvert.convert_inception_weights(sd))
    if flag == "clip_vision_weights":
        return _bridge(jconvert.convert_clip_vision_from_transformers(sd))
    if flag == "clip_text_scorer_weights":
        return convert.clip_state_dict_from_flax(
            jax.tree.map(np.asarray, jconvert.convert_clip_text_from_transformers(sd)))
    if flag == "dino_weights":
        return _bridge(jconvert.convert_dinov2_weights(sd))
    return _bridge(jconvert.convert_image_reward_weights(sd))


@pytest.mark.parametrize("flag,name", [
    ("inception_weights", "inception"), ("clip_vision_weights", "clip_vision"),
    ("clip_text_scorer_weights", "clip_text"), ("dino_weights", "dino"),
    ("image_reward_weights", "image_reward"), ("lpips", "lpips")])
def test_published_converters_match_jax(published, flag, name):
    """Each published-format state dict (built here from seeded tiny
    modules, with the keys the loaders drop added): the port's converter
    gives the module's own state dict, bit for bit, and the same tensors as
    JAX's converter followed by the bridge."""
    modules, sds = published
    want = modules[name].state_dict()
    if flag == "lpips":
        vgg, heads = sds["vgg_weights"], sds["lpips_heads_weights"]
        got = convert.convert_lpips_weights(vgg, heads)
        jax_side = _bridge(jconvert.convert_lpips_weights(vgg, heads))
    else:
        sd = dict(sds[flag])
        extra = {"inception_weights": {"fc.weight": torch.zeros(2, 2), "AuxLogits.fc.bias": torch.zeros(2)},
                 "clip_vision_weights": {"vision_model.embeddings.position_ids": torch.zeros(1, 5)},
                 "clip_text_scorer_weights": {"text_model.embeddings.position_ids": torch.zeros(1, 77)},
                 "dino_weights": {},
                 "image_reward_weights": {"blip.text_encoder.embeddings.position_ids": torch.zeros(1, 5)}}
        sd.update(extra[flag])
        cfg = vit.ViTConfig.tiny()
        got = {"dino_weights": lambda s: convert.convert_dinov2_weights(s, cfg),
               "image_reward_weights": lambda s: convert.convert_image_reward_weights(s, cfg),
               "inception_weights": convert.convert_inception_weights,
               "clip_vision_weights": convert.convert_clip_vision_from_transformers,
               "clip_text_scorer_weights": convert.convert_clip_text_from_transformers}[flag](sd)
        jax_side = _jax_side(flag, {k: v for k, v in sd.items() if "position_ids" not in k})
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert jax_side.keys() == want.keys()
    assert all(torch.equal(jax_side[k], want[k]) for k in want)
