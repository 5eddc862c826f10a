"""The port's training eval, the eval flags of its CLIs and its image
utilities, against the JAX package where it has a counterpart, fp32 on the
CPU at the tiny configs.

The JAX tiny bundle gets numpy-seeded weights (no Flax init) and the port
its bridged copy; both run a 1-hop grid (one compiled JAX program of two
UNet calls: the forward hop, then the reverse hop). Noise and contexts come
from numpy, since torch generators and threefry differ (PARITY.md
divergence 4). Tolerances, stated at each comparison: the round trip's
latents atol 1e-4 / rtol 1e-3 (fp32 UNet calls summing in another order, as
`test_torch_pipeline.py` holds generation); the latent MSE over them 1e-4
relative.
"""
import dataclasses
import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
from PIL import Image

from invertible_cd_tpu import models as jmodels
from invertible_cd_tpu.diffusion import schedule as jschedule
from invertible_cd_tpu.diffusion import solver as jsolver
from invertible_cd_tpu.pipelines import sampler as jsampler
from invertible_cd_tpu.pipelines.pipeline import InvertibleCD as JInvertibleCD
from invertible_cd_tpu.training import eval as jeval
from invertible_cd_tpu.utils import images as jimages
from invertible_cd_tpu.utils import logging as jlogging
from invertible_cd_tpu.utils.tokenizer import HashTokenizer as JHashTokenizer
from invertible_cd_tpu_torch.cli import edit as edit_cli
from invertible_cd_tpu_torch.cli import generate as generate_cli
from invertible_cd_tpu_torch.cli import train_icd
from invertible_cd_tpu_torch.diffusion.schedule import make_schedule
from invertible_cd_tpu_torch.diffusion.solver import make_solver_grid, make_train_solver
from invertible_cd_tpu_torch.metrics import FIDScorer, frechet
from invertible_cd_tpu_torch.metrics import scores as port_scores
from invertible_cd_tpu_torch.models import convert
from invertible_cd_tpu_torch.models.layers import fan_in_init_
from invertible_cd_tpu_torch.models.lora import init_lora, seeded_lora
from invertible_cd_tpu_torch.models.unet2d import UNet2DCondition, UNetConfig
from invertible_cd_tpu_torch.testing import tiny_bundle, write_scorer_files
from invertible_cd_tpu_torch.training import eval as ev
from invertible_cd_tpu_torch.utils import images, logging, profiling

from _torch_jax_params import seeded_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
GRID = dict(reverse_timesteps=[999], forward_timesteps=[19])
ATOL, RTOL = 1e-4, 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's tiny models (see
    `test_torch_baselines.py`). One BLAS thread for numpy (the FID's
    eigendecompositions: on an 8-core CPU a 2048^2 `eigh` took 2.3 s on one
    OpenBLAS thread and 8-12 s on eight)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    """The train CLI's logger takes TensorBoard whenever it imports, and the
    import can pull in TensorFlow (~17 s); these tests read its PNG sink."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture(scope="module")
def jpipe():
    """The JAX tiny SD1.5 bundle with numpy-seeded weights on the 1-hop grid."""
    unet_cfg, clip_cfg = jmodels.UNetConfig.tiny(), jmodels.CLIPTextConfig.tiny()
    pipe = JInvertibleCD.sd15(dtype=jnp.float32, unet_cfg=unet_cfg, clip_cfg=clip_cfg,
                              vae_cfg=jmodels.VAEConfig.tiny(), latent_size=(16, 16),
                              tokenizer=JHashTokenizer(clip_cfg.vocab_size),
                              grid=jsolver.make_solver_grid(**GRID))
    return dataclasses.replace(pipe, params=seeded_params(pipe.params))


@pytest.fixture(scope="module")
def pipe(jpipe):
    port = tiny_bundle(convert.bundle_state_dicts_from_flax(jax.tree.map(np.asarray, jpipe.params)))
    port.grid = make_solver_grid(**GRID)
    return port


# ---------------------------------------------------------------------------
# training/eval.py
# ---------------------------------------------------------------------------
def test_grid_from_train_solver_matches_jax():
    schedule = make_schedule()
    jschedule_ = jschedule.make_schedule()
    for ep, fep in (("0,259,519,779", "259,519,779,999"), ("0,249,499,699", "249,499,699,999")):
        got = ev.grid_from_train_solver(make_train_solver(
            schedule.alphas_cumprod, num_endpoints=4, num_forward_endpoints=4, endpoints=ep,
            forward_endpoints=fep), start_timestep=19)
        want = jeval.grid_from_train_solver(jsolver.make_train_solver(
            np.asarray(jschedule_.alphas_cumprod), num_endpoints=4, num_forward_endpoints=4,
            endpoints=ep, forward_endpoints=fep), start_timestep=19)
        for field in dataclasses.fields(want):
            np.testing.assert_array_equal(getattr(got, field.name), getattr(want, field.name),
                                          err_msg=field.name)
    np.testing.assert_array_equal(got.reverse_timesteps, [999, 699, 499, 249])


def test_round_trip_and_eval_inversion_match_jax(jpipe, pipe):
    """`forward_sample` then `reverse_sample` (one hop each) with the
    bundle's students at guidance 0, and `eval_inversion` over 4 latents in chunks of 2, given
    the same latents, noise and contexts: latents atol 1e-4 / rtol 1e-3, the
    latent MSE 1e-4 relative."""
    rng = np.random.default_rng(0)
    latents = rng.normal(size=(4, 16, 16, 4)).astype(np.float32)
    noise = rng.normal(size=latents.shape).astype(np.float32)
    ctx = (0.1 * rng.normal(size=(4, 77, 32))).astype(np.float32)
    w_dim = pipe.w_embed_dim
    jg0 = jsampler.GuidanceConfig(guidance_scale=0.0, w_embed_dim=w_dim)

    @jax.jit
    def jround(p, lat, nz, c):
        noisy = jeval.forward_sample(jpipe._noise_model(p["forward"]), lat, nz, c, c, jpipe.grid,
                                     jpipe.schedule, w_embed_dim=w_dim)
        return noisy, jeval.reverse_sample(jpipe._noise_model(p["reverse"]), noisy, c, c,
                                           jpipe.grid, jpipe.schedule, jg0)

    cache, starts = {}, iter(range(0, 4, 2))

    def j_invert(chunk, key, c):
        i = next(starts)
        cache["noisy"], cache["recon"] = jround(jpipe.params, chunk, jnp.asarray(noise[i:i + 2]), c)
        return cache["noisy"]

    want = jeval.eval_inversion(j_invert, lambda noisy, key, c: cache["recon"], jnp.asarray(latents),
                                batch_size=2, val_context=jnp.asarray(ctx))
    g0 = pipe.default_guidance(guidance_scale=0.0)
    noises = iter([torch.from_numpy(noise[i:i + 2]) for i in range(0, 4, 2)])
    seeds = []

    def invert(chunk, gen, c):
        seeds.append(gen.initial_seed())
        return ev.forward_sample(pipe._noise_model(pipe.unets["forward"]), chunk, next(noises), c, c,
                                 pipe.grid, pipe.schedule, w_dim)

    def reconstruct(noisy, gen, c):
        return ev.reverse_sample(pipe._noise_model(pipe.unets["reverse"]), noisy, c, c, pipe.grid,
                                 pipe.schedule, g0)

    with torch.inference_mode():
        got = ev.eval_inversion(invert, reconstruct, torch.from_numpy(latents), batch_size=2,
                                val_context=torch.from_numpy(ctx))
        c = torch.from_numpy(ctx[2:])  # the last chunk once more, for its latents
        noisy = ev.forward_sample(pipe._noise_model(pipe.unets["forward"]), torch.from_numpy(latents[2:]),
                                  torch.from_numpy(noise[2:]), c, c, pipe.grid, pipe.schedule, w_dim)
        recon = reconstruct(noisy, None, c)
    assert seeds[:2] == [0, 2] and set(got) == set(want) == {"inversion_latent_mse"}
    np.testing.assert_allclose(noisy.numpy(), np.asarray(cache["noisy"]), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(recon.numpy(), np.asarray(cache["recon"]), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got["inversion_latent_mse"], want["inversion_latent_mse"], rtol=1e-4)


def test_sample_for_fid_matches_jax():
    """A sweep of 5 prompts in batches of 2 through a generate function of
    the prompts alone: the same uint8 images (truncated, as JAX's), in
    order; JAX pads the last batch, the port runs it at its own size, and
    batch i draws from seed `seed + i`."""
    prompts = [f"p{i}" for i in range(5)]

    def fake(batch):
        vals = np.array([int(p[1:]) for p in batch], np.float32)[:, None, None, None]
        return np.broadcast_to(vals / 4.0 - 0.2, (len(batch), 4, 4, 3)).astype(np.float32)

    seeds = []
    got = ev.sample_for_fid(lambda b, g: seeds.append(g.initial_seed()) or fake(b), prompts, 2,
                            seed=3, device="cpu")
    want = jeval.sample_for_fid(lambda b, key: fake(b), prompts, 2, seed=3)
    assert len(got) == len(want) == 5 and seeds == [3, 5, 7]
    for a, b in zip(got, want):
        assert a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    assert len(ev.sample_for_fid(lambda b, g: fake(b), prompts, 2, max_count=3, device="cpu")) == 3


def test_student_unet_lazy_equals_merged():
    """The adapters on the base: merged into a copy of the adapted weights,
    or applied per layer (`call_with_lora`): the same fp32 output within
    1e-5; the module's own weights unchanged."""
    unet = UNet2DCondition(UNetConfig.tiny()).eval().requires_grad_(False)
    fan_in_init_(unet, torch.Generator().manual_seed(0))
    base = {k: v.clone() for k, v in unet.state_dict().items()}
    lora = seeded_lora(base, torch.Generator().manual_seed(1), 4)
    x = torch.randn((2, 4, 8, 8), generator=torch.Generator().manual_seed(2))
    t, ctx = torch.tensor([999, 259]), 0.1 * torch.randn((2, 77, 32))
    w = torch.randn((2, UNetConfig.tiny().time_cond_proj_dim))
    with torch.inference_mode():
        merged = ev.student_unet(unet, base, lora, alpha=8.0)(x, t, ctx, w_cond=w)
        lazy = ev.student_unet(unet, base, lora, alpha=8.0, lazy=True)(x, t, ctx, w_cond=w)
        plain = unet(x, t, ctx, w_cond=w)
    torch.testing.assert_close(lazy, merged, atol=1e-5, rtol=1e-5)
    assert (merged - plain).abs().max() > 1e-3
    assert all(torch.equal(unet.state_dict()[k], base[k]) for k in base)


class PixelFID:
    """The Fréchet distance of raw pixels: a scorer with `FIDScorer.fid`'s
    signature and no network (the FID-Inception runs are tested apart)."""

    def fid(self, images, reference_images=None, reference_stats_path=None):
        def flat(x):  # every 4th pixel of each row and column: 192 values of a 32^2 image
            return np.stack(x)[:, ::4, ::4].reshape(len(x), -1) / 255.0
        return frechet.frechet_from_features(flat(images), flat(reference_images))


def test_fid_of_student_with_zero_adapters_is_zero_and_restores(pipe):
    """Adapters with up = 0 on the teacher against the teacher's own images
    (`sample_for_fid`, the same seeds): |FID| < 1e-2 (JAX's
    `tests/test_nti_eval.py` bound; here over pixels); the reverse UNet is
    the bundle's again afterwards, also when the sweep fails."""
    scorer = PixelFID()
    prompts = ["a cat", "a red fox"]
    reference = ev.sample_for_fid(
        lambda b, g: pipe.generate(list(b), generator=g, model="teacher")[0], prompts, 2,
        device="cpu")
    zero = init_lora(pipe.unets["teacher"].state_dict(), torch.Generator().manual_seed(0), rank=2)
    reverse = pipe.unets["reverse"]
    fid = ev.fid_of_student(pipe, zero, scorer, prompts, batch_size=2, reference_images=reference)
    assert abs(fid) < 1e-2 and pipe.unets["reverse"] is reverse
    with pytest.raises(ValueError):
        ev.fid_of_student(pipe, zero, scorer, prompts, batch_size=0, reference_images=reference)
    assert pipe.unets["reverse"] is reverse


# ---------------------------------------------------------------------------
# the train CLI's eval
# ---------------------------------------------------------------------------
def _png(path):
    with open(path, "rb") as f:
        assert f.read(8) == images.PNG_SIGNATURE
    return np.asarray(Image.open(path))


def test_train_cli_runs_every_eval(tmp_path):
    """`--model tiny` with every eval at step 2: the FID of the reverse
    student over 2 prompts, the inversion eval of 2 samples (latent MSE and
    recon-FID), one validation panel of 2 images and two triptychs; the
    metrics under JAX's names in metrics.jsonl and the panels as PNGs."""
    inception = str(tmp_path / "inception.pt")
    torch.save(FIDScorer.random_init(device="cpu").model.state_dict(), inception)
    feats = np.random.default_rng(0).normal(size=(8, 2048))
    stats = str(tmp_path / "stats.npz")
    np.savez(stats, mu=feats.mean(0), sigma=np.cov(feats, rowvar=False))
    out = tmp_path / "run"
    last = train_icd.main([
        "--model", "tiny", "--device", "cpu", "--synthetic_data", "--batch_size", "2",
        "--lora_rank", "4", "--max_steps", "2", "--output_dir", str(out),
        "--validation_steps", "2", "--validation_prompts_max", "1", "--validation_batch", "2",
        "--inversion_validation_samples", "2", "--inversion_eval_steps", "2",
        "--inversion_eval_samples", "2", "--evaluation_steps", "2", "--fid_num_samples", "2",
        "--fid_prompts", os.path.join(REPO, "benchmarks", "generation_coco_standin.csv"),
        "--fid_stats", stats, "--inception_weights", inception])
    assert math.isfinite(last["reverse_total_loss"])
    rows = [json.loads(line) for line in open(out / "logs" / "metrics.jsonl")]
    logged = {k: v for r in rows if r["step"] == 2 for k, v in r.items()}
    for key in ("eval/fid", "eval/inversion_latent_mse", "eval/inversion_fid",
                "validation_image_std", "inversion_panel_latent_mse"):
        assert key in logged and math.isfinite(logged[key]), key
    samples = sorted(os.listdir(out / "logs" / "samples"))
    assert samples[:2] == ["inversion_sample_0_2.png", "inversion_sample_1_2.png"]
    assert len(samples) == 3 and samples[2].startswith("validation_portrait photo of a girl")
    assert _png(out / "logs" / "samples" / samples[0]).shape == (16, 48, 3)  # 8^2 latents, 3 panels
    assert _png(out / "logs" / "samples" / samples[2]).shape == (32, 64, 3)  # 2 images of 32^2


def test_train_cli_base_params(tmp_path):
    """`--base_params`: a diffusers-keyed safetensors file of the tiny UNet,
    as `tools/make_synthetic_pack.py` writes its teacher, becomes the base
    and the teacher (the UNet's weights equal the file's)."""
    from safetensors.numpy import save_file

    unet = fan_in_init_(UNet2DCondition(UNetConfig.tiny()), torch.Generator().manual_seed(7))
    path = str(tmp_path / "teacher.safetensors")
    save_file({k: v.numpy() for k, v in unet.state_dict().items()}, path)
    args = train_icd.parse_args(["--model", "tiny", "--device", "cpu", "--output_dir", "x",
                                 "--base_params", path])
    got, _, base, _ = train_icd.build_models(args, torch.device("cpu"))
    for key, value in unet.state_dict().items():
        assert torch.equal(got.state_dict()[key], value) and torch.equal(base[key], value), key
    seeded, _, _, _ = train_icd.build_models(train_icd.parse_args(
        ["--model", "tiny", "--device", "cpu", "--output_dir", "x"]), torch.device("cpu"))
    assert not torch.equal(seeded.state_dict()["conv_in.weight"], unet.state_dict()["conv_in.weight"])
    last = train_icd.main(["--model", "tiny", "--device", "cpu", "--synthetic_data", "--batch_size",
                           "2", "--lora_rank", "4", "--max_steps", "1", "--validation_steps", "0",
                           "--base_params", path, "--output_dir", str(tmp_path / "run")])
    assert all(math.isfinite(v) for v in last.values())


def _config_keys(prefix):
    out = []
    for name in sorted(os.listdir(CONFIGS)):
        if name.startswith(prefix) and name.endswith(".json"):
            with open(os.path.join(CONFIGS, name)) as f:
                out.append((name, [k for k in json.load(f) if not k.startswith("_")]))
    return out


@pytest.mark.parametrize("cli,prefixes", [
    (train_icd, ("train_",)), (generate_cli, ("sd15_", "sdxl_")), (edit_cli, ("sd15_", "sdxl_"))])
def test_every_config_key_is_a_flag(cli, prefixes, tmp_path):
    """Every key of every `configs/*.json` is a flag of the parser its config
    is for (train_* -> cli.train_icd; sd15_* / sdxl_* -> cli.generate and
    cli.edit), so `--config` drops none; and the config sets it."""
    configs = [c for p in prefixes for c in _config_keys(p)]
    assert configs
    for name, keys in configs:
        path = os.path.join(CONFIGS, name)
        extra = ["--output_dir", "x"] if cli is train_icd else ["--out", "x"]
        args = cli.parse_args(["--config", path] + extra)
        with open(path) as f:
            cfg = json.load(f)
        for key in keys:
            assert hasattr(args, key), f"{name}: {key!r} is no flag of {cli.__name__}"
            want = cfg[key]
            assert getattr(args, key) == want, (name, key, getattr(args, key), want)



@pytest.mark.parametrize("config", ["sd15_icd_4step.json", "sdxl_icd_4step.json"])
def test_model_flags_are_checked_against_the_bundle(config):
    """The configs' model keys describe the bundle and change nothing in it:
    each config's values hold against its model's (the constructors' latent
    sizes and VAE, the UNet's guidance width, the grid's start, the seeded
    adapters), and a value the bundle does not have stops the CLI, here on
    the tiny bundle (32^2 pixels, w_embed_dim 8, start 19, rank 4, alpha 8)."""
    from types import SimpleNamespace

    from invertible_cd_tpu_torch.models.vae import VAEConfig

    args = generate_cli.parse_args(["--config", os.path.join(CONFIGS, config), "--out", "x"])
    xl = args.model == "sdxl"
    unet_cfg = UNetConfig.sdxl() if xl else UNetConfig.sd15()
    grid = make_solver_grid(n_steps=50, reverse_timesteps=args.reverse_timesteps,
                            forward_timesteps=args.forward_timesteps)
    full = SimpleNamespace(latent_size=(128, 128) if xl else (64, 64), grid=grid,
                           vae=SimpleNamespace(cfg=VAEConfig.sdxl() if xl else VAEConfig.sd()),
                           w_embed_dim=unet_cfg.time_cond_proj_dim)
    generate_cli.check_model_args(args, full)
    argv = ["--model", "tiny", "--device", "cpu", "--out", "x"]
    pipe = generate_cli.build_pipeline(generate_cli.parse_args(argv + [
        "--resolution", "32", "--w_embed_dim", "8", "--start_timestep", "19", "--lora_rank", "4",
        "--lora_alpha", "8"]))
    assert pipe.latent_size == (16, 16) and pipe.grid.start_timestep == 19
    for flag, value in (("resolution", "16"), ("w_embed_dim", "512"), ("start_timestep", "39"),
                        ("lora_rank", "64"), ("lora_alpha", "16")):
        with pytest.raises(SystemExit, match=f"--{flag} "):
            generate_cli.check_model_args(
                generate_cli.parse_args(argv + [f"--{flag}", value]), pipe)
    # a kohya file carries its own rank and alpha
    generate_cli.check_model_args(generate_cli.parse_args(
        argv + ["--reverse_lora", "r.safetensors", "--lora_rank", "64"]), pipe)


# ---------------------------------------------------------------------------
# --calc_metrics of the generate and edit CLIs
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def scorer_files(tmp_path_factory):
    """Seeded tiny scorers' files in the published formats (and the BERT
    vocab), and a seeded FID stats npz."""
    d = tmp_path_factory.mktemp("scorers")
    paths = write_scorer_files(str(d), tiny=True, seed=3)
    feats = np.random.default_rng(1).normal(size=(8, 2048))
    np.savez(str(d / "stats.npz"), mu=feats.mean(0), sigma=np.cov(feats, rowvar=False))
    return paths, str(d / "stats.npz")


@pytest.fixture(scope="module")
def scorer_flags(scorer_files):
    paths, stats = scorer_files
    return [f"--{k}={v}" for k, v in paths.items()] + [f"--fid_stats={stats}"]


def test_evaluators_from_weights_reads_the_files(scorer_files):
    """`evaluators_from_weights(tiny=True)` on `write_scorer_files`' files:
    every scorer holds the seeded weights; a missing file gates its metric."""
    paths = scorer_files[0]
    modules = port_scores.scorer_modules(tiny=True, seed=3)
    ev_ = port_scores.evaluators_from_weights(
        clip_vision_path=paths["clip_vision_weights"], clip_text_path=paths["clip_text_scorer_weights"],
        dino_path=paths["dino_weights"], vgg_path=paths["vgg_weights"],
        lpips_heads_path=paths["lpips_heads_weights"], image_reward_path=paths["image_reward_weights"],
        bert_vocab_path=paths["bert_vocab"], device="cpu", tiny=True)
    for name in ("clip_vision", "clip_text", "dino", "lpips"):
        got, want = getattr(ev_, name).state_dict(), modules[name].state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want), name
    assert ev_.clip_size == ev_.dino_size == 28 and ev_.image_reward_fn is not None
    fid = FIDScorer.from_state_dict(convert.convert_inception_weights(
        convert.load_torch_file(paths["inception_weights"])), device="cpu")
    want = modules["inception"].state_dict()
    assert all(torch.equal(fid.model.state_dict()[k], want[k]) for k in want)
    gated = port_scores.evaluators_from_weights(vgg_path=paths["vgg_weights"], device="cpu", tiny=True)
    assert gated.lpips is None and gated.clip_vision is None and gated.image_reward_fn is None


def test_generate_cli_calc_metrics(scorer_flags, tmp_path):
    """metrics.json under JAX's keys: finite CLIP score, ImageReward and FID
    with every scorer's weights; None and the note without them."""
    out = tmp_path / "gen"
    base = ["--model", "tiny", "--device", "cpu", "--prompt", "a cat", "--prompt", "a dog",
            "--prompt", "a fox", "--batch_size", "2", "--calc_metrics"]
    generate_cli.main(base + ["--out", str(out)] + scorer_flags)
    metrics = json.loads((out / "metrics.json").read_text())
    assert set(metrics) == {"clip_score", "image_reward", "n_images", "fid"}
    assert metrics["n_images"] == 3 and all(math.isfinite(v) for v in metrics.values())
    generate_cli.main(base + ["--out", str(tmp_path / "gated")])
    gated = json.loads((tmp_path / "gated" / "metrics.json").read_text())
    assert gated["clip_score"] is None and gated["image_reward"] is None and "metrics_note" in gated
    assert "fid" not in gated


def test_edit_cli_and_reconstruct_mode_calc_metrics(scorer_flags, tmp_path):
    """The edit CLI's `calc_all` means in results.json, and the generate
    CLI's invert/reconstruct mode's DINOv2, PSNR and LPIPS: all finite with
    every scorer's weights (recon-FID only with --fid_stats)."""
    rng = np.random.default_rng(2)
    Image.fromarray(rng.integers(0, 256, (40, 48, 3), np.uint8)).save(tmp_path / "img.png")
    out = tmp_path / "edit"
    edit_cli.main(["--model", "tiny", "--device", "cpu", "--image", str(tmp_path / "img.png"),
                   "--source", "a photo of a cat", "--target", "a photo of a dog", "--out", str(out),
                   "--calc_metrics"] + scorer_flags)
    summary = json.loads((out / "results.json").read_text())
    assert set(summary["metrics"]) == {"preservation_clip_image_image", "preservation_dinov2",
                                       "editing_clip_image_text", "editing_image_reward"}
    assert all(math.isfinite(v) for v in summary["metrics"].values()) and "metrics_note" not in summary
    (tmp_path / "bench.csv").write_text("file_name,caption\nimg.png,a photo of a cat\nimg.png,a cat\n")
    rec = tmp_path / "rec"
    no_fid = [f for f in scorer_flags if not f.startswith("--fid_stats")]  # FID: the generate test's
    generate_cli.main(["--model", "tiny", "--device", "cpu", "--benchmark", str(tmp_path / "bench.csv"),
                       "--image_root", str(tmp_path), "--out", str(rec), "--calc_metrics"] + no_fid)
    metrics = json.loads((rec / "reconstruction_metrics.json").read_text())
    assert set(metrics) == {"n_images", "dinov2", "psnr", "lpips"} and metrics["n_images"] == 2
    assert all(math.isfinite(v) for v in metrics.values())


# ---------------------------------------------------------------------------
# utils
# ---------------------------------------------------------------------------
def test_image_grid_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    stack = rng.uniform(size=(5, 10, 12, 3)).astype(np.float32)
    u8 = [rng.integers(0, 256, (8, 8, 3), np.uint8) for _ in range(3)]
    for imgs, rows, ratio in ((stack, 2, 0.1), (u8, 1, 0.02), (u8[0], 1, 0.0), (list(stack), 3, 0.3)):
        np.testing.assert_array_equal(images.image_grid(imgs, rows, ratio),
                                      jimages.image_grid(imgs, rows, ratio))
    with pytest.raises(ValueError):
        images.image_grid([])
    grid = images.image_grid(stack, 2, 0.1)
    assert np.array_equal(np.asarray(images.to_pil_images(stack, 2, 0.1)), grid)
    images.view_images(stack, 2, 0.1, save_path=str(tmp_path / "grid.png"))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "grid.png")), grid)


def test_metric_logger_writes_jax_rows_and_panels(tmp_path):
    """The same JSONL row keys and the same panel pixels as JAX's logger on
    its PNG path (a PNG of the images side by side, truncated to uint8)."""
    arr = np.random.default_rng(4).uniform(size=(2, 6, 5, 3)).astype(np.float32)
    port = logging.MetricLogger(str(tmp_path / "port"))
    jax_log = jlogging.MetricLogger(str(tmp_path / "jax"), use_tensorboard=False)
    for logger in (port, jax_log):
        logger.log(3, {"a": torch.tensor(1.5), "b": 2, "skip": "text"}, prefix="eval/")
        logger.log_images(3, "validation/a cat", arr)
        logger.close()
    rows = [json.loads((tmp_path / d / "metrics.jsonl").read_text()) for d in ("port", "jax")]
    assert rows[0].keys() == rows[1].keys() == {"step", "time", "eval/a", "eval/b"}
    assert rows[0]["eval/a"] == rows[1]["eval/a"] == 1.5
    got = _png(tmp_path / "port" / "samples" / "validation_a cat_3.png")
    want = np.asarray(Image.open(tmp_path / "jax" / "samples" / "validation_a cat_3.png"))
    np.testing.assert_array_equal(got, want)


def test_metric_logger_tensorboard_sink(tmp_path, monkeypatch):
    """As in JAX, the logger sends every scalar and panel to a
    `SummaryWriter` whenever `torch.utils.tensorboard` imports (faked here),
    panels NCHW as TensorBoard takes them and no PNG; without the module the
    panels are PNG files."""
    import types

    calls = []

    class Writer:
        def __init__(self, log_dir):
            calls.append(("init", log_dir))

        def add_scalar(self, tag, value, step):
            calls.append(("scalar", tag, value, step))

        def add_images(self, tag, images, step):
            calls.append(("images", tag, images.shape, step))

        def close(self):
            calls.append(("close",))

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", types.SimpleNamespace(SummaryWriter=Writer))
    logger = logging.MetricLogger(str(tmp_path / "tb"))
    logger.log(2, {"loss": 0.5}, prefix="train/")
    assert logger.log_images(2, "inversion/sample_0", np.zeros((3, 4, 5, 3), np.float32)) is None
    logger.close()
    assert calls == [("init", str(tmp_path / "tb")), ("scalar", "train/loss", 0.5, 2),
                     ("images", "inversion/sample_0", (3, 3, 4, 5), 2), ("close",)]
    assert not (tmp_path / "tb" / "samples").exists()
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # import fails
    logger = logging.MetricLogger(str(tmp_path / "none"))
    path = logger.log_images(2, "inversion/sample_0", np.zeros((3, 4, 5, 3), np.float32))
    logger.close()
    assert _png(path).shape == (4, 15, 3)

def test_stage_timer():
    timer = profiling.StageTimer()
    for _ in range(2):
        with timer.stage("a"):
            timer.result({"x": [torch.ones(2)]})
    with timer.stage("b"):
        pass
    summary = timer.summary()
    assert set(summary) == {"a", "b"} and timer.counts == {"a": 2, "b": 1}
    assert all(v >= 0 for v in summary.values())
