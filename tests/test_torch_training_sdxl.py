"""SDXL training in the PyTorch port against the JAX package, fp32 on the CPU:
the lazy train step with added conditioning at the tiny XL UNet of
`tests/test_training_sdxl.py` (rank 2), the lazy layer application itself,
the kohya-format inference export and the CLI's `--model sdxl` flags.

Both packages get the same numpy-seeded weights, non-zero adapters, batch
(with `added_cond`) and noise, and the guidance scales and timestep indices
that the JAX step draws from `jax.random.split(rng, 6)`. Tolerances are
stated at each comparison.
"""
import dataclasses
import json
import math
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

from invertible_cd_tpu.diffusion.schedule import make_schedule as j_make_schedule
from invertible_cd_tpu.diffusion.solver import make_train_solver as j_make_train_solver
from invertible_cd_tpu.models import UNet2DCondition as JUNet
from invertible_cd_tpu.models import UNetConfig as JUNetConfig
from invertible_cd_tpu.models.lora import _flatten_with_paths, find_lora_targets
from invertible_cd_tpu.training import trainer as JT
from invertible_cd_tpu.training.checkpoint import export_inference as j_export_inference
from invertible_cd_tpu.training.losses import LossConfig as JLossConfig
from invertible_cd_tpu_torch.cli import train_icd
from invertible_cd_tpu_torch.diffusion.schedule import make_schedule
from invertible_cd_tpu_torch.diffusion.solver import make_train_solver
from invertible_cd_tpu_torch.models import convert
from invertible_cd_tpu_torch.models.lora import (
    call_with_lora, call_with_state, lora_modules, merge_lora)
from invertible_cd_tpu_torch.models.unet2d import UNet2DCondition, UNetConfig
from invertible_cd_tpu_torch.training import ICDTrainState, LossConfig, TrainConfig, make_train_step
from invertible_cd_tpu_torch.training.checkpoint import export_inference, load_inference_lora
from invertible_cd_tpu_torch.training.trainer import init_optimizer

from _torch_jax_params import seeded_params, traced_init

RANK, B = 2, 2
ENDPOINTS, FORWARD_ENDPOINTS = "0,259,519,779", "259,519,779,999"
METRICS = (
    "reverse_cd_loss", "reverse_preserve_loss", "reverse_total_loss", "reverse_grad_norm",
    "forward_cd_loss", "forward_preserve_loss", "forward_total_loss", "forward_grad_norm",
)
# the UNet of tests/test_training_sdxl.py: no attention at level 0 (a
# stride-2 downsampler there), linear projections, added conditioning
XL_FIELDS = dict(
    block_out_channels=(16, 32), cross_attn_blocks=(False, True), layers_per_block=1,
    num_heads=(2, 2), transformer_depth=(1, 1), cross_attention_dim=32,
    use_linear_projection=True, time_cond_proj_dim=8, addition_embed_dim=16 + 6 * 8,
    addition_time_embed_dim=8,
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's tiny models (see
    `test_torch_baselines.py`): under the suite's parallel workers more
    threads oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(lora):
    return {f"{k}/{n}": t for k, ab in lora.items() for n, t in ab.items()}


@pytest.fixture(scope="module")
def world():
    """Both packages' tiny XL UNets on the same weights, and a non-zero
    adapter set per student (JAX tree and port dict)."""
    jcfg = JUNetConfig(**XL_FIELDS)
    junet = JUNet(jcfg)
    added = {"text_embeds": jnp.zeros((1, 16)), "time_ids": jnp.zeros((1, 6))}
    jbase = seeded_params(traced_init(
        junet, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 32)),
        jnp.zeros((1, 8)), added))

    leaves = dict(_flatten_with_paths(jbase["params"]))

    def lora(seed):
        """JAX's adapter tree for every target, drawn with numpy: down by the
        fan-in rule, up 0.03 N(0, 1), so that at scale alpha / r = 4 each
        adapted weight moves by about a tenth of the base's size. (At 0.3
        the adapters outweigh the base threefold, and four fp32 computations
        of the same step, JAX's lazy and merged ones and the port's, spread
        by 2.5e-3 on the reverse gradient norm: the huber loss's sign-like
        gradient, not the packages, sets that spread.)"""
        r = np.random.default_rng(seed)
        tree = {}
        for path in find_lora_targets(jbase["params"]):
            kernel = leaves[path]
            fan_in = int(np.prod(kernel.shape[:-1]))
            tree["/".join(path)] = {
                "down": (r.normal(size=kernel.shape[:-1] + (RANK,)) / fan_in**0.5).astype(np.float32),
                "up": (0.03 * r.normal(size=(RANK, kernel.shape[-1]))).astype(np.float32)}
        return tree
    unet = UNet2DCondition(UNetConfig(**XL_FIELDS)).eval().requires_grad_(False)
    base = convert.unet_state_dict_from_flax(_np_tree(jbase))
    unet.load_state_dict(base)
    jlora_r, jlora_f = lora(1), lora(2)
    return dict(jcfg=jcfg, junet=junet, jbase=jbase, jlora_r=jlora_r, jlora_f=jlora_f,
                unet=unet, base=base, lora_r=convert.lora_from_flax(jlora_r),
                lora_f=convert.lora_from_flax(jlora_f))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"latents": rng.normal(size=(B, 8, 8, 4)).astype(np.float32),
            "context": (0.1 * rng.normal(size=(B, 77, 32))).astype(np.float32),
            "noise": rng.normal(size=(B, 8, 8, 4)).astype(np.float32),
            "added_cond": {"text_embeds": rng.normal(size=(B, 16)).astype(np.float32),
                           "time_ids": np.tile(np.float32([[32, 32, 0, 0, 32, 32]]), (B, 1))}}


def _as(batch, fn):
    return {k: _as(v, fn) if isinstance(v, dict) else fn(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def both_steps(world):
    """One lazy step in each package from the same state, batch and draws:
    the one compiled JAX step of this file."""
    jcfg = JT.TrainConfig(lora_rank=RANK, lazy_lora=True, loss=JLossConfig(w_embed_dim=8))
    jschedule = j_make_schedule()
    jsolver = j_make_train_solver(
        np.asarray(jschedule.alphas_cumprod), num_endpoints=4, num_forward_endpoints=4,
        endpoints=ENDPOINTS, forward_endpoints=FORWARD_ENDPOINTS)
    jopt = JT.make_optimizer(jcfg)
    lora_r, lora_f = (jax.tree.map(jnp.asarray, world[n]) for n in ("jlora_r", "jlora_f"))
    jstate = JT.ICDTrainState(step=jnp.zeros((), jnp.int32), lora_reverse=lora_r, lora_forward=lora_f,
                              opt_reverse=jopt.init(lora_r), opt_forward=jopt.init(lora_f))
    batch = _batch()
    rng = jax.random.PRNGKey(5)
    _, k_w, k_r, k_f, k_fp, k_rp = jax.random.split(rng, 6)

    def index(key, n):
        return torch.from_numpy(np.asarray(jax.random.randint(key, (B,), 0, n)).astype(np.int64))
    draws = {
        "w": torch.from_numpy(np.array(JT.sample_w(k_w, B, jcfg))),
        "reverse_index": index(k_r, 50), "forward_index": index(k_f, 49),
        "forward_preserve_index": index(k_fp, 4), "reverse_preserve_index": index(k_rp, 4),
    }
    jstep = JT.make_train_step(world["junet"], world["jbase"], world["jbase"], jsolver, jschedule, jcfg)
    jnew, jmetrics = jstep(jstate, world["jbase"], world["jbase"], _as(batch, jnp.asarray), rng)
    want = {"metrics": {k: float(v) for k, v in jmetrics.items()},
            "lora_reverse": convert.lora_from_flax(_np_tree(jnew.lora_reverse)),
            "lora_forward": convert.lora_from_flax(_np_tree(jnew.lora_forward)),
            "mu_reverse": convert.lora_from_flax(_np_tree(jnew.opt_reverse[1][0].mu)),
            "mu_forward": convert.lora_from_flax(_np_tree(jnew.opt_forward[1][0].mu))}

    schedule = make_schedule()
    solver = make_train_solver(schedule.alphas_cumprod, num_endpoints=4, num_forward_endpoints=4,
                               endpoints=ENDPOINTS, forward_endpoints=FORWARD_ENDPOINTS)
    tcfg = TrainConfig(lora_rank=RANK, lazy_lora=True, loss=LossConfig(w_embed_dim=8))
    state = ICDTrainState(0, world["lora_r"], world["lora_f"], init_optimizer(world["lora_r"], tcfg),
                          init_optimizer(world["lora_f"], tcfg))
    base_before = {k: v.clone() for k, v in world["base"].items()}
    step_fn = make_train_step(world["unet"], world["base"], world["base"], solver, schedule, tcfg)
    new, metrics = step_fn(state, _as(batch, torch.from_numpy), None, draws)
    return dict(want=want, state=state, new=new, metrics=metrics, base_before=base_before,
                port=dict(schedule=schedule, solver=solver, tcfg=tcfg, batch=batch, draws=draws))


def test_lazy_xl_step_metrics_match_jax(both_steps):
    """Every metric within 1e-4 relative, the gradient norms within 1e-3."""
    got, want = both_steps["metrics"], both_steps["want"]["metrics"]
    assert sorted(got) == sorted(want) == sorted(METRICS)
    for name in METRICS:
        rtol = 1e-3 if name.endswith("grad_norm") else 1e-4
        np.testing.assert_allclose(float(got[name]), want[name], rtol=rtol, err_msg=name)
    assert both_steps["new"].step == 1


def test_lazy_xl_step_updates_match_jax(both_steps, world):
    """The tolerances of `test_full_step_updates_match_jax`: Adam's first
    moments (0.1 times the clipped gradients) within rtol 1e-3, atol 1e-4 *
    max |moment|; where the gradient is clear of Adam's epsilon (|g| >
    1e-5) the sign-like first move within atol 5e-7; every move at most lr.
    Every adapter gets a gradient, the downsampler's stride-2 convolution
    included, and the base weights stay as they were."""
    lr = 8e-6
    for student in ("reverse", "forward"):
        old = _flat(getattr(both_steps["state"], f"lora_{student}"))
        got = _flat(getattr(both_steps["new"], f"lora_{student}"))
        want = _flat(both_steps["want"][f"lora_{student}"])
        got_mu = _flat(getattr(both_steps["new"], f"opt_{student}")["mu"])
        want_mu = _flat(both_steps["want"][f"mu_{student}"])
        assert got.keys() == want.keys() == got_mu.keys()
        peak = max(float(m.abs().max()) for m in want_mu.values())
        assert peak > 1e-3
        for name in want:
            np.testing.assert_allclose(got_mu[name].numpy(), want_mu[name].numpy(), rtol=1e-3,
                                       atol=1e-4 * peak, err_msg=f"{student} mu {name}")
            move, want_move = got[name] - old[name], want[name] - old[name]
            clear = want_mu[name].abs() > 1e-6
            np.testing.assert_allclose(move[clear].numpy(), want_move[clear].numpy(), atol=5e-7,
                                       rtol=0, err_msg=f"{student} {name}")
            assert float(move.abs().max()) <= lr * 1.05
            assert bool(got_mu[name].any()), f"{student} {name}: no gradient"
    assert "down_blocks.0.downsamplers.0.conv.weight" in both_steps["new"].lora_reverse
    assert all(torch.equal(v, both_steps["base_before"][k]) for k, v in world["base"].items())


def test_lazy_xl_remat_and_merged_steps_agree(both_steps, world):
    """remat repeats the same fp32 operations (metrics rtol 1e-6, adapters
    atol 1e-9); the merged path computes the same function in another order
    (JAX's own `test_lazy_step_matches_merged_step` tolerance: 5e-4 +
    5e-4 |a| on every metric, 5e-5 on the updated adapters)."""
    p = both_steps["port"]

    def run(**kw):
        tcfg = dataclasses.replace(p["tcfg"], **kw)
        state = ICDTrainState(0, world["lora_r"], world["lora_f"],
                              init_optimizer(world["lora_r"], tcfg), init_optimizer(world["lora_f"], tcfg))
        fn = make_train_step(world["unet"], world["base"], world["base"], p["solver"], p["schedule"], tcfg)
        return fn(state, _as(p["batch"], torch.from_numpy), None, p["draws"])
    lazy_new, lazy_m = both_steps["new"], both_steps["metrics"]
    remat_new, remat_m = run(remat=True)
    merged_new, merged_m = run(lazy_lora=False)
    for name in METRICS:
        np.testing.assert_allclose(float(remat_m[name]), float(lazy_m[name]), rtol=1e-6, err_msg=name)
        a, b = float(merged_m[name]), float(lazy_m[name])
        assert abs(a - b) < 5e-4 + 5e-4 * abs(a), (name, a, b)
    for student in ("lora_reverse", "lora_forward"):
        for name, t in _flat(getattr(lazy_new, student)).items():
            np.testing.assert_allclose(_flat(getattr(remat_new, student))[name].numpy(), t.numpy(),
                                       rtol=0, atol=1e-9, err_msg=name)
            assert float((_flat(getattr(merged_new, student))[name] - t).abs().max()) < 5e-5, name


def test_call_with_lora_equals_the_merged_weights(world):
    """The lazy layer paths give the merged weights' output (fp32, atol
    1e-5 on O(1) outputs: the low-rank path sums in another order) and
    their gradients reach every adapter; an adapter key with no Linear or
    Conv2d weight behind it is an error, not a silent merge."""
    unet, base, lora = world["unet"], world["base"], world["lora_r"]
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 4, 8, 8)).astype(np.float32))
    ctx = torch.from_numpy((0.1 * rng.normal(size=(2, 77, 32))).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(2, 8)).astype(np.float32))
    added = {"text_embeds": torch.from_numpy(rng.normal(size=(2, 16)).astype(np.float32)),
             "time_ids": torch.tensor([[32.0, 32, 0, 0, 32, 32]] * 2)}
    t = torch.tensor([499, 999])
    scale = 8.0 / RANK
    want = call_with_state(unet, merge_lora(base, lora, alpha=8.0, rank=RANK), x, t, ctx,
                           w_cond=w, added_cond=added)
    leaves = {k: {n: v.clone().requires_grad_(True) for n, v in ab.items()} for k, ab in lora.items()}
    got = call_with_lora(unet, base, leaves, scale, x, t, ctx, w_cond=w, added_cond=added)
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), atol=1e-5, rtol=0)
    grads = torch.autograd.grad(got.square().sum(), [v for ab in leaves.values() for v in ab.values()])
    assert all(bool(g.any()) for g in grads)
    assert not any(m._forward_hooks for m in unet.modules())  # the hooks lived for the call only
    convs = [k for k, m in lora_modules(unet, lora).items() if isinstance(m, torch.nn.Conv2d)]
    assert "down_blocks.0.downsamplers.0.conv.weight" in convs and len(convs) >= 5
    for bad in ("conv_norm_out.weight", "no_such_block.to_q.weight", "conv_in.bias"):
        with pytest.raises(ValueError, match="LoRA key"):
            call_with_lora(unet, base, {bad: lora[convs[0]]}, scale, x, t, ctx, w_cond=w,
                           added_cond=added)


def test_export_matches_jax_file_for_file(world, tmp_path):
    """`export_inference` writes the JAX export's files, with its keys and
    arrays (bit for bit: both only transpose the same fp32 adapters), and
    `load_inference_lora` reads them back to the adapters."""
    j_export_inference(str(tmp_path / "jax"), types.SimpleNamespace(
        lora_reverse=world["jlora_r"], lora_forward=world["jlora_f"]), lora_alpha=8.0)
    state = ICDTrainState(3, world["lora_r"], world["lora_f"], {}, {})
    paths = export_inference(str(tmp_path / "port"), state, lora_alpha=8.0)

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, names in os.walk(root) for f in names)
    assert files(tmp_path / "port") == files(tmp_path / "jax") == [
        "forward_unet_lora/lora_weights.safetensors", "unet_lora/lora_weights.safetensors"]
    for name, lora in (("unet_lora", world["lora_r"]), ("forward_unet_lora", world["lora_f"])):
        got = load_file(paths[name])
        want = load_file(str(tmp_path / "jax" / name / "lora_weights.safetensors"))
        assert got.keys() == want.keys() and len(got) == 3 * len(lora)
        for key in want:
            assert got[key].dtype == want[key].dtype == np.float32, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        adapters, alphas = load_inference_lora(paths[name])
        assert adapters.keys() == lora.keys() and set(alphas.values()) == {8.0}
        for key, ab in lora.items():
            assert torch.equal(adapters[key]["down"], ab["down"]) and torch.equal(adapters[key]["up"], ab["up"])


def test_cli_sdxl_flags_without_building_the_unet(tmp_path):
    """--model sdxl takes SDXL's endpoint grids and UNet config, and the
    reference's SDXL config file loads as flag defaults; nothing here
    builds a module."""
    args = train_icd.parse_args(["--model", "sdxl", "--output_dir", "x", "--lazy_lora"])
    assert (args.endpoints, args.forward_endpoints) == ("0,249,499,699", "249,499,699,999")
    cfg = train_icd.unet_config("sdxl")
    assert cfg == UNetConfig.sdxl() and cfg.addition_embed_dim == 2816
    tcfg = train_icd.train_config(args, cfg)
    assert tcfg.lazy_lora and tcfg.loss.w_embed_dim == 512
    args = train_icd.parse_args(["--config", "configs/train_sdxl_lora.json", "--output_dir", "x"])
    with open("configs/train_sdxl_lora.json") as f:
        ref = json.load(f)
    assert (args.model, args.resolution, args.batch_size, args.lora_rank) == ("sdxl", 1024, 8, 64)
    assert (args.endpoints, args.forward_endpoints) == (ref["endpoints"], ref["forward_endpoints"])
    assert train_icd.train_config(args, cfg).discrete_w == tuple(
        float(w) for w in ref["discrete_w"].split(","))
    assert not args.lazy_lora and args.checkpoints_total_limit == 10
    # SD1.5 keeps its own grids; an explicit grid wins over the model's
    args = train_icd.parse_args(["--output_dir", "x", "--model", "sdxl", "--endpoints", "0,499"])
    assert args.endpoints == "0,499" and args.forward_endpoints == "249,499,699,999"
    assert train_icd.parse_args(["--output_dir", "x"]).endpoints == ENDPOINTS


def test_synthetic_sdxl_batches_carry_added_cond():
    """SDXL's synthetic batches: pooled embeds at scale 0.1 and time ids
    [r, r, 0, 0, r, r] beside the latents and contexts (tiny XL widths)."""
    args = train_icd.parse_args(["--model", "sdxl", "--synthetic_data", "--output_dir", "x",
                                 "--batch_size", "3", "--resolution", "64"])
    cfg = UNetConfig(**XL_FIELDS)
    batch = next(train_icd.batch_iterator(args, cfg, 8, "cpu"))
    assert batch["latents"].shape == (3, 8, 8, 4) and batch["context"].shape == (3, 77, 32)
    te, tid = batch["added_cond"]["text_embeds"], batch["added_cond"]["time_ids"]
    assert te.shape == (3, 16) and 0.03 < float(te.std()) < 0.3
    assert torch.equal(tid, torch.tensor([[64.0, 64, 0, 0, 64, 64]] * 3))
    again = next(train_icd.batch_iterator(args, cfg, 8, "cpu"))
    assert torch.equal(again["added_cond"]["text_embeds"], te)


def test_sdxl_eval_runs_with_added_cond(tmp_path, monkeypatch):
    """The train CLI's eval on an SDXL bundle (`train_icd.Eval` as `main`
    builds it, --lazy_lora, the encoder pipe's teacher the training UNet),
    here the tiny XL bundle at 16^2 pixels: the FID sweep, the inversion
    eval with recon-FID, the validation panel and the triptychs run with
    SDXL's added conditioning and give finite values, and that conditioning
    reaches the UNet: zeroing the val set's pooled embeddings moves the
    inversion MSE."""
    from invertible_cd_tpu_torch.metrics import FIDScorer
    from invertible_cd_tpu_torch.testing import tiny_bundle_xl
    from invertible_cd_tpu_torch.training import init_train_state
    from invertible_cd_tpu_torch.utils.logging import MetricLogger

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # the PNG sink
    feats = np.random.default_rng(3).normal(size=(8, 2048))
    np.savez(tmp_path / "stats.npz", mu=feats.mean(0), sigma=np.cov(feats, rowvar=False))
    args = train_icd.parse_args([
        "--model", "sdxl", "--lazy_lora", "--synthetic_data", "--lora_rank", "4",
        "--resolution", "16", "--output_dir", str(tmp_path), "--validation_prompts_max", "1",
        "--validation_batch", "2", "--inversion_validation_samples", "2",
        "--inversion_eval_samples", "2", "--fid_num_samples", "2",
        "--fid_prompts", "benchmarks/generation_coco_standin.csv",
        "--fid_stats", str(tmp_path / "stats.npz"), "--inception_weights", "seeded"])
    pipe = tiny_bundle_xl(None, latent_size=(8, 8))
    unet = pipe.unets["teacher"]
    schedule = make_schedule(device="cpu")
    solver = make_train_solver(
        schedule.alphas_cumprod, num_ddim_timesteps=args.num_ddim_timesteps,
        num_endpoints=4, num_forward_endpoints=4, endpoints=args.endpoints,
        forward_endpoints=args.forward_endpoints, device="cpu")
    tcfg = train_icd.train_config(args, unet.cfg)
    base = unet.state_dict()  # --lazy_lora: the adapters apply to the UNet's own tensors
    state = init_train_state(torch.Generator().manual_seed(1), base, tcfg)
    ev = train_icd.Eval(args, unet.cfg, 8, unet, base, tcfg, solver, lambda: pipe)
    ev._scorer = FIDScorer.random_init(seed=2, device="cpu")  # for --inception_weights
    logger = MetricLogger(str(tmp_path / "logs"))
    fid = ev.fid(state)
    inv = ev.inversion(state)
    ev.validation(logger, state, 1)
    panel_mse = ev.inversion_panels(logger, state, 1)
    logger.close()
    assert set(inv) == {"inversion_latent_mse", "inversion_fid"}
    assert all(math.isfinite(v) for v in (fid, panel_mse, *inv.values()))
    samples = sorted(os.listdir(tmp_path / "logs" / "samples"))
    assert samples[:2] == ["inversion_sample_0_1.png", "inversion_sample_1_1.png"]
    assert len(samples) == 3 and samples[2].startswith("validation_")
    rows = [json.loads(line) for line in open(tmp_path / "logs" / "metrics.jsonl")]
    assert {"validation_image_std", "inversion_panel_latent_mse"} <= set().union(*rows)
    ev._val["added_cond"]["text_embeds"].zero_()
    assert ev.inversion(state)["inversion_latent_mse"] != inv["inversion_latent_mse"]
