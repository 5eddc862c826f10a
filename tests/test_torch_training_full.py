"""The port's training losses against the reference's transcription, and one
full-width SD1.5 train step against the JAX package's.

The first part needs no JAX: `training/losses.py` against
`tests/_torch_train_ref.py` (the reference's `train.py` transcribed, the
oracle of `tests/test_losses_differential.py`), on stub denoisers that are
parameterised differently per role, so a loss that calls the wrong model
fails. Tolerance: atol 2e-5 / rtol 1e-5 on the loss (fp32, the same
operations; the schedule tables differ by ~5e-7).

The second part (`slow`) runs one four-loss step of `make_train_step` at the
full SD1.5 UNet width in fp32 on the CPU in both packages, on the teacher of
`tools/make_synthetic_pack.py ensure_weights` (written into the git-ignored
`tests/golden/synth_sd15/` when absent), the same rank-4 adapters with
non-zero ups, batch and draws: every metric, and the clipped adapter
gradients (Adam's first moment), within a relative max error of 5e-3, and
the adapters' updates agreeing in sign on >= 99% of the entries whose
gradient is clear of Adam's epsilon (the limits of
`test_torch_baselines.py`'s full-width NTI check). Latents are 16^2: the
widths are full, the spatial size is cut (860M parameters, 11 UNet forwards
and 4 backwards a step, fp32, in each package).
"""
import os

import numpy as np
import pytest
import torch

import _torch_train_ref as R
from invertible_cd_tpu_torch.diffusion.schedule import make_schedule
from invertible_cd_tpu_torch.diffusion.solver import make_train_solver
from invertible_cd_tpu_torch.training.losses import (
    LossConfig, forward_cd_loss, forward_preserve_loss, reverse_cd_loss, reverse_preserve_loss)

B = 4


def _stub(a, b, ct, cw):
    """An elementwise denoiser with per-batch scalars of t and w."""
    def stub(x, t, w_emb):
        wm = 0.0 if w_emb is None else w_emb.float().mean(dim=-1)
        bias = ct * torch.cos(t.float() / 1000.0) + cw * wm
        return a * x + b * torch.sin(2.0 * x) + bias.reshape(-1, 1, 1, 1)
    return stub


STUDENT, TEACHER = _stub(0.30, 0.10, 0.05, 0.02), _stub(0.25, 0.15, 0.04, 0.01)
FORWARD, REVERSE = _stub(0.20, 0.12, 0.03, 0.015), _stub(0.35, 0.08, 0.06, 0.025)


def _apply(stub):
    """The stub as the port's losses call a model: (params, x, t, w_emb)."""
    return lambda params, x, t, w_emb: stub(x, t, w_emb)


def _in_order(*stubs):
    """One stub for the oracle's sequence of calls, routing call i to stubs[i]
    (the last one takes every call after)."""
    calls = iter(range(10**6))

    def stub(x, t, w_emb):
        return stubs[min(next(calls), len(stubs) - 1)](x, t, w_emb)
    return stub


def _inputs(seed):
    rng = np.random.default_rng(seed)
    latents, noise = (torch.from_numpy(rng.normal(size=(B, 4, 8, 8)).astype(np.float32))
                      for _ in range(2))
    return rng, latents, noise


def _solvers(endpoints="0,259,519,779", forward_endpoints="259,519,779,999"):
    schedule = make_schedule()
    solver = make_train_solver(schedule.alphas_cumprod, num_endpoints=len(endpoints.split(",")),
                               num_forward_endpoints=len(forward_endpoints.split(",")),
                               endpoints=endpoints, forward_endpoints=forward_endpoints)
    ac = R.make_alphas_cumprod()
    return schedule, solver, ac, R.DDIMSolver(ac, endpoints=endpoints,
                                               forward_endpoints=forward_endpoints)


@pytest.mark.parametrize("embed_guidance", [True, False])
def test_reverse_cd_loss_matches_the_reference(embed_guidance):
    rng, latents, noise = _inputs(7)
    schedule, solver, ac, tsolver = _solvers()
    w = torch.tensor([0.0, 7.0, 11.0, 19.0])
    index = torch.from_numpy(rng.integers(0, 50, B))
    got, logs = reverse_cd_loss(
        _apply(STUDENT), None, _apply(TEACHER), None, latents, noise, w, None, solver, schedule,
        LossConfig(embed_guidance=embed_guidance),
        uncond_apply=None if embed_guidance else _apply(TEACHER), index=index)
    # the oracle calls: student, teacher (cond), [teacher (uncond)], student (target)
    oracle = _in_order(STUDENT, *([TEACHER] * (1 if embed_guidance else 2)), STUDENT)
    want = R.reverse_train_loss(oracle, latents, noise, w, index, tsolver, ac,
                                embed_guidance=embed_guidance)
    np.testing.assert_allclose(float(got), float(want), atol=2e-5, rtol=1e-5)
    assert float(logs["reverse_cd_loss"]) == float(got)


def test_forward_cd_loss_matches_the_reference():
    rng, latents, noise = _inputs(13)
    schedule, solver, ac, tsolver = _solvers()
    w = torch.zeros(B)
    index = torch.from_numpy(rng.integers(0, 49, B))
    got, _ = forward_cd_loss(_apply(STUDENT), None, _apply(TEACHER), None, latents, noise, w, None,
                             solver, schedule, LossConfig(), index=index)
    want = R.forward_train_loss(_in_order(STUDENT, TEACHER, STUDENT), latents, noise, w, index,
                                tsolver, ac)
    np.testing.assert_allclose(float(got), float(want), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("endpoints,forward_endpoints", [
    ("0,259,519,779", "259,519,779,999"),  # one reverse hop in the rollout
    ("0,259,519,779", "519,999"),          # two
])
@pytest.mark.parametrize("which", ["forward", "reverse"])
def test_preserve_losses_match_the_reference(which, endpoints, forward_endpoints):
    rng, latents, noise = _inputs(17 if which == "forward" else 19)
    schedule, solver, ac, tsolver = _solvers(endpoints, forward_endpoints)
    n_f = len(forward_endpoints.split(","))
    endpoint_index = torch.from_numpy(rng.integers(0, n_f, B))
    if which == "forward":
        got, _ = forward_preserve_loss(_apply(FORWARD), None, _apply(REVERSE), None, latents, noise,
                                       None, solver, schedule, LossConfig(),
                                       endpoint_index=endpoint_index)
        want = R.forward_preserve_loss(FORWARD, REVERSE, latents, noise, endpoint_index, tsolver, ac)
    else:
        got, _ = reverse_preserve_loss(_apply(FORWARD), None, _apply(REVERSE), None, latents, noise,
                                       None, solver, schedule, LossConfig(), remat=False,
                                       endpoint_index=endpoint_index)
        want = R.reverse_preserve_loss(FORWARD, REVERSE, latents, noise, endpoint_index, tsolver, ac)
    np.testing.assert_allclose(float(got), float(want), atol=2e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# one full-width step against the JAX package
# ---------------------------------------------------------------------------
FULL_WEIGHTS = os.path.join(os.path.dirname(__file__), "golden", "synth_sd15")
FULL_TOL = 5e-3  # max abs error over max |want|
RANK = 4


def _full_close(got, want, msg):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
    assert err <= FULL_TOL, f"{msg}: relative max error {err:.3e}"


@pytest.mark.slow  # full 860M shapes on the CPU, in both packages
def test_full_width_train_step_matches_jax():
    import sys

    import jax
    import jax.numpy as jnp

    from invertible_cd_tpu.diffusion.schedule import make_schedule as j_make_schedule
    from invertible_cd_tpu.diffusion.solver import make_train_solver as j_make_train_solver
    from invertible_cd_tpu.models import UNet2DCondition as JUNet
    from invertible_cd_tpu.models import UNetConfig as JUNetConfig
    from invertible_cd_tpu.models.lora import init_lora as j_init_lora
    from invertible_cd_tpu.pipelines.loading import load_bundle_params as jload_bundle_params
    from invertible_cd_tpu.training import trainer as JT
    from invertible_cd_tpu.training.losses import LossConfig as JLossConfig
    from invertible_cd_tpu_torch.models import convert
    from invertible_cd_tpu_torch.models.unet2d import UNet2DCondition, UNetConfig
    from invertible_cd_tpu_torch.pipelines.loading import load_bundle_params
    from invertible_cd_tpu_torch.training import TrainConfig, make_train_step
    from invertible_cd_tpu_torch.training.trainer import ICDTrainState, init_optimizer

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    from make_synthetic_pack import ensure_weights

    ensure_weights(FULL_WEIGHTS)
    teacher = os.path.join(FULL_WEIGHTS, "teacher.safetensors")
    endpoints, forward_endpoints = "0,259,519,779", "259,519,779,999"

    # ---- JAX: the teacher as base and teacher, rank-4 adapters with non-zero ups ----
    jcfg = JUNetConfig.sd15()
    jbase = jload_bundle_params(teacher=teacher)["teacher"]
    jbase = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), jbase)

    def lora(seed):
        tree = jax.tree.map(np.asarray, j_init_lora(jax.random.PRNGKey(seed), jbase["params"], rank=RANK))
        r = np.random.default_rng(seed)
        return {k: {"down": v["down"], "up": (0.03 * r.normal(size=v["up"].shape)).astype(np.float32)}
                for k, v in tree.items()}
    lora_r, lora_f = lora(1), lora(2)
    jtcfg = JT.TrainConfig(lora_rank=RANK, loss=JLossConfig(w_embed_dim=jcfg.time_cond_proj_dim))
    jschedule = j_make_schedule()
    jsolver = j_make_train_solver(np.asarray(jschedule.alphas_cumprod), num_endpoints=4,
                                  num_forward_endpoints=4, endpoints=endpoints,
                                  forward_endpoints=forward_endpoints)
    jopt = JT.make_optimizer(jtcfg)
    jlr, jlf = (jax.tree.map(jnp.asarray, t) for t in (lora_r, lora_f))
    jstate = JT.ICDTrainState(step=jnp.zeros((), jnp.int32), lora_reverse=jlr, lora_forward=jlf,
                              opt_reverse=jopt.init(jlr), opt_forward=jopt.init(jlf))
    rng = np.random.default_rng(3)
    batch = {"latents": rng.normal(size=(1, 16, 16, 4)).astype(np.float32),
             "context": (0.1 * rng.normal(size=(1, 77, jcfg.cross_attention_dim))).astype(np.float32),
             "noise": rng.normal(size=(1, 16, 16, 4)).astype(np.float32)}
    key = jax.random.PRNGKey(5)
    _, k_w, k_r, k_f, k_fp, k_rp = jax.random.split(key, 6)

    def index(k, n):
        return torch.from_numpy(np.asarray(jax.random.randint(k, (1,), 0, n)).astype(np.int64))
    draws = {"w": torch.from_numpy(np.array(JT.sample_w(k_w, 1, jtcfg))),
             "reverse_index": index(k_r, 50), "forward_index": index(k_f, 49),
             "forward_preserve_index": index(k_fp, 4), "reverse_preserve_index": index(k_rp, 4)}
    jstep = JT.make_train_step(JUNet(jcfg), jbase, jbase, jsolver, jschedule, jtcfg)
    jnew, jmetrics = jstep(jstate, jbase, jbase, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    want_metrics = {k: float(v) for k, v in jmetrics.items()}
    want = {name: convert.lora_from_flax(jax.tree.map(np.asarray, tree)) for name, tree in (
        ("lora_reverse", jnew.lora_reverse), ("lora_forward", jnew.lora_forward),
        ("mu_reverse", jnew.opt_reverse[1][0].mu), ("mu_forward", jnew.opt_forward[1][0].mu))}
    del jnew, jstate, jstep, jbase

    # ---- the port: the same teacher file, adapters, batch and draws ----
    unet = UNet2DCondition(UNetConfig.sd15()).eval().requires_grad_(False)
    base = load_bundle_params(teacher=teacher)["teacher"]
    unet.load_state_dict(base)
    base = unet.state_dict()
    tcfg = TrainConfig(lora_rank=RANK, loss=LossConfig(w_embed_dim=unet.cfg.time_cond_proj_dim))
    schedule = make_schedule()
    solver = make_train_solver(schedule.alphas_cumprod, num_endpoints=4, num_forward_endpoints=4,
                               endpoints=endpoints, forward_endpoints=forward_endpoints)
    port_r, port_f = convert.lora_from_flax(lora_r), convert.lora_from_flax(lora_f)
    state = ICDTrainState(0, port_r, port_f, init_optimizer(port_r, tcfg), init_optimizer(port_f, tcfg))
    step_fn = make_train_step(unet, base, base, solver, schedule, tcfg)
    new, metrics = step_fn(state, {k: torch.from_numpy(v) for k, v in batch.items()}, None, draws)

    assert sorted(metrics) == sorted(want_metrics)
    for name, value in want_metrics.items():
        _full_close(float(metrics[name]), value, name)
    for student in ("reverse", "forward"):
        got_mu, want_mu = getattr(new, f"opt_{student}")["mu"], want[f"mu_{student}"]
        old = getattr(state, f"lora_{student}")
        _full_close(np.concatenate([got_mu[k][n].numpy().ravel() for k in want_mu for n in ("down", "up")]),
                    np.concatenate([want_mu[k][n].numpy().ravel() for k in want_mu for n in ("down", "up")]),
                    f"the {student} student's clipped gradients")
        # Adam's first update is lr * g / (|g| + eps): sign-like where |g| is
        # clear of eps (|mu| = 0.1 |g| > 1e-6), as test_torch_training.py holds it
        clear = np.concatenate([want_mu[k][n].numpy().ravel() for k in want_mu
                                for n in ("down", "up")])
        clear = np.abs(clear) > 1e-6
        moves, want_moves = (np.concatenate([(lora[k][n] - old[k][n]).numpy().ravel()
                                             for k in want_mu for n in ("down", "up")])
                             for lora in (getattr(new, f"lora_{student}"), want[f"lora_{student}"]))
        agree = np.mean(np.sign(moves[clear]) == np.sign(want_moves[clear]))
        assert clear.mean() > 0.5 and agree >= 0.99, (
            f"{student}: update signs agree on {agree:.4f} of the {clear.sum()} clear entries")
