"""The trainer of the PyTorch port against the JAX package, fp32 on the CPU,
at the tiny UNet: adapter init and the adapter bridge, the written-out
optimizer against optax, one full four-loss step against the JAX package's
compiled step, remat, checkpoints and the CLI.

The full step gives both packages the same bridged weights and non-zero
adapters, the same numpy batch and noise, and the guidance scales and
timestep indices that the JAX step draws from `jax.random.split(rng, 6)`.
Tolerances are stated at each comparison.
"""
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from invertible_cd_tpu.diffusion.schedule import make_schedule as j_make_schedule
from invertible_cd_tpu.diffusion.solver import make_train_solver as j_make_train_solver
from invertible_cd_tpu.models import UNet2DCondition as JUNet
from invertible_cd_tpu.models import UNetConfig as JUNetConfig
from invertible_cd_tpu.models.lora import init_lora as j_init_lora
from invertible_cd_tpu.models.lora import merge_lora as j_merge_lora
from invertible_cd_tpu.training import trainer as JT
from invertible_cd_tpu.training.losses import LossConfig as JLossConfig
from invertible_cd_tpu_torch.cli import train_icd
from invertible_cd_tpu_torch.diffusion.schedule import make_schedule
from invertible_cd_tpu_torch.diffusion.solver import make_train_solver
from invertible_cd_tpu_torch.models import convert
from invertible_cd_tpu_torch.models.lora import init_lora, merge_lora
from invertible_cd_tpu_torch.models.unet2d import UNet2DCondition, UNetConfig
from invertible_cd_tpu_torch.training import (
    ICDTrainState, LossConfig, TrainConfig, init_train_state, make_optimizer,
    make_train_step, sample_w,
)
from invertible_cd_tpu_torch.training.checkpoint import (
    latest_step, restore_checkpoint, save_checkpoint,
)
from invertible_cd_tpu_torch.training.trainer import init_optimizer

from _torch_dist import Ranks
from _torch_jax_params import seeded_params, traced_init

ENDPOINTS, FORWARD_ENDPOINTS = "0,259,519,779", "259,519,779,999"
RANK, B = 4, 2
METRICS = (
    "reverse_cd_loss", "reverse_preserve_loss", "reverse_total_loss", "reverse_grad_norm",
    "forward_cd_loss", "forward_preserve_loss", "forward_total_loss", "forward_grad_norm",
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


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    """The train CLI's logger takes TensorBoard whenever it imports, and the
    import can pull in TensorFlow (~17 s); these tests read its PNG sink."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


# one compiled init of the adapters (its random draws are the eager init's bits)
_init_lora = jax.jit(j_init_lora, static_argnames="rank")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(lora):
    return {f"{k}/{n}": t for k, ab in lora.items() for n, t in ab.items()}


@pytest.fixture(scope="module")
def jax_world():
    """The JAX tiny UNet, its weights and a non-zero adapter tree per student."""
    jcfg = JUNetConfig.tiny()
    junet = JUNet(jcfg)
    jbase = seeded_params(traced_init(  # numpy-seeded weights: Flax's init runs op by op
        junet, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 77, jcfg.cross_attention_dim)), jnp.zeros((1, jcfg.time_cond_proj_dim))))

    def lora(seed):
        tree = _np_tree(_init_lora(jax.random.PRNGKey(seed), jbase["params"], rank=RANK))
        r = np.random.default_rng(seed)
        return {k: {"down": v["down"],
                    "up": (0.3 * r.normal(size=v["up"].shape)).astype(np.float32)}
                for k, v in tree.items()}
    return dict(cfg=jcfg, unet=junet, base=jbase, lora_r=lora(1), lora_f=lora(2))


@pytest.fixture(scope="module")
def port_world(jax_world):
    unet = UNet2DCondition(UNetConfig.tiny()).eval().requires_grad_(False)
    base = convert.unet_state_dict_from_flax(_np_tree(jax_world["base"]))
    unet.load_state_dict(base)
    schedule = make_schedule()
    solver = make_train_solver(
        schedule.alphas_cumprod, num_endpoints=4, num_forward_endpoints=4,
        endpoints=ENDPOINTS, forward_endpoints=FORWARD_ENDPOINTS)
    tcfg = TrainConfig(lora_rank=RANK, loss=LossConfig(w_embed_dim=unet.cfg.time_cond_proj_dim))
    return dict(unet=unet, base=base, schedule=schedule, solver=solver, tcfg=tcfg)


def _port_state(jax_world, tcfg) -> ICDTrainState:
    lora_r = convert.lora_from_flax(jax_world["lora_r"])
    lora_f = convert.lora_from_flax(jax_world["lora_f"])
    return ICDTrainState(0, lora_r, lora_f, init_optimizer(lora_r, tcfg), init_optimizer(lora_f, tcfg))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"latents": rng.normal(size=(B, 8, 8, 4)).astype(np.float32),
            "context": (0.1 * rng.normal(size=(B, 77, 32))).astype(np.float32),
            "noise": rng.normal(size=(B, 8, 8, 4)).astype(np.float32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# adapters
# ---------------------------------------------------------------------------
def test_init_lora_targets_shapes_and_zero_up(jax_world, port_world):
    want = convert.lora_from_flax(
        _np_tree(_init_lora(jax.random.PRNGKey(0), jax_world["base"]["params"], rank=RANK)))
    got = init_lora(port_world["base"], torch.Generator().manual_seed(0), rank=RANK)
    assert sorted(got) == sorted(want) and len(got) > 50
    for key, ab in got.items():
        assert ab["down"].shape == want[key]["down"].shape, key
        assert ab["up"].shape == want[key]["up"].shape, key
        assert ab["down"].dtype == ab["up"].dtype == torch.float32
        assert not ab["up"].any() and not want[key]["up"].any()
        assert ab["down"].shape[0] == RANK and ab["up"].shape == (port_world["base"][key].shape[0], RANK)
    # fan-in rule: std of down is 1/sqrt(fan_in); pooled over a wide layer it shows
    key = max(got, key=lambda k: got[k]["down"].numel())
    fan_in = port_world["base"][key][0].numel()
    assert abs(float(got[key]["down"].std()) * fan_in**0.5 - 1.0) < 0.1
    # the same seed gives the same adapters, another seed others
    again = init_lora(port_world["base"], torch.Generator().manual_seed(0), rank=RANK)
    other = init_lora(port_world["base"], torch.Generator().manual_seed(1), rank=RANK)
    assert all(torch.equal(again[k]["down"], got[k]["down"]) for k in got)
    assert not all(torch.equal(other[k]["down"], got[k]["down"]) for k in got)


def test_lora_from_flax_merges_to_the_same_weights(jax_world, port_world):
    """Bridging the adapters and merging here equals merging in JAX and
    bridging the merged weights (atol 1e-6: one fp32 product per element,
    summed over the rank in another order)."""
    jlora = jax_world["lora_r"]
    want = convert.unet_state_dict_from_flax(
        _np_tree(j_merge_lora(jax_world["base"]["params"], jlora, rank=RANK)))
    lora = convert.lora_from_flax(jlora)
    got = merge_lora(port_world["base"], lora, rank=RANK)
    assert got.keys() == want.keys()
    changed = 0
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), atol=1e-6, rtol=1e-6,
                                   err_msg=key)
        changed += not torch.equal(got[key], port_world["base"][key])
    assert changed == len(lora)
    with pytest.raises(ValueError):
        convert.lora_from_flax({"a/b/bias": {"down": np.zeros((2, 2)), "up": np.zeros((2, 2))}})


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("variant", ["plain", "bf16_moments", "skip_nonfinite"])
def test_optimizer_matches_optax(variant):
    """Three steps of the written-out optimizer against
    `optax.chain(clip_by_global_norm, adamw)` (wrapped in `apply_if_finite`
    for skip_nonfinite, with a NaN gradient at step 2) on the same numpy
    parameters and gradients; the gradient norms straddle max_grad_norm, so
    both branches of the clip run. rtol 2e-5 on parameters (an Adam update is
    lr-sized and sign-like, so fp32 rounding in another order shows at 1e-6
    of lr = 1e-2), 1e-5 on fp32 moments, one bf16 ulp on bf16 moments."""
    kw = dict(learning_rate=1e-2, adam_weight_decay=0.1, max_grad_norm=1.0,
              bf16_moments=variant == "bf16_moments", skip_nonfinite=variant == "skip_nonfinite",
              max_nonfinite_skips=5)
    jcfg, tcfg = JT.TrainConfig(**kw), TrainConfig(**kw)
    rng = np.random.default_rng(0)
    shapes = {"a.weight": {"down": (4, 6), "up": (5, 4)}, "b.weight": {"down": (4, 3, 3, 3), "up": (2, 4)}}
    params = {k: {n: rng.normal(size=s).astype(np.float32) for n, s in ab.items()}
              for k, ab in shapes.items()}
    scales = [0.05, 3.0, 0.5]  # global norms below, above and near 1
    grads = [{k: {n: (sc * rng.normal(size=s)).astype(np.float32) for n, s in ab.items()}
              for k, ab in shapes.items()} for sc in scales]
    if variant == "skip_nonfinite":
        grads[1]["a.weight"]["up"][0, 0] = np.nan

    jopt = JT.make_optimizer(jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    init, update = make_optimizer(tcfg)
    tp = {k: {n: torch.from_numpy(v.copy()) for n, v in ab.items()} for k, ab in params.items()}
    tstate = init(tp)
    for step, g in enumerate(grads):
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        before = tp
        tp, tstate, norm = update(
            {k: {n: torch.from_numpy(v) for n, v in ab.items()} for k, ab in g.items()}, tstate, tp)
        want_norm = float(optax.global_norm(jax.tree.map(jnp.asarray, g)))
        if np.isfinite(want_norm):
            np.testing.assert_allclose(float(norm), want_norm, rtol=1e-6)
        else:
            assert not np.isfinite(float(norm))
            assert all(torch.equal(a, b) for a, b in zip(_flat(tp).values(), _flat(before).values()))
        for name, t in _flat(tp).items():
            k, n = name.rsplit("/", 1)
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k][n]), rtol=2e-5, atol=1e-7,
                                       err_msg=f"step {step} {name}")
        assert all(t is not b for t, b in zip(_flat(tp).values(), _flat(params).values()))
    inner = jstate.inner_state if variant == "skip_nonfinite" else jstate
    adam = inner[1][0]
    assert tstate["count"] == int(adam.count) == (2 if variant == "skip_nonfinite" else 3)
    for name, t in _flat(tstate["mu"]).items():
        k, n = name.rsplit("/", 1)
        want = np.asarray(adam.mu[k][n].astype(jnp.float32))
        assert t.dtype == (torch.bfloat16 if variant == "bf16_moments" else torch.float32)
        np.testing.assert_allclose(t.float().numpy(), want, atol=1e-7,
                                   rtol=2**-7 if variant == "bf16_moments" else 1e-5, err_msg=name)
    for name, t in _flat(tstate["nu"]).items():
        k, n = name.rsplit("/", 1)
        np.testing.assert_allclose(t.numpy(), np.asarray(adam.nu[k][n]), rtol=1e-5, atol=1e-9,
                                   err_msg=name)
    if variant == "skip_nonfinite":
        assert tstate["total_notfinite"] == int(jstate.total_notfinite) == 1
        assert tstate["notfinite_count"] == int(jstate.notfinite_count) == 0
        assert tstate["last_finite"] is True and bool(jstate.last_finite)


def test_nonfinite_guard_gives_up_after_max_skips():
    cfg = TrainConfig(skip_nonfinite=True, max_nonfinite_skips=2)
    p = {"w": {"down": torch.ones(2, 2), "up": torch.ones(2, 2)}}
    bad = {"w": {"down": torch.full((2, 2), float("nan")), "up": torch.ones(2, 2)}}
    state = init_optimizer(p, cfg)
    for expected_skips in (1, 2):
        p, state, _ = make_optimizer(cfg)[1](bad, state, p)
        assert state["notfinite_count"] == expected_skips and bool(torch.isfinite(p["w"]["down"]).all())
    p, state, _ = make_optimizer(cfg)[1](bad, state, p)  # the third in a row goes through
    assert state["total_notfinite"] == 3 and not bool(torch.isfinite(p["w"]["down"]).all())


def test_sample_w():
    cfg = TrainConfig(discrete_w=(0.0, 7.0, 19.0))
    w = sample_w(torch.Generator().manual_seed(0), 64, cfg)
    assert w.dtype == torch.float32 and set(w.tolist()) == {0.0, 7.0, 19.0}
    u = sample_w(torch.Generator().manual_seed(0), 256, TrainConfig(discrete_w=None))
    assert 3.0 <= float(u.min()) < 4.0 and 14.0 < float(u.max()) <= 15.0


# ---------------------------------------------------------------------------
# one full step
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def step_inputs(jax_world):
    """The step's config, batch and JAX key, and the draws JAX's step makes
    from that key (the port's steps take them as given)."""
    jcfg = JT.TrainConfig(lora_rank=RANK, loss=JLossConfig(w_embed_dim=jax_world["cfg"].time_cond_proj_dim))
    rng = jax.random.PRNGKey(5)
    _, k_w, k_r, k_f, k_fp, k_rp = jax.random.split(rng, 6)

    def index(key, n):
        return torch.from_numpy(np.asarray(jax.random.randint(key, (B,), 0, n)).astype(np.int64))
    draws = {
        "w": torch.from_numpy(np.array(JT.sample_w(k_w, B, jcfg))),
        "reverse_index": index(k_r, 50), "forward_index": index(k_f, 49),
        "forward_preserve_index": index(k_fp, 4), "reverse_preserve_index": index(k_rp, 4),
    }
    return dict(jcfg=jcfg, batch=_batch(), rng=rng, draws=draws)


@pytest.fixture(scope="module", autouse=True)
def two_rank_run(step_inputs, port_world, jax_world, tmp_path_factory):
    """The step of `both_steps` over two gloo ranks, one row each
    (`_torch_dist.Ranks`: two processes, no JAX there), from the same state
    and the same global batch and draws; started before this file's first
    test, so the processes run while JAX compiles its step."""
    payload = dict(base=port_world["base"], state=_port_state(jax_world, port_world["tcfg"]),
                   batch=_torch_batch(step_inputs["batch"]),
                   steps={"dp": dict(fsdp=1, tcfg=port_world["tcfg"], draws=step_inputs["draws"])})
    ranks = Ranks("train", payload, tmp_path_factory.mktemp("two_rank_step"))
    yield ranks
    ranks.stop()


@pytest.fixture(scope="module")
def both_steps(jax_world, port_world, step_inputs):
    """One step in each package from the same state, batch and draws: the one
    compiled JAX step of this file."""
    jcfg, batch, rng, draws = (step_inputs[k] for k in ("jcfg", "batch", "rng", "draws"))
    jschedule = j_make_schedule()
    jsolver = j_make_train_solver(
        np.asarray(jschedule.alphas_cumprod), num_endpoints=4, num_forward_endpoints=4,
        endpoints=ENDPOINTS, forward_endpoints=FORWARD_ENDPOINTS)
    jopt = JT.make_optimizer(jcfg)
    lora_r, lora_f = (jax.tree.map(jnp.asarray, jax_world[n]) for n in ("lora_r", "lora_f"))
    jstate = JT.ICDTrainState(step=jnp.zeros((), jnp.int32), lora_reverse=lora_r, lora_forward=lora_f,
                              opt_reverse=jopt.init(lora_r), opt_forward=jopt.init(lora_f))
    jstep = JT.make_train_step(jax_world["unet"], jax_world["base"], jax_world["base"],
                               jsolver, jschedule, jcfg)
    jnew, jmetrics = jstep(jstate, jax_world["base"], jax_world["base"],
                           {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    want = {"metrics": {k: float(v) for k, v in jmetrics.items()},
            "lora_reverse": convert.lora_from_flax(_np_tree(jnew.lora_reverse)),
            "lora_forward": convert.lora_from_flax(_np_tree(jnew.lora_forward)),
            "mu_reverse": convert.lora_from_flax(_np_tree(jnew.opt_reverse[1][0].mu)),
            "mu_forward": convert.lora_from_flax(_np_tree(jnew.opt_forward[1][0].mu)),
            "step": int(jnew.step)}

    pw = port_world
    state = _port_state(jax_world, pw["tcfg"])
    base_before = {k: v.clone() for k, v in pw["base"].items()}
    step_fn = make_train_step(pw["unet"], pw["base"], pw["base"], pw["solver"], pw["schedule"], pw["tcfg"])
    new, metrics = step_fn(state, _torch_batch(batch), None, draws)
    return dict(want=want, state=state, new=new, metrics=metrics, draws=draws, batch=batch,
                base_before=base_before)


def _metrics_match_jax(got, want):
    assert sorted(got) == sorted(want) == sorted(METRICS)
    for name in METRICS:
        rtol = 1e-3 if name.endswith("grad_norm") else 1e-4
        np.testing.assert_allclose(float(got[name]), want[name], rtol=rtol, err_msg=name)


def test_full_step_metrics_match_jax(both_steps):
    """Every metric within 1e-4 relative, the gradient norms within 1e-3."""
    _metrics_match_jax(both_steps["metrics"], both_steps["want"]["metrics"])
    assert both_steps["new"].step == both_steps["want"]["step"] == 1


def test_full_step_updates_match_jax(both_steps):
    """The clipped adapter gradients (Adam's first moment after one step is
    0.1 times them): rtol 1e-3, atol 1e-4 * max |gradient|, as for the single
    losses. The updated adapters: the first Adam step moves an entry by
    lr * g / (|g| + 1e-8), so where |g| > 1e-5 the move is sign-like and the
    moves agree to atol 5e-7 (6% of lr = 8e-6: the adapters are O(1) fp32
    values whose own ulp is up to 2.4e-7); where the gradient is of the size of
    Adam's epsilon its rounding noise decides the move, which is only bounded
    by lr."""
    _updates_match_jax(both_steps["state"], both_steps["new"], both_steps["want"])


def _updates_match_jax(state, new, want_tree):
    lr = 8e-6
    for student in ("reverse", "forward"):
        old = _flat(getattr(state, f"lora_{student}"))
        got = _flat(getattr(new, f"lora_{student}"))
        want = _flat(want_tree[f"lora_{student}"])
        got_mu = _flat(getattr(new, f"opt_{student}")["mu"])
        want_mu = _flat(want_tree[f"mu_{student}"])
        peak = max(float(m.abs().max()) for m in want_mu.values())
        assert peak > 1e-3
        sign_like = 0
        for name in want:
            np.testing.assert_allclose(got_mu[name].numpy(), want_mu[name].numpy(), rtol=1e-3,
                                       atol=1e-4 * peak, err_msg=f"{student} mu {name}")
            move, want_move = got[name] - old[name], want[name] - old[name]
            clear = want_mu[name].abs() > 1e-6  # |g| > 1e-5
            sign_like += int(clear.sum())
            np.testing.assert_allclose(move[clear].numpy(), want_move[clear].numpy(), atol=5e-7,
                                       rtol=0, err_msg=f"{student} {name}")
            assert float(move.abs().max()) <= lr * 1.05 and float(want_move.abs().max()) <= lr * 1.05
        assert sign_like > 0.5 * sum(m.numel() for m in want_mu.values())


@pytest.fixture(scope="module")
def two_rank_step(two_rank_run, both_steps):
    """Each rank's result of `two_rank_run`."""
    return [r["dp"] for r in two_rank_run.results()]


def test_two_rank_step_matches_jax(two_rank_step, both_steps):
    """Each rank's data-parallel step (its row, the averaged gradients)
    against JAX's step on the whole batch, at this file's tolerances: the
    metrics as `test_full_step_metrics_match_jax`, the moments and moves as
    `test_full_step_updates_match_jax`; both ranks hold the same adapters."""
    for rank in two_rank_step:
        assert rank["rows"] == 2
        _metrics_match_jax(rank["metrics"], both_steps["want"]["metrics"])
        _updates_match_jax(both_steps["state"], rank["state"], both_steps["want"])
    a, b = (_flat(r["state"].lora_reverse) for r in two_rank_step)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_full_step_changes_only_the_adapters(both_steps, port_world, jax_world):
    assert all(torch.equal(v, both_steps["base_before"][k]) for k, v in port_world["base"].items())
    assert all(torch.equal(p, both_steps["base_before"][k])
               for k, p in port_world["unet"].state_dict().items())
    # the step is functional: the state it was given is as it was
    fresh = _port_state(jax_world, port_world["tcfg"])
    for student in ("lora_reverse", "lora_forward"):
        for a, b in zip(_flat(getattr(both_steps["state"], student)).values(),
                        _flat(getattr(fresh, student)).values()):
            assert torch.equal(a, b) and not a.requires_grad
    assert both_steps["state"].step == 0 and both_steps["state"].opt_reverse["count"] == 0
    assert both_steps["new"].opt_reverse["count"] == both_steps["new"].opt_forward["count"] == 1


def test_remat_on_equals_off_and_generator_draws(both_steps, port_world, jax_world):
    pw = port_world
    tcfg = TrainConfig(lora_rank=RANK, remat=True, loss=pw["tcfg"].loss)
    step_fn = make_train_step(pw["unet"], pw["base"], pw["base"], pw["solver"], pw["schedule"], tcfg)
    new, metrics = step_fn(_port_state(jax_world, tcfg), _torch_batch(both_steps["batch"]), None,
                           both_steps["draws"])
    for name in METRICS:  # the recomputed forward repeats the same fp32 operations
        np.testing.assert_allclose(float(metrics[name]), float(both_steps["metrics"][name]), rtol=1e-6)
    for a, b in zip(_flat(new.lora_reverse).values(), _flat(both_steps["new"].lora_reverse).values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-9)

    # without draws the generator decides: the same seed, the same step
    plain = make_train_step(pw["unet"], pw["base"], pw["base"], pw["solver"], pw["schedule"], pw["tcfg"])
    batch = {k: v for k, v in _torch_batch(both_steps["batch"]).items() if k != "noise"}
    runs = [plain(_port_state(jax_world, pw["tcfg"]), batch, torch.Generator().manual_seed(s))[1]
            for s in (3, 3, 4)]
    assert float(runs[0]["reverse_total_loss"]) == float(runs[1]["reverse_total_loss"])
    assert float(runs[0]["reverse_total_loss"]) != float(runs[2]["reverse_total_loss"])


def test_lazy_step_matches_merged_step(both_steps, port_world, jax_world):
    """The lazy path (`lazy_lora`) from the same state, batch and draws as
    the merged step of `both_steps`, with JAX's own tolerance for the pair
    (`tests/test_training.py::test_lazy_step_matches_merged_step`): every
    metric within 5e-4 + 5e-4 |a| of the port's merged step and of JAX's,
    the updated adapters within 5e-5. No JAX program is compiled here."""
    pw = port_world
    tcfg = dataclasses.replace(pw["tcfg"], lazy_lora=True)
    step_fn = make_train_step(pw["unet"], pw["base"], pw["base"], pw["solver"], pw["schedule"], tcfg)
    new, metrics = step_fn(_port_state(jax_world, tcfg), _torch_batch(both_steps["batch"]), None,
                           both_steps["draws"])
    for name in METRICS:
        b = float(metrics[name])
        for a in (float(both_steps["metrics"][name]), both_steps["want"]["metrics"][name]):
            assert abs(a - b) < 5e-4 + 5e-4 * abs(a), (name, a, b)
    for student in ("lora_reverse", "lora_forward"):
        merged = _flat(getattr(both_steps["new"], student))
        for name, t in _flat(getattr(new, student)).items():
            assert float((t - merged[name]).abs().max()) < 5e-5, (student, name)


def test_lazy_remat_equals_lazy_and_reaches_every_adapter(both_steps, port_world, jax_world):
    """remat recomputes each checkpointed student call, and its adapters'
    hooks with it: the same fp32 operations again (metrics rtol 1e-6,
    adapters atol 1e-9). Every adapter of both students gets a gradient,
    the convolutions' (3x3, 1x1 and the stride-2 downsampler's) included."""
    pw = port_world
    runs = {}
    for remat in (False, True):
        tcfg = dataclasses.replace(pw["tcfg"], lazy_lora=True, remat=remat)
        step_fn = make_train_step(pw["unet"], pw["base"], pw["base"], pw["solver"], pw["schedule"], tcfg)
        runs[remat] = step_fn(_port_state(jax_world, tcfg), _torch_batch(both_steps["batch"]), None,
                              both_steps["draws"])
    (plain, m_plain), (remat, m_remat) = runs[False], runs[True]
    for name in METRICS:
        np.testing.assert_allclose(float(m_remat[name]), float(m_plain[name]), rtol=1e-6, err_msg=name)
    for student in ("lora_reverse", "lora_forward"):
        for a, b in zip(_flat(getattr(remat, student)).values(), _flat(getattr(plain, student)).values()):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-9)
    convs = [k for k, ab in remat.lora_reverse.items() if ab["down"].dim() == 4]
    assert "down_blocks.0.downsamplers.0.conv.weight" in convs and len(convs) > 5
    for opt in (remat.opt_reverse, remat.opt_forward):
        no_grad = [k for k, ab in opt["mu"].items() if not (ab["down"].any() and ab["up"].any())]
        assert not no_grad, no_grad


# ---------------------------------------------------------------------------
# checkpoints and the CLI
# ---------------------------------------------------------------------------
def _states_equal(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_states_equal(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    return a == b and type(a) is type(b)


def test_checkpoint_save_restore_and_rotation(both_steps, port_world, tmp_path):
    d = str(tmp_path / "ckpt")
    assert latest_step(d) is None
    state = both_steps["new"]
    for step in (1, 2, 3, 4):
        state.step = step
        assert save_checkpoint(d, state, keep=2) == step
    state.step = 1
    assert sorted(os.listdir(d)) == ["3", "4"] and latest_step(d) == 4
    template = init_train_state(torch.Generator().manual_seed(9), port_world["base"], port_world["tcfg"])
    newest, third = restore_checkpoint(d, template), restore_checkpoint(d, template, step=3)
    assert newest.step == 4 and third.step == 3
    for f in ("lora_reverse", "lora_forward", "opt_reverse", "opt_forward"):
        assert _states_equal(getattr(newest, f), getattr(state, f)), f
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(d, template, step=1)
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "nothing"), template)
    wrong = init_train_state(torch.Generator().manual_seed(9), port_world["base"],
                             TrainConfig(lora_rank=2))
    with pytest.raises(ValueError):
        restore_checkpoint(d, wrong)


def test_cli_tiny_run_and_resume(tmp_path, capsys):
    out = str(tmp_path / "run")
    common = ["--model", "tiny", "--device", "cpu", "--synthetic_data", "--batch_size", "2",
              "--lora_rank", "4", "--log_every", "1", "--checkpointing_steps", "1",
              "--checkpoints_total_limit", "2", "--output_dir", out]
    last = train_icd.main(common + ["--max_steps", "2"])
    assert all(np.isfinite(last[name]) for name in METRICS) and last["steps_per_sec"] > 0
    assert sorted(os.listdir(os.path.join(out, "checkpoints"))) == ["1", "2"]
    resumed = train_icd.main(common + ["--max_steps", "3", "--resume_from_checkpoint", "latest"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert sorted(os.listdir(os.path.join(out, "checkpoints"))) == ["2", "3"]
    rows = [json.loads(line) for line in open(os.path.join(out, "logs", "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert all(f"train/{name}" in rows[-1] for name in METRICS)
    # a run of three steps from scratch arrives at the same third step
    straight = train_icd.main(
        common[:-1] + [str(tmp_path / "straight"), "--max_steps", "3"])
    for name in METRICS:
        np.testing.assert_allclose(resumed[name], straight[name], rtol=1e-6, err_msg=name)


def test_cli_flags_and_missing_data(tmp_path):
    args = train_icd.parse_args(["--output_dir", "x"])
    assert (args.model, args.device, args.batch_size, args.max_steps) == ("sd15", "cuda", 32, 6000)
    assert (args.learning_rate, args.lora_rank, args.loss_type, args.huber_c) == (8e-6, 64, "huber", 0.001)
    assert (args.endpoints, args.forward_endpoints) == (ENDPOINTS, FORWARD_ENDPOINTS)
    assert (args.checkpointing_steps, args.checkpoints_total_limit, args.log_every) == (500, 5, 10)
    cfg_file = tmp_path / "cfg.json"
    cfg_file.write_text(json.dumps({"batch_size": 8, "lora_rank": 16, "not_a_flag": 1}))
    args = train_icd.parse_args(["--config", str(cfg_file), "--output_dir", "x", "--lora_rank", "32"])
    assert (args.batch_size, args.lora_rank) == (8, 32)
    tcfg = train_icd.train_config(train_icd.parse_args(
        ["--output_dir", "x", "--no_reverse_preserve", "--bf16_moments", "--skip_nonfinite",
         "--remat", "--discrete_w", "0,7"]), UNetConfig.sd15())
    assert (tcfg.use_reverse_preserve, tcfg.use_forward_preserve) == (False, True)
    assert tcfg.bf16_moments and tcfg.skip_nonfinite and tcfg.remat
    assert tcfg.discrete_w == (0.0, 7.0) and tcfg.loss.w_embed_dim == 512
    with pytest.raises(SystemExit, match="synthetic_data"):
        train_icd.main(["--model", "tiny", "--device", "cpu", "--output_dir", str(tmp_path / "no")])
    assert not (tmp_path / "no").exists()
