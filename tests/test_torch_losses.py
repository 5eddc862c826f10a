"""The training solver and the four iCD losses of the PyTorch port against the
JAX package, fp32 on the CPU: the tiny UNet with weights and non-zero LoRA
adapters bridged through `models.convert`, the same numpy-seeded latents,
noise and contexts, and the timestep indices replayed from
`jax.random.randint` on the key the JAX loss draws from.

Tolerance: loss values rtol 1e-4; adapter gradients atol 1e-4 * max |grad| +
rtol 1e-3 (fp32 in both frameworks; convolution, matmul and reduction orders
differ, and the huber derivative diff / sqrt(diff^2 + c^2) with c = 1e-3
magnifies a 1e-6 difference of a prediction near its target a thousandfold).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invertible_cd_tpu.diffusion.schedule import make_schedule as j_make_schedule
from invertible_cd_tpu.diffusion.solver import make_train_solver as j_make_train_solver
from invertible_cd_tpu.models import UNet2DCondition as JUNet
from invertible_cd_tpu.models import UNetConfig as JUNetConfig
from invertible_cd_tpu.models.lora import init_lora as j_init_lora
from invertible_cd_tpu.models.lora import merge_lora as j_merge_lora
from invertible_cd_tpu.training import losses as JL
from invertible_cd_tpu_torch.diffusion.schedule import make_schedule
from invertible_cd_tpu_torch.diffusion.solver import make_train_solver, parse_endpoints
from invertible_cd_tpu_torch.models import convert
from invertible_cd_tpu_torch.models.lora import call_with_state, merge_lora
from invertible_cd_tpu_torch.models.unet2d import UNet2DCondition, UNetConfig
from invertible_cd_tpu_torch.training import losses as TL

from _torch_jax_params import seeded_params, traced_init

ENDPOINTS, FORWARD_ENDPOINTS = "0,259,519,779", "259,519,779,999"
RANK, B = 4, 2


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


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def world():
    """Both packages' tiny UNet on the same weights, adapters and inputs."""
    rng = np.random.default_rng(0)
    jcfg = JUNetConfig.tiny()
    junet = JUNet(jcfg)
    jbase = seeded_params(traced_init(  # numpy-seeded weights: Flax's init runs op by op
        junet, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 77, jcfg.cross_attention_dim)), jnp.zeros((1, jcfg.time_cond_proj_dim)),
    ))["params"]

    def j_lora(seed):
        lora = _np_tree(j_init_lora(jax.random.PRNGKey(seed), jbase, rank=RANK))
        r = np.random.default_rng(seed)
        return {k: {"down": v["down"],
                    "up": (0.3 * r.normal(size=v["up"].shape)).astype(np.float32)}
                for k, v in lora.items()}

    jlora = {"reverse": j_lora(1), "forward": j_lora(2)}
    jschedule = j_make_schedule()
    jsolver = j_make_train_solver(
        np.asarray(jschedule.alphas_cumprod), num_endpoints=4, num_forward_endpoints=4,
        endpoints=ENDPOINTS, forward_endpoints=FORWARD_ENDPOINTS)

    unet = UNet2DCondition(UNetConfig.tiny()).eval().requires_grad_(False)
    base = convert.unet_state_dict_from_flax(_np_tree(jbase))
    unet.load_state_dict(base)
    lora = {name: convert.lora_from_flax(tree) for name, tree in jlora.items()}
    schedule = make_schedule()
    solver = make_train_solver(
        schedule.alphas_cumprod, num_endpoints=4, num_forward_endpoints=4,
        endpoints=ENDPOINTS, forward_endpoints=FORWARD_ENDPOINTS)

    data = {
        "latents": rng.normal(size=(B, 8, 8, 4)).astype(np.float32),
        "noise": rng.normal(size=(B, 8, 8, 4)).astype(np.float32),
        "context": (0.1 * rng.normal(size=(B, 77, jcfg.cross_attention_dim))).astype(np.float32),
        "uncond": (0.1 * rng.normal(size=(B, 77, jcfg.cross_attention_dim))).astype(np.float32),
        "w": np.array([7.0, 11.0], np.float32),
    }
    return dict(junet=junet, jbase=jbase, jlora=jlora, jschedule=jschedule, jsolver=jsolver,
                unet=unet, base=base, lora=lora, schedule=schedule, solver=solver, data=data)


# ---------------------------------------------------------------------------
# solver
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("explicit", [True, False], ids=["given-endpoints", "spread-endpoints"])
def test_make_train_solver_tables(world, explicit):
    kw = dict(num_endpoints=4, num_forward_endpoints=4)
    if explicit:
        kw.update(endpoints=ENDPOINTS, forward_endpoints=FORWARD_ENDPOINTS)
    want = j_make_train_solver(np.asarray(world["jschedule"].alphas_cumprod), **kw)
    got = make_train_solver(world["schedule"].alphas_cumprod, **kw)
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), np.asarray(getattr(want, f.name))
        if g.dtype == torch.int64:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f.name)
        else:  # float32 casts of the same float64 host tables
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-7, atol=0, err_msg=f.name)
    np.testing.assert_array_equal(parse_endpoints(ENDPOINTS), [0, 259, 519, 779])
    with pytest.raises(ValueError):
        make_train_solver(world["schedule"].alphas_cumprod, num_endpoints=3, endpoints=ENDPOINTS)


def test_boundaries_and_ddim_steps(world):
    t = np.array([0, 19, 258, 259, 260, 518, 519, 779, 780, 998, 999], np.int64)
    js, s = world["jsolver"], world["solver"]
    np.testing.assert_array_equal(
        s.reverse_boundaries_for(torch.from_numpy(t)).numpy(),
        np.asarray(js.reverse_boundaries_for(jnp.asarray(t, jnp.int32))))
    np.testing.assert_array_equal(
        s.forward_boundaries_for(torch.from_numpy(t)).numpy(),
        np.asarray(js.forward_boundaries_for(jnp.asarray(t, jnp.int32))))
    rng = np.random.default_rng(3)
    x0, eps = (rng.normal(size=(3, 8, 8, 4)).astype(np.float32) for _ in range(2))
    idx = np.array([0, 17, 49], np.int64)
    for name in ("ddim_step", "forward_ddim_step"):
        want = getattr(js, name)(jnp.asarray(x0), jnp.asarray(eps), jnp.asarray(idx, jnp.int32))
        got = getattr(s, name)(torch.from_numpy(x0), torch.from_numpy(eps), torch.from_numpy(idx))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def _jax_side(world, which, loss_type, embed_guidance, key):
    """(loss, adapter gradient as a bridged dict, the indices the loss drew)."""
    d, junet, jbase = world["data"], world["junet"], world["jbase"]
    cfg = JL.LossConfig(loss_type=loss_type, embed_guidance=embed_guidance,
                        w_embed_dim=junet.cfg.time_cond_proj_dim)
    ctx, unc = jnp.asarray(d["context"]), jnp.asarray(d["uncond"])
    lat, noise, w = jnp.asarray(d["latents"]), jnp.asarray(d["noise"]), jnp.asarray(d["w"])
    sol, sch = world["jsolver"], world["jschedule"]

    def apply_with(tree, context=ctx):
        return lambda p, x, t, we: junet.apply({"params": tree}, x, t, context, w_cond=we)

    def merged(name, lora=None):
        return j_merge_lora(jbase, world["jlora"][name] if lora is None else lora, rank=RANK)

    teacher, uncond = apply_with(jbase), apply_with(jbase, unc)
    if which == "reverse_cd":
        fn = lambda lo: JL.reverse_cd_loss(  # noqa: E731
            apply_with(merged("reverse", lo)), None, teacher, None, lat, noise, w, key, sol, sch,
            cfg, uncond_apply=uncond)[0]
        student, n = "reverse", cfg.num_ddim_timesteps
    elif which == "forward_cd":
        fn = lambda lo: JL.forward_cd_loss(  # noqa: E731
            apply_with(merged("forward", lo)), None, teacher, None, lat, noise, w, key, sol, sch,
            cfg, uncond_apply=uncond)[0]
        student, n = "forward", cfg.num_ddim_timesteps - 1
    elif which == "forward_preserve":
        fn = lambda lo: JL.forward_preserve_loss(  # noqa: E731
            apply_with(merged("forward", lo)), None, apply_with(merged("reverse")), None,
            lat, noise, key, sol, sch, cfg)[0]
        student, n = "forward", 4
    else:
        fn = lambda lo: JL.reverse_preserve_loss(  # noqa: E731
            apply_with(merged("forward")), None, apply_with(merged("reverse", lo)), None,
            lat, noise, key, sol, sch, cfg)[0]
        student, n = "reverse", 4
    loss, grads = jax.value_and_grad(fn)(jax.tree.map(jnp.asarray, world["jlora"][student]))
    index = np.asarray(jax.random.randint(key, (B,), 0, n)).astype(np.int64)
    return float(loss), convert.lora_from_flax(_np_tree(grads)), index


def _torch_side(world, which, loss_type, embed_guidance, index):
    d, unet, base = world["data"], world["unet"], world["base"]
    cfg = TL.LossConfig(loss_type=loss_type, embed_guidance=embed_guidance,
                        w_embed_dim=unet.cfg.time_cond_proj_dim)
    ctx, unc = torch.from_numpy(d["context"]), torch.from_numpy(d["uncond"])
    lat, noise, w = _nchw(d["latents"]), _nchw(d["noise"]), torch.from_numpy(d["w"])
    sol, sch = world["solver"], world["schedule"]
    index = torch.from_numpy(index)

    def apply_with(weights, context=ctx):
        return lambda p, x, t, we: call_with_state(unet, weights, x, t, context, w_cond=we)

    student = "reverse" if which in ("reverse_cd", "reverse_preserve") else "forward"
    lora = {k: {n: t.clone().requires_grad_(True) for n, t in ab.items()}
            for k, ab in world["lora"][student].items()}
    mine = apply_with(merge_lora(base, lora, rank=RANK))
    other_name = "forward" if student == "reverse" else "reverse"
    other = apply_with(merge_lora(base, world["lora"][other_name], rank=RANK))
    teacher, uncond = apply_with(base), apply_with(base, unc)
    if which == "reverse_cd":
        loss, logs = TL.reverse_cd_loss(mine, None, teacher, None, lat, noise, w, None, sol, sch,
                                        cfg, uncond_apply=uncond, index=index)
    elif which == "forward_cd":
        loss, logs = TL.forward_cd_loss(mine, None, teacher, None, lat, noise, w, None, sol, sch,
                                        cfg, uncond_apply=uncond, index=index)
    elif which == "forward_preserve":
        loss, logs = TL.forward_preserve_loss(mine, None, other, None, lat, noise, None, sol, sch,
                                              cfg, endpoint_index=index)
    else:
        loss, logs = TL.reverse_preserve_loss(other, None, mine, None, lat, noise, None, sol, sch,
                                              cfg, endpoint_index=index)
    assert list(logs) == [f"{which}_loss"] and float(logs[f"{which}_loss"]) == float(loss.detach())
    flat = [t for ab in lora.values() for t in ab.values()]
    grads = iter(torch.autograd.grad(loss, flat))
    return float(loss), {k: {n: next(grads) for n in ab} for k, ab in lora.items()}


CASES = [
    (which, loss_type, True)
    for which in ("reverse_cd", "forward_cd", "forward_preserve", "reverse_preserve")
    for loss_type in ("huber", "l2")
] + [("reverse_cd", "huber", False), ("reverse_cd", "l2", False)]  # the CFG-mixed teacher


@pytest.mark.parametrize(
    "which,loss_type,embed_guidance", CASES,
    ids=[f"{w}-{lt}-{'wembed' if e else 'cfg'}" for w, lt, e in CASES])
def test_loss_and_adapter_gradient_match_jax(world, which, loss_type, embed_guidance):
    key = jax.random.PRNGKey(7 + len(which))
    want_loss, want_grads, index = _jax_side(world, which, loss_type, embed_guidance, key)
    got_loss, got_grads = _torch_side(world, which, loss_type, embed_guidance, index)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4)
    assert got_grads.keys() == want_grads.keys()
    peak = max(float(g.abs().max()) for ab in want_grads.values() for g in ab.values())
    assert peak > 0
    for k, ab in want_grads.items():
        for n, g in ab.items():
            np.testing.assert_allclose(got_grads[k][n].numpy(), g.numpy(), rtol=1e-3,
                                       atol=1e-4 * peak, err_msg=f"{k}/{n}")


def test_losses_draw_their_indices_from_the_generator(world):
    """Without `index=` a loss draws from its generator: the same seed gives
    the same loss, another seed another."""
    def run(seed):
        g = torch.Generator().manual_seed(seed)
        d, unet = world["data"], world["unet"]
        cfg = TL.LossConfig(w_embed_dim=unet.cfg.time_cond_proj_dim)
        ctx = torch.from_numpy(d["context"])
        apply = lambda p, x, t, we: call_with_state(  # noqa: E731
            unet, world["base"], x, t, ctx, w_cond=we)
        with torch.no_grad():
            return float(TL.forward_preserve_loss(
                apply, None, apply, None, _nchw(d["latents"]), _nchw(d["noise"]), g,
                world["solver"], world["schedule"], cfg)[0])
    assert run(0) == run(0)
    assert len({run(s) for s in range(6)}) > 1
