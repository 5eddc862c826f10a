"""The port's distribution layer (`invertible_cd_tpu_torch/parallel/`) on the CPU.

Without processes: `make_mesh`'s shapes and errors, `shard_batch`'s and the
executor's divisibility errors against the JAX package's own text, and
`param_sharding` on the tiny bundle against JAX `param_sharding` on the
8-device virtual mesh, axis for axis through the weight bridge.

With one module-scoped run of two gloo ranks and one of four
(`_torch_dist.Ranks`, one process a rank, no JAX there, both started
before the first test and read when a case needs them), whose results the
parametrised cases read:
a dp = 2 step, fsdp = 2 steps (merged, lazy, lazy with remat), a dp = 2
step drawing from its generator, tp = 2 steps (merged, lazy, lazy with
remat, and a UNet whose mid-block attention has one head and stays whole)
and, on the four ranks, an fsdp = 2 x tp = 2 step, each against the
one-process port step on the global batch; every rank's adapters bit for
bit; each rank's resident base bytes under fsdp, and the weights a step
gathers: one unit's at a time, freed when it returns; tp's reductions
under autograd (a column-split layer into a row-split one against the
unsplit pair, through the device and the host path of the collectives)
and the rows mean at tp = 2 and fsdp = 2 x tp = 2;
`sample_for_fid` and `eval_inversion` gathered on every rank against
the one-process sweep; dp = 2 serving against the one-process executor;
the generate CLI's files at two ranks against one; the train CLI at
`--fsdp 2` against one process. On the JAX tiny bundle's weights through
the bridge, against JAX's unsharded runs in this process
(`tests/test_parallel_inference.py`'s cases): the UNet at sp = 2, generate
at sp = 2, at dp = 2 x sp = 2 (the four ranks) and at tp = 2, off and int8;
an sp = 2 served burst against the one-process executor; the meshes' shapes
and groups, and each tp rank's slices of the weights and of an adapter
dict against `param_sharding`. Marked slow: JAX's own step on a dp 1 x
fsdp 2 x tp 2 mesh against the four ranks' step.
"""
import dataclasses
import filecmp
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from invertible_cd_tpu import serving as jserving
from invertible_cd_tpu.models import AutoencoderKL as JVAE
from invertible_cd_tpu.models import CLIPTextConfig as JCLIPConfig
from invertible_cd_tpu.models import CLIPTextModel as JCLIP
from invertible_cd_tpu.models import UNet2DCondition as JUNet
from invertible_cd_tpu.models import UNetConfig as JUNetConfig
from invertible_cd_tpu.models import VAEConfig as JVAEConfig
from invertible_cd_tpu.parallel import make_mesh as jmake_mesh
from invertible_cd_tpu.parallel import param_sharding as jparam_sharding
from invertible_cd_tpu.parallel import shard_batch as jshard_batch
from invertible_cd_tpu_torch.cli import generate, train_icd
from invertible_cd_tpu_torch.models import convert
from invertible_cd_tpu_torch.models.layers import fan_in_init_
from invertible_cd_tpu_torch.models.unet2d import UNet2DCondition, UNetConfig
from invertible_cd_tpu_torch.parallel import (
    Mesh, make_mesh, param_sharding, process_local_batch_slice, shard_batch)
from invertible_cd_tpu_torch.serving import BatchingExecutor
from invertible_cd_tpu_torch.testing import tiny_bundle
from invertible_cd_tpu_torch.training import LossConfig, TrainConfig, init_train_state, make_train_step
from invertible_cd_tpu_torch.training.eval import eval_inversion, sample_for_fid
from invertible_cd_tpu_torch.training.trainer import init_optimizer

from _torch_dist import OrderScorer, Ranks, _tiny_world, ev_decode, ev_fns
from _torch_jax_params import seeded_tiny_bundle, traced_init
from invertible_cd_tpu.models.lora import find_lora_targets as jfind_lora_targets
from invertible_cd_tpu_torch.parallel.tp import tp_plan, tp_slice_lora

TINY = ["--model", "tiny", "--device", "cpu"]
B = 2


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
    """The train CLI's logger takes TensorBoard whenever it imports (see
    `test_torch_training.py`)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


# ---------------------------------------------------------------------------
# layout, without processes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw,error,match", [
    ({}, None, None),
    ({"fsdp": 1, "dp": 1}, None, None),
    ({"dp": 2}, AssertionError, "mesh 2x1x1x1 != 1 devices"),
    ({"fsdp": 2}, AssertionError, r"\(1, 2, 1, 1\)"),
    ({"sp": 2}, AssertionError, r"\(1, 1, 2, 1\)"),
    ({"dp": 1, "tp": 2}, AssertionError, "mesh 1x1x1x2 != 1 devices"),
])
def test_make_mesh_shapes_and_errors(kw, error, match):
    """One process, no process group: a 1x1x1x1 mesh (JAX's on one
    device), and JAX's assertion text, word for word, for a product other
    than one device, over sp and tp too (their meshes on ranks:
    `test_make_mesh_sp_tp_on_ranks`)."""
    if error is None:
        mesh = make_mesh(**kw)
        assert mesh.shape == {"dp": 1, "fsdp": 1, "sp": 1, "tp": 1} and mesh.size == 1
        assert (mesh.rank, mesh.rows, mesh.row, mesh.device_mesh) == (0, 1, 0, None)
        return
    with pytest.raises(error, match=match) as got:
        make_mesh(**kw)
    with pytest.raises(AssertionError) as want:
        jmake_mesh(devices=jax.devices()[:1], **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("dp,b", [(8, 6), (4, 6), (2, 3), (8, 12)])
def test_shard_batch_error_matches_jax(dp, b):
    """The same ValueError, word for word, as JAX's `shard_batch` on a dp
    mesh of as many virtual devices."""
    x = np.zeros((b, 2), np.float32)
    with pytest.raises(ValueError) as want:
        jshard_batch({"x": x}, jmake_mesh(dp=dp, devices=jax.devices()[:dp]))
    with pytest.raises(ValueError) as got:
        shard_batch({"x": torch.from_numpy(x)}, Mesh(dp=dp))
    assert str(got.value) == str(want.value)


def test_shard_batch_and_local_slice():
    """Rank r of dp x fsdp keeps rows [r B/n, (r + 1) B/n) of every leaf."""
    batch = {"a": torch.arange(8), "b": {"c": torch.arange(16).reshape(8, 2)}}
    for rank, (dp, fsdp) in [(0, (2, 1)), (1, (2, 1)), (3, (2, 2)), (1, (1, 4))]:
        mesh = Mesh(dp=dp, fsdp=fsdp, rank=rank)
        start, size = process_local_batch_slice(8, mesh)
        assert (start, size) == (rank * 8 // (dp * fsdp), 8 // (dp * fsdp))
        got = shard_batch(batch, mesh)
        assert torch.equal(got["a"], torch.arange(start, start + size))
        assert torch.equal(got["b"]["c"], batch["b"]["c"][start:start + size])
    assert process_local_batch_slice(8, Mesh()) == (0, 8)


def test_executor_batch_sizes_must_divide_dp():
    """A batch size that does not divide over dp raises JAX's ValueError."""
    stub = types.SimpleNamespace(default_guidance=lambda: None)
    with pytest.raises(ValueError) as want:
        jserving.BatchingExecutor(stub, batch_sizes=(3, 4, 6), guidance=object(),
                                  mesh=jmake_mesh(dp=4, devices=jax.devices()[:4]))
    with pytest.raises(ValueError, match="must divide") as got:
        BatchingExecutor(stub, batch_sizes=(3, 4, 6), guidance=object(), mesh=Mesh(dp=4))
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def flax_tiny_trees():
    """The tiny bundle's UNet, VAE and CLIP text trees (JAX), shapes only."""
    ucfg, vcfg, ccfg = JUNetConfig.tiny(), JVAEConfig.tiny(), JCLIPConfig.tiny()
    return {
        "unet": (traced_init(JUNet(ucfg), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
                             jnp.zeros((1, 77, ucfg.cross_attention_dim)),
                             jnp.zeros((1, ucfg.time_cond_proj_dim))),
                 convert.unet_state_dict_from_flax),
        "vae": (traced_init(JVAE(vcfg), jnp.zeros((1, 16, 16, 3))), convert.vae_state_dict_from_flax),
        "text": (traced_init(JCLIP(ccfg), jnp.zeros((1, 77), jnp.int32)),
                 convert.clip_state_dict_from_flax),
    }


@pytest.mark.parametrize("fsdp,tp,min_size", [(2, 1, 256), (4, 1, 256), (8, 1, 1024), (2, 1, 2**16),
                                              (2, 2, 256), (1, 4, 256)])
@pytest.mark.parametrize("model", ["unet", "vae", "text"])
def test_param_sharding_matches_jax(flax_tiny_trees, model, fsdp, tp, min_size):
    """The port's `param_sharding` on the bridged state dict splits each
    tensor over the same mesh axis, along the same tensor axis, as JAX's on
    the Flax tree: every JAX leaf becomes a marker (its index along the
    axis JAX splits, or zeros), carried through `models.convert`, and the
    axis the port tensor varies along must be the port's choice."""
    tree, to_torch = flax_tiny_trees[model]
    jmesh = jmake_mesh(dp=8 // (fsdp * tp), fsdp=fsdp, tp=tp)
    specs = jparam_sharding(tree, jmesh, min_size=min_size)

    def marker(leaf, sharding, code):
        spec = tuple(sharding.spec) + (None,) * (len(leaf.shape) - len(sharding.spec))
        axes = [i for i, a in enumerate(spec) if a is not None]
        out = np.zeros(leaf.shape, np.float32)
        if axes:
            idx = [1] * len(leaf.shape)
            idx[axes[0]] = leaf.shape[axes[0]]
            out = out + (np.arange(leaf.shape[axes[0]]).reshape(idx) if code is None
                         else {"fsdp": 1.0, "tp": 2.0}[spec[axes[0]]])
        return out
    where = to_torch(jax.tree.map(lambda l, s: marker(l, s, None), tree, specs))
    names = to_torch(jax.tree.map(lambda l, s: marker(l, s, "name"), tree, specs))
    got = param_sharding(where, Mesh(dp=8 // (fsdp * tp), fsdp=fsdp, tp=tp), min_size=min_size)
    assert got.keys() == where.keys()
    split = 0
    for key, t in where.items():
        want = [None] * t.dim()
        for axis in range(t.dim()):
            if t.shape[axis] > 1 and bool((t.diff(dim=axis) != 0).any()):
                want[axis] = {1.0: "fsdp", 2.0: "tp"}[float(names[key].max())]
        assert got[key] == tuple(want), key
        split += any(want)
    if min_size < 2**16 and fsdp > 1:
        assert split > len(where) // 4  # the small min_size splits real leaves


# ---------------------------------------------------------------------------
# two gloo ranks
# ---------------------------------------------------------------------------
def _tiny_base():
    unet = UNet2DCondition(UNetConfig.tiny())
    fan_in_init_(unet, torch.Generator().manual_seed(0))
    return {k: v.clone() for k, v in unet.state_dict().items()}


def _train_inputs():
    base = _tiny_base()
    tcfg = TrainConfig(lora_rank=4, loss=LossConfig(w_embed_dim=UNetConfig.tiny().time_cond_proj_dim))
    state = init_train_state(torch.Generator().manual_seed(1), base, tcfg)
    gen = torch.Generator().manual_seed(2)
    for lora in (state.lora_reverse, state.lora_forward):  # non-zero adapters
        for ab in lora.values():
            ab["up"] = 0.03 * torch.randn(ab["up"].shape, generator=gen)
    rng = np.random.default_rng(0)
    batch = {"latents": torch.from_numpy(rng.normal(size=(B, 8, 8, 4)).astype(np.float32)),
             "context": torch.from_numpy((0.1 * rng.normal(size=(B, 77, 32))).astype(np.float32)),
             "noise": torch.from_numpy(rng.normal(size=(B, 8, 8, 4)).astype(np.float32))}
    draws = {"w": torch.tensor([7.0, 15.0]), "reverse_index": torch.tensor([3, 41]),
             "forward_index": torch.tensor([17, 0]), "forward_preserve_index": torch.tensor([2, 0]),
             "reverse_preserve_index": torch.tensor([1, 3])}
    lazy = dataclasses.replace(tcfg, lazy_lora=True)
    lazy_remat = dataclasses.replace(lazy, remat=True)
    steps = {
        "dp": dict(fsdp=1, tcfg=tcfg, draws=draws),
        "fsdp": dict(fsdp=2, tcfg=tcfg, draws=draws, min_size=256),
        "dp_generator": dict(fsdp=1, tcfg=tcfg, seed=3, keys=("latents", "context")),
        "fsdp_lazy": dict(fsdp=2, tcfg=lazy, draws=draws, min_size=256),
        "fsdp_lazy_remat": dict(fsdp=2, tcfg=lazy_remat, draws=draws, min_size=256),
        "tp": dict(fsdp=1, tp=2, tcfg=tcfg, draws=draws),
        "tp_lazy": dict(fsdp=1, tp=2, tcfg=lazy, draws=draws),
        "tp_lazy_remat": dict(fsdp=1, tp=2, tcfg=lazy_remat, draws=draws),
        # the mid-block's attention has one head: it stays whole, its FF splits
        "tp_whole_mid_attention": dict(fsdp=1, tp=2, tcfg=tcfg, draws=draws, num_heads=(2, 1)),
    }
    return dict(base=base, state=state, batch=batch, steps=steps)


# The four ranks' fsdp 2 x tp 2 step: the JAX tiny bundle's reverse UNet and
# numpy-drawn adapters (so that JAX's step can take the same ones, `slow`),
# and the draws JAX's step makes from PRNGKey(FSDP_TP_KEY) at batch 2
# (checked in `test_fsdp_tp_step_matches_jax`).
FSDP_TP_KEY = 12
FSDP_TP_DRAWS = {"w": [11.0, 7.0], "reverse_index": [39, 45], "forward_index": [30, 15],
                 "forward_preserve_index": [1, 2], "reverse_preserve_index": [3, 2]}


def _flax_lora(params, seed=7, rank=4):
    """An adapter tree in the JAX package's layout for every target kernel
    of a Flax UNet's "params" tree: down ~ N(0, 1/fan_in), up ~ 0.03 N,
    from numpy."""
    rng = np.random.default_rng(seed)
    leaves = dict(jax.tree_util.tree_leaves_with_path(params))
    shapes = {tuple(k.key for k in path): leaf.shape for path, leaf in leaves.items()}
    out = {}
    for path in jfind_lora_targets(params):
        shape = shapes[tuple(path)]
        down = (rng.standard_normal(shape[:-1] + (rank,)) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        out["/".join(path)] = {"down": down,
                               "up": (0.03 * rng.standard_normal((rank, shape[-1]))).astype(np.float32)}
    return out


def _fsdp_tp_inputs(flax_unet):
    """Case (c)'s state, batch and draws from the JAX bundle's reverse UNet
    (bridged) and `_flax_lora`'s adapters."""
    base = convert.unet_state_dict_from_flax(jax.tree.map(np.asarray, flax_unet))
    tcfg = TrainConfig(lora_rank=4, loss=LossConfig(w_embed_dim=UNetConfig.tiny().time_cond_proj_dim))
    lora_r = convert.lora_from_flax(_flax_lora(flax_unet["params"], 7))
    lora_f = convert.lora_from_flax(_flax_lora(flax_unet["params"], 8))
    state = init_train_state(torch.Generator().manual_seed(1), base, tcfg)
    state = dataclasses.replace(state, lora_reverse=lora_r, lora_forward=lora_f,
                                opt_reverse=init_optimizer(lora_r, tcfg),
                                opt_forward=init_optimizer(lora_f, tcfg))
    rng = np.random.default_rng(12)
    batch = {"latents": torch.from_numpy(rng.normal(size=(B, 8, 8, 4)).astype(np.float32)),
             "context": torch.from_numpy((0.1 * rng.normal(size=(B, 77, 32))).astype(np.float32)),
             "noise": torch.from_numpy(rng.normal(size=(B, 8, 8, 4)).astype(np.float32))}
    draws = {k: torch.tensor(v) for k, v in FSDP_TP_DRAWS.items()}
    return dict(base=base, state=state, batch=batch,
                steps={"fsdp_tp": dict(fsdp=2, tp=2, tcfg=tcfg, draws=draws, min_size=256)})


def _tp_pair_inputs():
    """A feed-forward pair (32 -> 64 -> 32), its input (2, 3, 32), the
    output's cotangent, and a tensor to average."""
    rng = np.random.default_rng(3)

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))
    return dict(w1=t(64, 32, scale=32**-0.5), b1=t(64, scale=0.1), w2=t(32, 64, scale=64**-0.5),
                b2=t(32, scale=0.1), x=t(2, 3, 32), g=t(2, 3, 32), mean_input=t(5))


SERVE = dict(prompts=["a red fox", "a cat", "prompt variant 2", "a dog"], seeds=[11, 2**40 + 3, -5, 0])
EVAL = dict(prompts=[f"prompt {i}" for i in range(5)], batch_size=2, seed=4,
            latents=torch.from_numpy(np.random.default_rng(5).normal(size=(5, 8, 8, 4)).astype(np.float32)),
            context=torch.from_numpy(np.random.default_rng(6).normal(size=(5, 77, 32)).astype(np.float32)))


def _generate_argv(out):
    return TINY + ["--prompt", "a cat", "--prompt", "a dog", "--prompt", "a red fox",
                   "--batch_size", "1", "--calc_metrics", "--out", out]


def _train_argv(out):
    return TINY + ["--synthetic_data", "--batch_size", "2", "--lora_rank", "4", "--max_steps", "2",
                   "--log_every", "1", "--checkpointing_steps", "2", "--validation_steps", "0",
                   "--inversion_eval_steps", "2", "--inversion_eval_samples", "3",
                   "--output_dir", out]


SP_PROMPTS = ["a cat", "a dog"]
SP_SERVE = dict(prompts=["a red fox", "a cat"], seeds=[11, 2**40 + 3])
LATENT_KEYS = {"sp": 13, "tp": 5, "int8": 9}  # test_parallel_inference.py's PRNGKeys


@pytest.fixture(scope="module")
def jpipe():
    """The JAX package's tiny SD1.5 bundle with numpy-seeded weights."""
    return seeded_tiny_bundle()


@pytest.fixture(scope="module")
def sp_tp_inputs(jpipe):
    """The JAX bundle's weights through the bridge, the UNet's inputs of
    `test_parallel_inference.py`'s sp case (rng 11: latents (2, 16, 16, 4),
    context, zero w; t = 519) and the start latents JAX's generate draws
    from its cases' PRNGKeys, NHWC numpy."""
    p = jax.tree.map(np.asarray, jpipe.params)
    weights = {"reverse": convert.unet_state_dict_from_flax(p["reverse"]),
               "text": convert.clip_state_dict_from_flax(p["text"]),
               "vae": convert.vae_state_dict_from_flax(p["vae"])}
    cfg = jpipe.unet.cfg
    rng = np.random.default_rng(11)
    unet = {"latent": rng.normal(size=(2, 16, 16, 4)).astype(np.float32),
            "context": rng.normal(size=(2, 77, cfg.cross_attention_dim)).astype(np.float32),
            "w": np.zeros((2, cfg.time_cond_proj_dim), np.float32), "t": 519}
    latents = {name: np.array(jpipe.init_latent(jax.random.PRNGKey(k), len(SP_PROMPTS)))
               for name, k in LATENT_KEYS.items()}
    return dict(weights=weights, unet=unet, latents=latents, fsdp_tp=_fsdp_tp_inputs(p["reverse"]))


@pytest.fixture(scope="module", autouse=True)
def spawns(tmp_path_factory, sp_tp_inputs):
    """The two-rank and the four-rank runs, started before this file's first
    test (its layout tests and the JAX references run meanwhile)."""
    tmp = tmp_path_factory.mktemp("two_ranks")
    payload = _train_inputs()
    payload["tp_pair"] = _tp_pair_inputs()
    torch_latents = {k: torch.from_numpy(v) for k, v in sp_tp_inputs["latents"].items()}
    u = sp_tp_inputs["unet"]
    payload.update(eval=EVAL, serve=SERVE, generate_argv=_generate_argv(str(tmp / "gen")),
                   train_argv=_train_argv(str(tmp / "train")) + ["--fsdp", "2"],
                   sp_tp=dict(weights=sp_tp_inputs["weights"], prompts=SP_PROMPTS, serve=SP_SERVE,
                              unet=dict(latent=torch.from_numpy(u["latent"]).permute(0, 3, 1, 2),
                                        context=torch.from_numpy(u["context"]),
                                        w=torch.from_numpy(u["w"]), t=u["t"]),
                              sp_latent=torch_latents["sp"], tp_latent=torch_latents["tp"],
                              int8_latent=torch_latents["int8"]))
    runs = dict(two=Ranks("parallel", payload, tmp), payload=payload, tmp=tmp,
                four=Ranks("dp_sp", dict(weights=sp_tp_inputs["weights"], prompts=SP_PROMPTS,
                                         latent=torch_latents["sp"], train=sp_tp_inputs["fsdp_tp"],
                                         mean_input=_tp_pair_inputs()["mean_input"]),
                           tmp, world=4))
    yield runs
    runs["two"].stop()
    runs["four"].stop()


@pytest.fixture(scope="module")
def jax_refs(jpipe, sp_tp_inputs):
    """JAX's unsharded runs: the UNet apply on the sp case's inputs, and
    generate of SP_PROMPTS from each start latent (under int8 for "int8")."""
    pipe, u = jpipe, sp_tp_inputs["unet"]
    b = u["latent"].shape[0]
    unet = jax.jit(lambda params, l, c, wv: pipe.unet.apply(
        params, l, jnp.full((b,), u["t"], jnp.int32), c, w_cond=wv))
    out = {"unet": np.asarray(unet(pipe.params["reverse"], u["latent"], u["context"], u["w"]))}
    for name, latent in sp_tp_inputs["latents"].items():
        pipe.quantize = "int8" if name == "int8" else "off"
        try:
            out[name] = np.asarray(pipe.generate(SP_PROMPTS, latent=jnp.asarray(latent))[0])
        finally:
            pipe.quantize = "off"
    return out


@pytest.fixture(scope="module")
def two_ranks(spawns, jax_refs):
    """The two ranks' results (JAX's references are computed first, while
    the ranks run)."""
    return dict(ranks=spawns["two"].results(), inputs=spawns["payload"], tmp=spawns["tmp"])


@pytest.fixture(scope="module")
def four_ranks(spawns, jax_refs):
    return spawns["four"].results()


def _one_process_steps(p):
    """The one-process port step of each of p["steps"] on the global batch."""
    out = {}
    for name, run in p["steps"].items():
        unet, schedule, solver = _tiny_world(p["base"], run.get("num_heads"))
        step_fn = make_train_step(unet, p["base"], p["base"], solver, schedule, run["tcfg"])
        gen = None if run.get("seed") is None else torch.Generator().manual_seed(run["seed"])
        batch = {k: v for k, v in p["batch"].items() if k in run.get("keys", p["batch"])}
        out[name] = step_fn(p["state"], batch, gen, run.get("draws"))
    return out


@pytest.fixture(scope="module")
def one_process(two_ranks, sp_tp_inputs):
    """The one-process port step of each case on the global batch."""
    return {**_one_process_steps(two_ranks["inputs"]), **_one_process_steps(sp_tp_inputs["fsdp_tp"])}


def _flat(lora):
    return {f"{k}/{n}": t for k, ab in lora.items() for n, t in ab.items()}


def _rank_steps(name, two_ranks, four_ranks, sp_tp_inputs):
    """Each rank's result of case `name`, the initial state, the ranks per
    row (tp) and the rows."""
    if name == "fsdp_tp":
        return [r["train"]["steps"][name] for r in four_ranks], sp_tp_inputs["fsdp_tp"]["state"], 2, 2
    run = two_ranks["inputs"]["steps"][name]
    tp = run.get("tp", 1)
    return ([r["steps"][name] for r in two_ranks["ranks"]], two_ranks["inputs"]["state"], tp, 2 // tp)


STEP_CASES = ["dp", "fsdp", "dp_generator", "fsdp_lazy", "fsdp_lazy_remat", "tp", "tp_lazy",
              "tp_lazy_remat", "tp_whole_mid_attention"]


@pytest.mark.parametrize("name", STEP_CASES)
def test_two_rank_step_equals_one_process(two_ranks, four_ranks, sp_tp_inputs, one_process, name):
    """Each rank's step on its rows equals the one-process step on both
    rows (the generator case draws noise, w and the indices at the global
    batch; a tp pair runs the same rows, each rank half of every split
    block): metrics within 1e-5 relative (measured: 2e-6); Adam's first
    moments (0.1 x the clipped, averaged gradients) within rtol 1e-3 and
    1e-4 x their largest entry, the tolerance the step is held to JAX by
    (measured: 0.2 of it); the adapters' moves within 5e-8 where the
    gradient is clear of Adam's epsilon (|mu| > 1e-6; measured 7.5e-9)."""
    _assert_step_equals(name, two_ranks, four_ranks, sp_tp_inputs, one_process)


def test_four_rank_fsdp_tp_step_equals_one_process(two_ranks, four_ranks, sp_tp_inputs, one_process):
    """The fsdp = 2 x tp = 2 step over four ranks (each fsdp pair one row,
    each tp pair half of every split block, the units gathered over fsdp)
    against the one-process step, at the two-rank cases' tolerances."""
    _assert_step_equals("fsdp_tp", two_ranks, four_ranks, sp_tp_inputs, one_process)


def _assert_step_equals(name, two_ranks, four_ranks, sp_tp_inputs, one_process):
    want_state, want_metrics = one_process[name]
    ranks, old, _, rows = _rank_steps(name, two_ranks, four_ranks, sp_tp_inputs)
    for got in ranks:
        assert got["rows"] == rows
        assert sorted(got["metrics"]) == sorted(want_metrics)
        for key, value in want_metrics.items():
            np.testing.assert_allclose(got["metrics"][key], float(value), rtol=1e-5, err_msg=key)
        for student in ("reverse", "forward"):
            mu = _flat(got["state"].__dict__[f"opt_{student}"]["mu"])
            want_mu = _flat(getattr(want_state, f"opt_{student}")["mu"])
            peak = max(float(m.abs().max()) for m in want_mu.values())
            new = _flat(getattr(got["state"], f"lora_{student}"))
            want_new = _flat(getattr(want_state, f"lora_{student}"))
            start = _flat(getattr(old, f"lora_{student}"))
            for key in want_mu:
                np.testing.assert_allclose(mu[key].numpy(), want_mu[key].numpy(), rtol=1e-3,
                                           atol=1e-4 * peak, err_msg=f"{student} mu {key}")
                clear = want_mu[key].abs() > 1e-6
                np.testing.assert_allclose((new[key] - start[key])[clear].numpy(),
                                           (want_new[key] - start[key])[clear].numpy(),
                                           atol=5e-8, rtol=0, err_msg=f"{student} {key}")


@pytest.mark.parametrize("name", STEP_CASES + ["fsdp_tp"])
def test_two_rank_adapters_identical_on_both_ranks(two_ranks, four_ranks, sp_tp_inputs, name):
    """The reduced gradients are the same bits on every rank, so are the
    updated adapters and optimizer states, and the logged metrics (the
    four ranks' case too)."""
    ranks, _, tp, rows = _rank_steps(name, two_ranks, four_ranks, sp_tp_inputs)
    assert [r["row"] for r in ranks] == [i // tp for i in range(rows * tp)]
    a = ranks[0]
    for b in ranks[1:]:
        for student in ("lora_reverse", "lora_forward"):
            for key, t in _flat(getattr(a["state"], student)).items():
                assert torch.equal(t, _flat(getattr(b["state"], student))[key]), (student, key)
        for opt in ("opt_reverse", "opt_forward"):
            for part in ("mu", "nu"):
                for key, t in _flat(getattr(a["state"], opt)[part]).items():
                    assert torch.equal(t, _flat(getattr(b["state"], opt)[part])[key]), (opt, key)
        assert a["metrics"] == b["metrics"]


@pytest.mark.parametrize("name", ["fsdp", "fsdp_lazy"])
def test_fsdp_resident_base_bytes(two_ranks, name):
    """Under fsdp = 2 each rank holds half of every tensor of at least
    min_size elements, and the smaller ones whole; base and teacher are
    one set of weights here, held once."""
    base = two_ranks["inputs"]["base"]
    large = sum(t.numel() * t.element_size() for t in base.values() if t.numel() >= 256)
    small = sum(t.numel() * t.element_size() for t in base.values() if t.numel() < 256)
    for rank in two_ranks["ranks"]:
        resident = rank["steps"][name]["resident"]
        assert resident <= large // 2 + small
        assert large > 4 * small  # the split covers most of the bytes
    assert all(rank["steps"]["dp"]["resident"] == large + small for rank in two_ranks["ranks"])


@pytest.mark.parametrize("name", ["fsdp", "fsdp_lazy"])
def test_fsdp_step_holds_whole_weights_then_frees_them(two_ranks, name):
    """Under fsdp = 2 a step gathers one unit (a down, mid or up block, or
    a top-level layer) at a time, in the forward and again in the backward
    pass: no two units' gathered bytes are alive at once, and those alive
    never exceed the largest unit's of one dict (base or teacher; the same
    tensors here, held once), gather buffers included; a rank's peak of
    base and teacher bytes (its resident shards plus those) stays below
    the whole weights, and every gathered tensor is freed when the step
    returns. The split tensors, gathered all at once, would hold `whole`
    bytes."""
    base = two_ranks["inputs"]["base"]
    whole = sum(t.numel() * t.element_size() for t in base.values())
    for rank in two_ranks["ranks"]:
        got = rank["steps"][name]
        assert got["units"] == 1
        assert 0 < got["peak"] <= got["unit_max"] < got["whole"]
        assert got["resident"] + got["whole"] // 2 == whole  # shards + the tensors left whole
        assert got["resident"] + got["peak"] < whole
        assert got["live"] == 0


@pytest.mark.parametrize("name", ["fsdp_lazy_remat", "fsdp_tp"])
def test_fsdp_peak_is_one_unit_under_remat_and_tp(two_ranks, four_ranks, sp_tp_inputs, name):
    """The same bound under remat (the checkpoint's recompute gathers the
    units again inside the backward pass) and over fsdp = 2 x tp = 2 (the
    tp-split tensors stay whole at their tp slice, as `param_sharding`
    gives tp precedence): one unit's gathered bytes alive at a time, no
    more than the largest unit's, below the whole weights, none left at
    return."""
    ranks, _, _, _ = _rank_steps(name, two_ranks, four_ranks, sp_tp_inputs)
    for got in ranks:
        assert got["units"] == 1
        assert 0 < got["peak"] <= got["unit_max"] < got["whole"]
        assert got["live"] == 0


def _unsplit_pair(p):
    """The feed-forward pair of `_tp_pair_inputs` unsplit: output and the
    gradients of the input and the four parameters."""
    x = p["x"].clone().requires_grad_(True)
    params = [t.clone().requires_grad_(True) for t in (p["w1"], p["b1"], p["w2"], p["b2"])]
    y = torch.nn.functional.linear(torch.nn.functional.gelu(
        torch.nn.functional.linear(x, params[0], params[1])), params[2], params[3])
    return y.detach(), torch.autograd.grad((y * p["g"]).sum(), [x] + params)


@pytest.mark.parametrize("path", ["device", "host"])
def test_tp_pair_gradients_equal_the_unsplit_layers(two_ranks, path):
    """A column-split layer (its input through `to_tp`) into a row-split
    one (`RowSplitLinear`: `from_tp`), at tp = 2: the output and the input's
    gradient on each rank equal the unsplit pair's, and each rank's
    parameter gradients are its slices of the unsplit ones, through the
    collectives' device path and through the host path that gloo takes
    for CUDA tensors (fp32, 1e-5 / 1e-6). The tp input is never written in
    place, and the output's graph holds `from_tp`'s reduction."""
    p = two_ranks["inputs"]["tp_pair"]
    y, (dx, dw1, db1, dw2, db2) = _unsplit_pair(p)
    for rank in two_ranks["ranks"]:
        got = rank["tp_pair"][path]
        cols = got["cols"]
        assert got["input_version_kept"] and "_FromTPBackward" in got["grad_fns"]
        for a, b in ((got["y"], y), (got["dx"], dx), (got["dw1"], dw1[cols]), (got["db1"], db1[cols]),
                     (got["dw2"], dw2[:, cols]), (got["db2"], db2)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


def test_tp_in_place_reduction_gave_a_partial_input_gradient(two_ranks):
    """The pair with the partial products summed in place and no `to_tp`
    (the reductions as they were): autograd does not see the sum, so the
    forward is right while the input's gradient is each rank's own
    features' part, summing over the ranks to the unsplit one, and not it."""
    p = two_ranks["inputs"]["tp_pair"]
    y, (dx, *_) = _unsplit_pair(p)
    parts = [rank["tp_pair"]["in_place"] for rank in two_ranks["ranks"]]
    for got in parts:
        np.testing.assert_allclose(got["y"].numpy(), y.numpy(), rtol=1e-5, atol=1e-6)
        assert float((got["dx"] - dx).abs().max()) > 0.1 * float(dx.abs().max())
    np.testing.assert_allclose((parts[0]["dx"] + parts[1]["dx"]).numpy(), dx.numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mesh_name", ["tp2", "fsdp2xtp2"])
def test_rows_mean_is_over_dp_and_fsdp_only(two_ranks, four_ranks, mesh_name):
    """`all_reduce_mean` averages over the rows group (dp x fsdp), whose
    ranks hold different rows. At tp = 2 (one row) the mean of a tensor
    both ranks hold is that tensor, where the sum over every rank over the
    rows (the reduction it was) gave twice it; over fsdp 2 x tp 2 (rank r
    holding (1 + r) t) each rank gets the mean of its fsdp pair's."""
    t = two_ranks["inputs"]["tp_pair"]["mean_input"]
    if mesh_name == "tp2":
        for rank in two_ranks["ranks"]:
            got = rank["tp_pair"]
            assert torch.equal(got["rows_mean"], t)
            assert torch.equal(got["old_mean"], 2 * t)
        return
    for r, rank in enumerate(four_ranks):
        partner = r ^ 2  # the other fsdp coordinate, the same tp coordinate
        np.testing.assert_allclose(rank["train"]["rows_mean"].numpy(),
                                   ((2 + r + partner) / 2 * t).numpy(), rtol=1e-6)


@pytest.mark.parametrize("which", ["sample_for_fid", "eval_inversion"])
def test_gathered_eval_equals_one_process(two_ranks, which):
    """Each rank ran its stride of the batches and holds every result, in
    order, equal to the one-process sweep (the FID stand-in reads every
    image in order)."""
    if which == "sample_for_fid":
        pipe = tiny_bundle(None)
        want = sample_for_fid(lambda b, g: pipe.generate(list(b), generator=g)[0], EVAL["prompts"],
                              EVAL["batch_size"], seed=EVAL["seed"], device="cpu")
        assert len(want) == 5
        for rank in two_ranks["ranks"]:
            got = rank[which]
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    else:
        want = eval_inversion(*ev_fns(), EVAL["latents"], batch_size=EVAL["batch_size"],
                              decode_fn=ev_decode, scorer=OrderScorer(), val_context=EVAL["context"])
        assert set(want) == {"inversion_latent_mse", "inversion_fid"}
        for rank in two_ranks["ranks"]:
            assert rank[which] == want


def test_dp_serving_matches_executor(two_ranks):
    """A burst of 4 served at dp = 2 (2 rows a rank) against the
    one-process executor's batch of 4, at `test_serving.py`'s 2e-5 / 1e-4:
    a row's rounding depends on the batch around it."""
    rank0, rank1 = two_ranks["ranks"]
    assert rank0["serve_stats"]["batches"] == 1 and rank1["served_batches"] == 1
    pipe = tiny_bundle(None)
    with BatchingExecutor(pipe, batch_size=4, max_delay=1.0) as ex:
        futs = [ex.submit(p, seed=s) for p, s in zip(SERVE["prompts"], SERVE["seeds"])]
        want = np.stack([f.result(timeout=120) for f in futs])
    got = rank0["served"]
    assert got.shape == want.shape == (4, 32, 32, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)


def test_generate_cli_two_ranks_union(two_ranks, tmp_path):
    """The two ranks' files (each under its global index) are the one-rank
    run's, byte for byte; rank 0 wrote the manifest and metrics of all
    three images."""
    two, one = str(two_ranks["tmp"] / "gen"), str(tmp_path / "one")
    generate.main(_generate_argv(one))
    names = sorted(f for f in os.listdir(one) if f.endswith(".jpg"))
    assert names == [f"{i:06d}.jpg" for i in range(3)]
    assert sorted(f for f in os.listdir(two) if f.endswith(".jpg")) == names
    for name in names:
        assert filecmp.cmp(os.path.join(one, name), os.path.join(two, name), shallow=False), name
    for name in ("manifest.json", "metrics.json"):
        with open(os.path.join(one, name)) as f1, open(os.path.join(two, name)) as f2:
            a, b = json.load(f1), json.load(f2)
        if name == "manifest.json":
            a["files"] = [os.path.basename(p) for p in a["files"]]
            b["files"] = [os.path.basename(p) for p in b["files"]]
        assert a == b and (name != "metrics.json" or a["n_images"] == 3)


def test_train_cli_fsdp_two_ranks(two_ranks, tmp_path):
    """The train CLI at `--fsdp 2` over the two ranks (one row each, the
    base and teacher held as shards, gathered for the inversion eval) ends
    where one process does: each step's metrics within 1e-5 relative; rank
    0 alone wrote metrics.jsonl and the one checkpoint and export."""
    out = str(two_ranks["tmp"] / "train")
    want = train_icd.main(_train_argv(str(tmp_path / "one")))
    for rank in two_ranks["ranks"]:
        got = rank["train_cli"]
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            if key != "steps_per_sec":
                np.testing.assert_allclose(got[key], value, rtol=1e-5, err_msg=key)
    assert sorted(os.listdir(os.path.join(out, "checkpoints"))) == ["2"]
    assert os.path.exists(os.path.join(out, "export_2", "unet_lora", "lora_weights.safetensors"))
    rows = [json.loads(line) for line in open(os.path.join(out, "logs", "metrics.jsonl"))]
    one = [json.loads(line) for line in open(str(tmp_path / "one" / "logs" / "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [r["step"] for r in one] == [1, 2, 2]
    np.testing.assert_allclose(rows[-1]["eval/inversion_latent_mse"],
                               one[-1]["eval/inversion_latent_mse"], rtol=1e-5)


# ---------------------------------------------------------------------------
# sp and tp, against JAX's unsharded runs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["sp2", "tp2", "dp2xsp2", "fsdp2xtp2"])
def test_make_mesh_sp_tp_on_ranks(two_ranks, four_ranks, name):
    """`make_mesh(sp=2)` and `make_mesh(tp=2)` over two ranks and
    `make_mesh(dp=2, sp=2)` and `make_mesh(dp=1, fsdp=2, tp=2)` over four:
    the row-major layout (rank = ((dp_i * fsdp + fsdp_i) * sp + sp_i) * tp
    + tp_i), each rank's group of every axis, and its rows group (the ranks
    of its sp and tp coordinates: dp x fsdp)."""
    if name == "dp2xsp2":
        records = [r["mesh"] for r in four_ranks]
        shape = {"dp": 2, "fsdp": 1, "sp": 2, "tp": 1}
    elif name == "fsdp2xtp2":
        records = [r["train"]["mesh"] for r in four_ranks]
        shape = {"dp": 1, "fsdp": 2, "sp": 1, "tp": 2}
    else:
        records = [r["meshes"][name] for r in two_ranks["ranks"]]
        shape = {"dp": 1, "fsdp": 1, "sp": 2 if name == "sp2" else 1, "tp": 2 if name == "tp2" else 1}
    axes = ["dp", "fsdp", "sp", "tp"]
    stride = {a: int(np.prod([shape[b] for b in axes[i + 1:]])) for i, a in enumerate(axes)}
    inner = shape["sp"] * shape["tp"]
    for rank, rec in enumerate(records):
        coords = {a: rank // stride[a] % shape[a] for a in axes}
        assert rec["shape"] == shape
        assert rec["coords"] == coords
        assert rec["rows"] == (shape["dp"] * shape["fsdp"], coords["dp"] * shape["fsdp"] + coords["fsdp"])
        for axis in axes:
            first = rank - coords[axis] * stride[axis]
            assert rec["groups"][axis] == [first + j * stride[axis] for j in range(shape[axis])]
        assert rec["groups"]["rows"] == list(range(rank % inner, len(records), inner))


def test_sp_unet_matches_jax(two_ranks, jax_refs):
    """The tiny UNet with each rank holding 8 of the latent's 16 rows
    (halo convolutions, GroupNorm's sums over the pair, K and V gathered),
    its rows gathered, against JAX's replicated apply at JAX's sp tolerance
    (1e-5 / 1e-4: GroupNorm's sums reassociate)."""
    want = jax_refs["unet"]
    for rank in two_ranks["ranks"]:
        assert tuple(rank["sp_unet_rows"]) == (2, 4, 8, 16)
        np.testing.assert_allclose(rank["sp_unet"].permute(0, 2, 3, 1).numpy(), want,
                                   atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("name", ["sp", "tp", "dp_sp"])
def test_distributed_generate_matches_jax(two_ranks, four_ranks, jax_refs, name):
    """Generate of two prompts from JAX's start latent, at sp = 2 (both
    ranks hold the whole images), tp = 2 (each rank half of every block's
    heads and FF features) and dp = 2 x sp = 2 (each dp pair one prompt,
    its height split), against JAX's unsharded generate at JAX's dp x sp
    tolerance (3e-5 / 1e-4)."""
    if name == "dp_sp":
        got = [r["images"] for r in four_ranks]
        assert [r["rows"] for r in four_ranks] == [(0, 1), (0, 1), (1, 1), (1, 1)]
    else:
        got = [rank[f"{name}_generate"][0] for rank in two_ranks["ranks"]]
    want = jax_refs["tp" if name == "tp" else "sp"]
    assert want.shape == (2, 32, 32, 3)
    for images in got:
        np.testing.assert_allclose(images.numpy(), want, atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("name", ["tp", "sp"])
def test_int8_generate_matches_jax(two_ranks, jax_refs, sp_tp_inputs, name):
    """Generate under int8 at tp = 2 and at sp = 2 against JAX's unsharded
    int8 generate within JAX's flip-noise bounds (mean |diff| < 2e-2, max <
    2e-1; `test_parallel_inference.py`). At tp = 2 also bit for bit the
    port's one-process int8 generate: the row-split layers quantise with the
    whole row's amax and the whole weight's scales, and sum the int32
    accumulators before the epilogue. (At sp = 2 GroupNorm's reduced sums
    round otherwise, which can flip a code; each convolution quantises with
    the group's amax.)"""
    pipe = tiny_bundle(sp_tp_inputs["weights"])
    pipe.quantize = "int8"
    one, _ = pipe.generate(SP_PROMPTS, latent=torch.from_numpy(sp_tp_inputs["latents"]["int8"]))
    for rank in two_ranks["ranks"]:
        got = rank[f"{name}_int8_generate"][0]
        diff = np.abs(got.numpy() - jax_refs["int8"])
        assert diff.mean() < 2e-2 and diff.max() < 2e-1, (diff.mean(), diff.max())
        if name == "tp":
            assert torch.equal(got, one)


def test_tp_slices_follow_param_sharding(two_ranks, sp_tp_inputs):
    """Each tp rank holds, of every tensor `param_sharding` splits over tp,
    its block along the axis it names: the r-th of to_q/k/v's out-features
    (whole heads), of to_out.0's and net.2's in-features, and of GEGLU
    proj's out-features taken from its value half and from its gate half
    alike, its bias with them (JAX keeps that bias whole, and GSPMD slices
    the sum); every other tensor whole."""
    full = sp_tp_inputs["weights"]["reverse"]
    specs = param_sharding(full, Mesh(tp=2))
    for key in full:  # the GEGLU bias follows its weight's rows
        if key.endswith(".ff.net.0.proj.bias"):
            specs[key] = ("tp",)
    owners = set()
    for r, rank in enumerate(two_ranks["ranks"]):
        got = rank["tp_state"]
        assert got.keys() == full.keys()
        for key, t in full.items():
            axis = next((i for i, a in enumerate(specs[key]) if a == "tp"), None)
            if axis is None:
                want = t
            elif ".ff.net.0.proj." in key:
                value, gate = t.chunk(2, 0)
                want = torch.cat([value.chunk(2, 0)[r], gate.chunk(2, 0)[r]])
            else:
                want = t.chunk(2, axis)[r]
            assert torch.equal(got[key], want), key
            if axis is not None:
                owners.add(key.split(".")[-2] if key.split(".")[-2] != "0" else "to_out.0")
    assert owners == {"to_q", "to_k", "to_v", "to_out.0", "proj", "2"}  # net.2's last part


def test_tp_adapter_slices_follow_param_sharding(sp_tp_inputs):
    """`tp_slice_lora` (the train step's cut of an adapter dict, by the
    same `tp_plan` as `tensor_parallel`'s layers) gives rank r, for a layer
    split on its out-features, the rows of `up` that its weight keeps (the
    r-th block for q/k/v, the value and gate blocks for GEGLU's proj) with
    `down` whole, and for one split on its in-features (to_out.0, net.2) the
    r-th block of `down`'s columns with `up` whole; every other adapter
    whole. Rank 0's and rank 1's slices of a split factor make up the
    whole."""
    full = sp_tp_inputs["weights"]["reverse"]
    unet = UNet2DCondition(UNetConfig.tiny())
    lora = {k: v for k, v in sp_tp_inputs["fsdp_tp"]["state"].lora_reverse.items()}
    specs = param_sharding(full, Mesh(tp=2))
    split = 0
    slices = [tp_slice_lora(lora, tp_plan(unet, Mesh(tp=2, rank=r))) for r in range(2)]
    for key, ab in lora.items():
        axis = next((i for i, a in enumerate(specs[key]) if a == "tp"), None)
        for r, got in enumerate(slices):
            if axis is None:
                assert got[key]["down"] is ab["down"] and got[key]["up"] is ab["up"], key
            elif axis == 0:
                up = ab["up"]
                if ".ff.net.0.proj." in key:
                    value, gate = up.chunk(2, 0)
                    want = torch.cat([value.chunk(2, 0)[r], gate.chunk(2, 0)[r]])
                else:
                    want = up.chunk(2, 0)[r]
                assert torch.equal(got[key]["up"], want) and got[key]["down"] is ab["down"], key
            else:
                assert torch.equal(got[key]["down"], ab["down"].chunk(2, 1)[r]), key
                assert got[key]["up"] is ab["up"], key
        if axis is not None:
            split += 1
            name = "up" if axis == 0 else "down"
            assert slices[0][key][name].numel() + slices[1][key][name].numel() == ab[name].numel()
    assert split == sum(1 for key in lora if any(a == "tp" for a in specs[key])) > 0


def test_sp_serving_matches_executor(two_ranks, sp_tp_inputs):
    """A burst of two served at dp = 1 x sp = 2 (each rank half of every
    latent's height; rank 0 the executor, rank 1 `serve_follower`) against
    the one-process executor's batch, at `test_serving.py`'s 2e-5 / 1e-4."""
    rank0, rank1 = two_ranks["ranks"]
    assert rank0["sp_serve_stats"]["batches"] == 1 and rank1["sp_served_batches"] == 1
    pipe = tiny_bundle(sp_tp_inputs["weights"])
    with BatchingExecutor(pipe, batch_size=2, max_delay=1.0) as ex:
        futs = [ex.submit(p, seed=s) for p, s in zip(SP_SERVE["prompts"], SP_SERVE["seeds"])]
        want = np.stack([f.result(timeout=120) for f in futs])
    assert rank0["sp_served"].shape == want.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(rank0["sp_served"], want, rtol=1e-4, atol=2e-5)


@pytest.mark.slow  # one compiled JAX step on a four-device mesh
def test_fsdp_tp_step_matches_jax(four_ranks, jpipe, sp_tp_inputs):
    """JAX's own `make_train_step` on `make_mesh(dp=1, fsdp=2, tp=2)` with
    `shard_params` (as `__graft_entry__.py`'s dry run does) from the same
    state, batch and key, against each rank of the port's fsdp 2 x tp 2
    step: the draws the port's case took are those JAX makes from the key;
    the metrics within 1e-4 relative (grad norms 1e-3), Adam's first
    moments within rtol 1e-3 and 1e-4 x their largest entry and the moves
    within 5e-7 where |mu| > 1e-6 (`test_torch_training.py`'s tolerances
    against JAX's step)."""
    from invertible_cd_tpu.diffusion.schedule import make_schedule as j_make_schedule
    from invertible_cd_tpu.diffusion.solver import make_train_solver as j_make_train_solver
    from invertible_cd_tpu.parallel import shard_params as jshard_params
    from invertible_cd_tpu.training import trainer as JT
    from invertible_cd_tpu.training.losses import LossConfig as JLossConfig

    jcfg = JT.TrainConfig(lora_rank=4, loss=JLossConfig(w_embed_dim=UNetConfig.tiny().time_cond_proj_dim))
    rng = jax.random.PRNGKey(FSDP_TP_KEY)
    _, k_w, k_r, k_f, k_fp, k_rp = jax.random.split(rng, 6)

    def index(key, n):
        return np.asarray(jax.random.randint(key, (B,), 0, n)).tolist()
    assert FSDP_TP_DRAWS == {"w": np.asarray(JT.sample_w(k_w, B, jcfg)).tolist(),
                             "reverse_index": index(k_r, 50), "forward_index": index(k_f, 49),
                             "forward_preserve_index": index(k_fp, 4),
                             "reverse_preserve_index": index(k_rp, 4)}
    inputs = sp_tp_inputs["fsdp_tp"]
    base = jpipe.params["reverse"]
    lora_r, lora_f = (jax.tree.map(jnp.asarray, _flax_lora(base["params"], seed)) for seed in (7, 8))
    jschedule = j_make_schedule()
    jsolver = j_make_train_solver(
        np.asarray(jschedule.alphas_cumprod), num_endpoints=4, num_forward_endpoints=4,
        endpoints="0,259,519,779", forward_endpoints="259,519,779,999")
    jopt = JT.make_optimizer(jcfg)
    mesh = jmake_mesh(dp=1, fsdp=2, tp=2, devices=jax.devices()[:4])
    with mesh:
        sharded = jshard_params(base, mesh)
        jstate = JT.ICDTrainState(step=jnp.zeros((), jnp.int32), lora_reverse=lora_r,
                                  lora_forward=lora_f, opt_reverse=jopt.init(lora_r),
                                  opt_forward=jopt.init(lora_f))
        jstep = JT.make_train_step(jpipe.unet, sharded, sharded, jsolver, jschedule, jcfg)
        batch = jshard_batch({k: v.numpy() for k, v in inputs["batch"].items()}, mesh)
        jnew, jmetrics = jstep(jstate, sharded, sharded, batch, rng)
        jax.block_until_ready(jmetrics)
    want = {"lora_reverse": convert.lora_from_flax(jax.tree.map(np.asarray, jnew.lora_reverse)),
            "lora_forward": convert.lora_from_flax(jax.tree.map(np.asarray, jnew.lora_forward)),
            "mu_reverse": convert.lora_from_flax(jax.tree.map(np.asarray, jnew.opt_reverse[1][0].mu)),
            "mu_forward": convert.lora_from_flax(jax.tree.map(np.asarray, jnew.opt_forward[1][0].mu))}
    for rank in four_ranks:
        got = rank["train"]["steps"]["fsdp_tp"]
        assert sorted(got["metrics"]) == sorted(jmetrics)
        for name, value in jmetrics.items():
            rtol = 1e-3 if name.endswith("grad_norm") else 1e-4
            np.testing.assert_allclose(got["metrics"][name], float(value), rtol=rtol, err_msg=name)
        for student in ("reverse", "forward"):
            old = _flat(getattr(inputs["state"], f"lora_{student}"))
            new = _flat(getattr(got["state"], f"lora_{student}"))
            mu = _flat(got["state"].__dict__[f"opt_{student}"]["mu"])
            want_new, want_mu = _flat(want[f"lora_{student}"]), _flat(want[f"mu_{student}"])
            peak = max(float(m.abs().max()) for m in want_mu.values())
            for key in want_mu:
                np.testing.assert_allclose(mu[key].numpy(), want_mu[key].numpy(), rtol=1e-3,
                                           atol=1e-4 * peak, err_msg=f"{student} mu {key}")
                clear = want_mu[key].abs() > 1e-6
                np.testing.assert_allclose((new[key] - old[key])[clear].numpy(),
                                           (want_new[key] - old[key])[clear].numpy(), atol=5e-7,
                                           rtol=0, err_msg=f"{student} {key}")
