"""The port's generate and edit entry points (`invertible_cd_tpu_torch/cli/`)
on the CPU, and the helpers they share with the JAX CLIs.

The CLI logic is held to the JAX CLIs' own functions on the same inputs:
`find_difference` and `_build_edit_controller` (the controller arrays
exactly, as `test_torch_edit.py` holds `make_controller`), `load_benchmark`
on every CSV under `benchmarks/`, and the parsed flags of every
`configs/*.json`. End to end the CLIs run on `--model tiny --device cpu`
(seeded tiny weights), and every image file they write must hold exactly
the pipeline call they made, recomputed here with the same generator: the
file's bytes equal PIL's JPEG encoding of `to_uint8` of that call. The
pipeline calls themselves are held to JAX by `test_torch_pipeline.py`,
`test_torch_edit_pipeline.py` and `test_torch_baselines.py`.
"""
import argparse
import ast
import dataclasses
import glob
import io
import json
import os
import pickle
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import cli.edit as jedit
import cli.generate as jgenerate
from invertible_cd_tpu.data import benchmarks as jbenchmarks
from invertible_cd_tpu.utils.tokenizer import HashTokenizer as JHashTokenizer
from invertible_cd_tpu_torch.cli import edit, generate, serve, train_icd
from invertible_cd_tpu_torch.data import load_benchmark
from invertible_cd_tpu_torch.edit import make_controller
from invertible_cd_tpu_torch.pipelines import nti
from invertible_cd_tpu_torch.pipelines import sampler as S
from invertible_cd_tpu_torch.pipelines.pipeline import load_512, to_uint8
from invertible_cd_tpu_torch.testing import tiny_bundle_xl
from invertible_cd_tpu_torch.utils.images import encode_png
from invertible_cd_tpu_torch.utils.tokenizer import HashTokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC, TGT = "a cat on the beach", "a dog on the beach"
TINY = ["--model", "tiny", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's tiny models (see
    `test_torch_baselines.py`)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _holds(path, image):
    """The file at `path` is PIL's JPEG of the uint8 `image`."""
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="JPEG")
    with open(path, "rb") as f:
        assert f.read() == buf.getvalue(), path


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _write_image(path, seed, size=32):
    img = np.random.default_rng(seed).integers(0, 256, (size, size, 3), np.uint8)
    Image.fromarray(img).save(path)
    return str(path)


# ---------------------------------------------------------------------------
# CLI logic against the JAX CLIs' functions
# ---------------------------------------------------------------------------
PAIRS = [  # (source, target, the benchmark's blend pair)
    ("a photo of a cat on the beach", "a photo of a dog on the beach", ("cat", "dog")),
    ("a photo of a cat on the beach", "a photo of a dog on the beach", ()),
    ("a red car in the city", "a blue truck in the city", ()),
    ("a cat sitting on a mat", "a big fluffy cat sitting on a mat", ()),
    ("the cat on the mat", "the cat on a mat", ()),
]
MODES = [[], ["--amplify", "0"], ["--amplify", "2"], ["--no_blend"], ["--is_replacement"],
         ["--is_replacement", "--amplify", "5", "--no_blend"]]
CASES = [(pair, mode) for pair in PAIRS for mode in MODES
         if "--is_replacement" not in mode or len(pair[0].split()) == len(pair[1].split())]


@pytest.mark.parametrize("pair", PAIRS, ids=[f"{p[0]}>{p[1]}" for p in PAIRS])
def test_find_difference_matches_jax(pair):
    assert edit.find_difference(*pair[:2]) == jedit.find_difference(*pair[:2])


@pytest.mark.parametrize("pair,mode", CASES, ids=[f"{p[1]}|{' '.join(m)}" for p, m in CASES])
def test_edit_controller_matches_jax(pair, mode):
    src, tgt, blend = pair
    argv = ["--out", "unused", *mode]
    args, jargs = edit.parse_args(argv), jedit.parse_args(argv)
    port_pipe = types.SimpleNamespace(tokenizer=HashTokenizer(1000))
    jax_pipe = types.SimpleNamespace(tokenizer=JHashTokenizer(1000))
    for steps in (4, 50):
        spec, arrays = edit._build_edit_controller(port_pipe, args, src, tgt, blend, steps)
        jspec, jarrays = jedit._build_edit_controller(jax_pipe, jargs, src, tgt, blend, steps)
        assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
        for f in dataclasses.fields(arrays):
            got, want = getattr(arrays, f.name), np.asarray(getattr(jarrays, f.name))
            assert tuple(got.shape) == want.shape, f.name
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f.name)


BENCH_CASES = [
    ("generation_coco_standin.csv", dict(kind="generation")),
    ("generation_coco_standin.csv", dict(kind=None, with_files=True, max_count=3)),
    ("generation_parti_standin.csv", dict(kind="generation", with_files=True)),
    ("generation_parti_standin.csv", dict(kind=None, max_count=2)),
    ("piebench140_standin.csv", dict(kind=None)),
    ("piebench140_standin.csv", dict(kind="editing", max_count=5)),
]


@pytest.mark.parametrize("name,kw", BENCH_CASES, ids=[f"{n}-{k}" for n, k in BENCH_CASES])
def test_load_benchmark_matches_jax(name, kw):
    path = os.path.join(REPO, "benchmarks", name)
    got, want = load_benchmark(path, **kw), jbenchmarks.load_benchmark(path, **kw)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        if dataclasses.is_dataclass(w):
            assert dataclasses.astuple(g) == dataclasses.astuple(w)
        else:
            assert g == w


CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.json")))


# the configs' model keys, flags of the port's generate and edit CLIs only
# (`generate.add_model_args`): JAX's parsers drop them without a word
MODEL_FLAGS = {"resolution", "w_embed_dim", "start_timestep", "lora_rank", "lora_alpha"}


@pytest.mark.parametrize("cli", ["generate", "edit"])
@pytest.mark.parametrize("config", CONFIGS, ids=[os.path.basename(c) for c in CONFIGS])
def test_config_file_defaults_match_jax(cli, config):
    """`--config` gives the same parsed values as the JAX CLI's; the port's
    parser has every flag of the JAX one it keeps, plus `--device` and the
    configs' model keys (and, in edit, the generation `tau1`), which JAX's
    parsers drop and the port's parse, to hold against the bundle."""
    port, jax_cli = {"generate": (generate, jgenerate), "edit": (edit, jedit)}[cli]
    argv = ["--config", config, "--out", "unused"]
    got, want = vars(port.parse_args(argv)), vars(jax_cli.parse_args(argv))
    with open(config) as f:
        cfg = json.load(f)
    port_only = {"device"} | MODEL_FLAGS | ({"tau1"} if cli == "edit" else set())
    assert set(got) - set(want) == port_only
    assert {k: got[k] for k in got if k in want} == {k: want[k] for k in got if k in want}
    assert all(got[k] == cfg.get(k) for k in port_only - {"device"})
    assert any(k in got and got[k] == v for k, v in cfg.items())


@pytest.mark.parametrize("cli,flags", [
    (serve, ["--platform", "cpu"]), (train_icd, ["--split_step"]),
    (generate, ["--platform", "cpu"]), (train_icd, ["--platform", "cpu"]),
    (edit, ["--platform", "cpu"]), (serve, ["--platform", "tpu"]), (generate, ["--platform", "tpu"]),
])
def test_flags_not_ported_are_refused(cli, flags):
    required = {serve: [], train_icd: ["--output_dir", "unused"]}.get(cli, ["--out", "unused"])
    with pytest.raises(SystemExit):
        cli.parse_args([*required, *flags])


@pytest.mark.parametrize("flags,error", [
    ([], None), (["--sp", "1"], None), (["--sp", "2"], r"\(1, 1, 2, 1\)"),
    (["--dp", "1", "--sp", "2"], "mesh 1x1x2x1 != 1 devices"),
])
def test_serve_sp_flag_builds_the_mesh(flags, error):
    """`--sp` as JAX's (default 1): no mesh for one process at sp = 1;
    `--sp` alone fills dp with world // sp, an explicit dp needs a world of
    dp x sp, and one process is not one (JAX's assertion texts)."""
    args = serve.parse_args(flags)
    assert args.sp == (int(flags[-1]) if "--sp" in flags else 1)
    if error is None:
        assert serve.serving_mesh(args) is None
        return
    with pytest.raises(AssertionError, match=error):
        serve.serving_mesh(args)


# JAX flags the port's parsers leave out: the backend choice and the
# two-program train step (an eager step has no program to split)
NOT_PORTED_FLAGS = {"--platform", "--split_step"}


class _Parser(Exception):
    pass


def _jax_cli_flags(name):
    """The flags JAX's `cli/<name>.py` declares, read by AST (no JAX import)."""
    with open(os.path.join(REPO, "cli", f"{name}.py")) as f:
        tree = ast.parse(f.read())
    return {node.args[0].value for node in ast.walk(tree)
            if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument"
            and node.args and isinstance(node.args[0], ast.Constant)
            and str(node.args[0].value).startswith("--")}


@pytest.mark.parametrize("name", ["train_icd", "generate", "edit", "serve"])
def test_jax_cli_flags_are_port_flags(name, monkeypatch):
    """Every flag of the JAX CLI is a flag of the port's, but for
    `NOT_PORTED_FLAGS`, which the port's parser does not have."""
    cli = {"train_icd": train_icd, "generate": generate, "edit": edit, "serve": serve}[name]

    def capture(self, *args, **kwargs):
        raise _Parser(self)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parser) as got:
        cli.parse_args([])
    port = {o for action in got.value.args[0]._actions for o in action.option_strings}
    want = _jax_cli_flags(name)
    assert len(want) > 5
    assert sorted(want - port - NOT_PORTED_FLAGS) == []
    assert not port & NOT_PORTED_FLAGS


@pytest.mark.parametrize("shape", [(1, 1), (17, 33), (32, 32)])
def test_encode_png_decodes_to_the_image(shape):
    img = np.random.default_rng(shape[1]).integers(0, 256, shape + (3,), np.uint8)
    png = encode_png(img)
    decoded = Image.open(io.BytesIO(png))
    assert decoded.format == "PNG" and decoded.mode == "RGB"
    np.testing.assert_array_equal(np.asarray(decoded), img)
    with pytest.raises(ValueError):
        encode_png(img.astype(np.float32))


# ---------------------------------------------------------------------------
# generate, end to end on the tiny bundle
# ---------------------------------------------------------------------------
def _tiny_pipe(cli, argv):
    return generate.build_pipeline(cli.parse_args(argv))


def _guidance(pipe):
    return pipe.default_guidance(guidance_scale=19.0, dynamic_guidance=True, tau1=0.8, tau2=0.8)


@pytest.mark.parametrize("mode", ["prompts", "benchmark", "benchmark_ddim"])
def test_generate_cli(tmp_path, mode):
    """`--prompt` x2 (one batch), and a `--benchmark` sweep with `--max_cnt`
    3 at batch 2 (the last batch runs at 1, from seed + 2), with the
    consistency model or the DDIM teacher on a 4-step grid."""
    out = str(tmp_path / "out")
    if mode == "prompts":
        argv = TINY + ["--prompt", "a cat", "--prompt", "a dog", "--out", out]
        prompts, batches = ["a cat", "a dog"], [(0, 2)]
    else:
        argv = TINY + ["--benchmark", os.path.join(REPO, "benchmarks", "generation_coco_standin.csv"),
                       "--max_cnt", "3", "--batch_size", "2", "--out", out]
        if mode == "benchmark_ddim":
            argv += ["--ddim_baseline", "--num_ddim_steps", "4"]
        prompts = jbenchmarks.load_benchmark(argv[argv.index("--benchmark") + 1], max_count=3)
        batches = [(0, 2), (2, 3)]
    generate.main(argv)
    pipe = _tiny_pipe(generate, argv)
    with open(os.path.join(out, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["prompts"] == prompts
    assert manifest["files"] == [os.path.join(out, f"{i:06d}.jpg") for i in range(len(prompts))]
    for lo, hi in batches:
        if mode == "benchmark_ddim":
            imgs, _ = pipe.ddim_generate(prompts[lo:hi], generator=_gen(150 + lo))
        else:
            imgs, _ = pipe.generate(prompts[lo:hi], generator=_gen(150 + lo), guidance=_guidance(pipe))
        for j, img in enumerate(to_uint8(imgs)):
            _holds(manifest["files"][lo + j], img)


@pytest.mark.parametrize("cons", [True, False], ids=["cons", "ddim"])
def test_generate_cli_reconstruct(tmp_path, cons):
    """`--image_root`: each real image inverted under its caption, forward
    CD (noise from seed + i) or `--no-cons_inversion` (the DDIM inversion on
    a 4-step grid), then generated from the inversion."""
    csv = os.path.join(REPO, "benchmarks", "generation_coco_standin.csv")
    rows = jbenchmarks.load_benchmark(csv, kind="generation", max_count=3, with_files=True)
    root = tmp_path / "images"
    root.mkdir()
    for i, (name, _) in enumerate(rows):
        _write_image(root / name, i, size=40)
    out = str(tmp_path / "out")
    argv = TINY + ["--benchmark", csv, "--max_cnt", "3", "--batch_size", "2", "--image_root",
                   str(root), "--out", out]
    if not cons:
        argv += ["--no-cons_inversion", "--num_ddim_steps", "4"]
    generate.main(argv)
    pipe = _tiny_pipe(generate, argv)
    with open(os.path.join(out, "reconstruction_metrics.json")) as f:
        assert json.load(f) == {"n_images": 3}
    for lo, hi in [(0, 2), (2, 3)]:
        caps = [c for _, c in rows[lo:hi]]
        reals = np.stack([load_512(str(root / n), size=32) for n, _ in rows[lo:hi]])
        if cons:
            lat, _ = pipe.invert(reals, caps, guidance=pipe.default_guidance(guidance_scale=0.0),
                                 generator=_gen(150 + lo))
            imgs, _ = pipe.generate(caps, latent=lat, guidance=_guidance(pipe))
        else:
            traj, _ = pipe.ddim_invert(reals, caps, guidance=S.GuidanceConfig(1.0, w_embed_dim=0))
            imgs, _ = pipe.ddim_generate(caps, latent=traj[-1])
        for j, (real, rec) in enumerate(zip(reals, to_uint8(imgs))):
            _holds(os.path.join(out, "real_images", f"{lo + j:06d}.jpg"), real)
            _holds(os.path.join(out, "generated_images", f"{lo + j:06d}.jpg"), rec)


def test_generate_cli_image_root_needs_benchmark(tmp_path):
    with pytest.raises(SystemExit, match="needs --benchmark"):
        generate.main(TINY + ["--image_root", str(tmp_path), "--out", str(tmp_path / "out")])


# ---------------------------------------------------------------------------
# edit, end to end on the tiny bundle
# ---------------------------------------------------------------------------
def _edit_ref(pipe, image, baseline, uncond=None, inner=2):
    """(reconstruction, edit) uint8 of the pipeline calls the edit CLI
    makes for SRC -> TGT at its defaults (blend cat/dog from the prompt
    difference, no equalizer)."""
    kw = dict(cross_replace_steps=0.6, self_replace_steps=0.4, blend_words=[["cat"], ["dog"]])
    if baseline == "none":
        ctrl = make_controller([SRC, TGT], pipe.tokenizer, pipe.grid.num_reverse_steps, **kw)
        g = pipe.default_guidance(guidance_scale=19.0, dynamic_guidance=True, tau1=0.8, tau2=0.8,
                                  edit_pair=True)
        imgs, _ = pipe.edit(image, SRC, TGT, ctrl, generator=_gen(0), guidance=g)
        return to_uint8(imgs)
    n = pipe.grid.n_steps
    traj, _ = pipe.ddim_invert(image, SRC)
    if baseline == "nti" and uncond is None:
        uncond, _ = nti.null_text_inversion(pipe, image, SRC, num_inner_steps=inner,
                                            guidance_scale=8.0, trajectory=traj)
    elif baseline == "npi":
        uncond = nti.negative_prompt_inversion(pipe, SRC)
    if uncond is not None:
        uncond = torch.as_tensor(uncond).expand((n, 2) + tuple(uncond.shape[2:]))
    g = S.GuidanceConfig(guidance_scale=8.0, w_embed_dim=0, dynamic_guidance=True, tau1=0.8, tau2=0.8)
    imgs, _ = pipe.ddim_generate(
        [SRC, TGT], latent=traj[-1][:1].expand((2,) + tuple(traj.shape[2:])), guidance=g,
        controller=make_controller([SRC, TGT], pipe.tokenizer, n, **kw), nti_uncond=uncond,
        model="teacher")
    return to_uint8(imgs)


def _run_edit(tmp_path, image, *extra, _pipe=None, model=TINY):
    out = str(tmp_path / "out")
    argv = model + ["--image", image, "--source", SRC, "--target", TGT, "--out", out,
                    "--num_ddim_steps", "4", *extra]
    edit.main(argv, _pipe=_pipe)
    with open(os.path.join(out, "results.json")) as f:
        res = json.load(f)
    assert res == {"results": [{"file": os.path.join(out, "00000_edited.jpg"), "source": SRC,
                                "target": TGT}]}
    return argv, res["results"][0]["file"]


@pytest.mark.parametrize("baseline", ["none", "ddim", "npi", "nti"])
def test_edit_cli(tmp_path, baseline):
    image = _write_image(tmp_path / "in.png", 3)
    argv, edited = _run_edit(tmp_path, image, "--baseline", baseline, "--nti_inner_steps", "2")
    pipe = _tiny_pipe(edit, argv)
    rec, want = _edit_ref(pipe, load_512(image, size=32), baseline)
    _holds(edited, want)
    _holds(edited.replace("_edited", "_rec"), rec)


def test_edit_cli_nti_cache_is_read_and_readable_by_jax(tmp_path, monkeypatch):
    """The NTI cache the CLI writes (JAX's format: {source prompt: float32
    (n_steps, 1, 77, D)}) is read on the next run, which then calls no NTI
    and writes the same files; JAX's CLI reads it too."""
    image = _write_image(tmp_path / "in.png", 4)
    cache = str(tmp_path / "uncond.pkl")
    flags = ["--baseline", "nti", "--nti_inner_steps", "2", "--uncond_cache", cache]
    argv, edited = _run_edit(tmp_path, image, *flags)
    with open(edited, "rb") as f:
        first = f.read()
    with open(cache, "rb") as f:
        stored = pickle.load(f)
    assert list(stored) == [SRC]
    assert isinstance(stored[SRC], np.ndarray) and stored[SRC].dtype == np.float32
    assert stored[SRC].shape[:3] == (4, 1, 77)
    pipe = _tiny_pipe(edit, argv)
    img = load_512(image, size=32)
    want, _ = nti.null_text_inversion(pipe, img, SRC, num_inner_steps=2, guidance_scale=8.0)
    np.testing.assert_array_equal(stored[SRC], want.numpy())

    def no_nti(*a, **kw):
        raise AssertionError("NTI ran although the cache holds the prompt")
    monkeypatch.setattr(nti, "null_text_inversion", no_nti)
    _run_edit(tmp_path, image, *flags)
    with open(edited, "rb") as f:
        assert f.read() == first
    got = jedit._cached_nti(types.SimpleNamespace(grid=types.SimpleNamespace(n_steps=4)),
                            types.SimpleNamespace(uncond_cache=cache), None, SRC)
    np.testing.assert_array_equal(np.asarray(got), want.numpy())


def test_edit_cli_reads_a_jax_written_cache(tmp_path, monkeypatch):
    """A cache written as the JAX CLI writes it (`np.asarray` of a jax
    array) is used as it stands."""
    image = _write_image(tmp_path / "in.png", 5)
    pipe = _tiny_pipe(edit, TINY + ["--out", "unused", "--num_ddim_steps", "4"])
    d = pipe.text_encoder.cfg.hidden_size
    uncond = 0.1 * np.random.default_rng(6).standard_normal((4, 1, 77, d)).astype(np.float32)
    cache = str(tmp_path / "uncond.pkl")
    with open(cache, "wb") as f:
        pickle.dump({SRC: np.asarray(jnp.asarray(uncond))}, f)
    monkeypatch.setattr(nti, "null_text_inversion", None)  # must not be called
    _, edited = _run_edit(tmp_path, image, "--baseline", "nti", "--uncond_cache", cache)
    rec, want = _edit_ref(pipe, load_512(image, size=32), "nti", uncond=torch.from_numpy(uncond))
    _holds(edited, want)


def test_edit_cli_nti_cache_stale_grid_recomputed(tmp_path):
    """An entry from another grid (6 steps) is recomputed on the 4-step
    grid and replaced."""
    image = _write_image(tmp_path / "in.png", 7)
    cache = str(tmp_path / "uncond.pkl")
    with open(cache, "wb") as f:
        pickle.dump({SRC: np.zeros((6, 1, 77, 32), np.float32), "other": np.ones(3)}, f)
    argv, edited = _run_edit(tmp_path, image, "--baseline", "nti", "--nti_inner_steps", "2",
                             "--uncond_cache", cache)
    with open(cache, "rb") as f:
        stored = pickle.load(f)
    assert sorted(stored) == ["a cat on the beach", "other"] and stored[SRC].shape[0] == 4
    _holds(edited, _edit_ref(_tiny_pipe(edit, argv), load_512(image, size=32), "nti")[1])


def test_edit_cli_is_replacement_filter(tmp_path):
    """--is_replacement keeps only one-word same-length swaps, and edits
    them under the replace controller with blend and equalizer (3) on the
    swapped pair."""
    root = tmp_path / "images"
    root.mkdir()
    csv = tmp_path / "edits.csv"
    csv.write_text(
        "file_name,old_caption,edited_caption,blended_words\n"
        "0.png,a cat on grass,a dog on grass,cat dog\n"
        "1.png,a cat on grass,a big dog on grass,cat dog\n"
        "2.png,a red cat on grass,a blue dog on grass,cat dog\n")
    for i in range(3):
        _write_image(root / f"{i}.png", 10 + i)
    out = str(tmp_path / "out")
    argv = TINY + ["--benchmark", str(csv), "--image_root", str(root), "--out", out,
                   "--is_replacement"]
    edit.main(argv)
    with open(os.path.join(out, "results.json")) as f:
        res = json.load(f)
    assert [r["source"] for r in res["results"]] == ["a cat on grass"]
    pipe = _tiny_pipe(edit, argv)
    ctrl = make_controller(["a cat on grass", "a dog on grass"], pipe.tokenizer, 4,
                           cross_replace_steps=0.6, self_replace_steps=0.4,
                           blend_words=[["cat"], ["dog"]],
                           equalizer_params={"words": ("dog",), "values": (3.0,)})
    g = pipe.default_guidance(guidance_scale=19.0, dynamic_guidance=True, tau1=0.8, tau2=0.8,
                              edit_pair=True)
    imgs, _ = pipe.edit(load_512(str(root / "0.png"), size=32), "a cat on grass", "a dog on grass",
                        ctrl, generator=_gen(0), guidance=g)
    _holds(res["results"][0]["file"], to_uint8(imgs)[1])


def test_edit_cli_refuses_sdxl_baseline(tmp_path):
    with pytest.raises(SystemExit, match="SD1.5-only"):
        edit.main(["--model", "sdxl", "--device", "cpu", "--image", "unused", "--source", "a cat",
                   "--target", "a dog", "--out", str(tmp_path / "out"), "--baseline", "nti"])


def test_edit_cli_sdxl_amplify(tmp_path):
    """SDXL edits by the amplify protocol (no controller) on the tiny XL
    bundle passed in as `_pipe`."""
    image = _write_image(tmp_path / "in.png", 8)
    xl = tiny_bundle_xl(None)
    _, edited = _run_edit(tmp_path, image, _pipe=xl, model=["--model", "sdxl", "--device", "cpu"])
    g = xl.default_guidance(guidance_scale=19.0, dynamic_guidance=True, tau1=0.8, tau2=0.8)
    imgs, _ = xl.edit(load_512(image, size=32), SRC, TGT, generator=_gen(0), guidance=g)
    rec, want = to_uint8(imgs)
    _holds(edited, want)
    _holds(edited.replace("_edited", "_rec"), rec)


@pytest.mark.parametrize("argv", [[], ["--embed_guidance"]])
def test_train_cli_embed_guidance(argv):
    """`--embed_guidance` parses as in JAX's train CLI (`store_true`, on by
    default) and reaches `LossConfig.embed_guidance`."""
    args = train_icd.parse_args(["--output_dir", "unused", *argv])
    assert args.embed_guidance is True
    assert train_icd.train_config(args, train_icd.unet_config("sd15")).loss.embed_guidance is True
