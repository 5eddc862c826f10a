"""Image editing entry point of the PyTorch port.

    python -m invertible_cd_tpu_torch.cli.edit --model sd15 --image in.jpg \\
        --source "a photo of a corgi" --target "a photo of a cat" --out runs/edit
    python -m invertible_cd_tpu_torch.cli.edit --model sd15 --benchmark edits.csv \\
        --image_root images/ --baseline nti --uncond_cache runs/uncond.pkl --out runs/nti

Counterpart of `cli/edit.py`. Per benchmark row (or the single image):
forward-CD inversion under the source prompt, the prompt-to-prompt
controller (replace or refine by word counts, blend and equalizer words from
the prompt difference with stopwords filtered), the reverse-CD [source,
target] pair; `<i>_edited.jpg` and `<i>_rec.jpg` are written and listed in
`results.json`. `--baseline ddim|npi|nti` runs the 50-step DDIM inversion
and the controlled DDIM pair with the teacher instead (SD1.5 only), with
null-text inversion's per-step contexts cached by source prompt in
`--uncond_cache` (a pickle of {prompt: (n_steps, 1, 77, D) float32 array},
the JAX package's format, so either package reads the other's cache).
SDXL edits without a controller (the amplify protocol,
`InvertibleCDXL.edit`).

The device, dtype and weights are those of `cli.generate.build_pipeline`.
`results.json` has no `compiled_executables` census: the port runs eagerly
and compiles no programs. `--calc_metrics` scores each edit with the scorer
weights flags of `cli.generate` (`Evaluators.calc_all`: CLIP image-image and
DINOv2 between the original and the edited image, CLIP image-text and
ImageReward of the edited image against the target prompt) and writes the
means to `results.json` under "metrics" (None for a scorer whose weights are
not given). A model config's keys are flags too (`generate.add_model_args`,
checked against the bundle; `--tau1`, reported where it differs from
`--tau`). `--quantize` as in `cli.generate` (the DDIM inversion and
reconstruction of the baselines quantised too; NTI's optimisation stays
float, as in the JAX package). Over several processes (`torchrun`, one card
each) rank r edits rows r, r + N, ..., writing each under its global index,
and rank 0 writes `results.json` with every rank's rows and metrics
gathered (JAX's processes each write their own stride's).

    python -m invertible_cd_tpu_torch.cli.edit --model tiny --device cpu --quantize int8 \\
        --image in.png --source "a cat" --target "a dog" --out runs/edit_int8
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import tempfile

import numpy as np
import torch

from . import apply_config_file
from .generate import (
    METRICS_NOTE, _generator, add_grid_args, add_model_args, add_quantize_arg, add_scorer_args,
    add_weights_args, build_evaluators, build_pipeline, cli_mesh, mean_or_none, quantized,
    save_image)
from ..data import load_benchmark
from ..parallel import all_gather_in_order, is_main, stride
from ..edit import make_controller
from ..pipelines import nti as nti_mod
from ..pipelines import sampler as S
from ..pipelines.pipeline import load_512, to_uint8

STOPWORDS = {
    "a", "an", "the", "of", "on", "in", "at", "and", "is", "are", "with",
    "to", "for", "by", "from", "its", "his", "her",
}


def find_difference(source: str, target: str):
    """Word-level diff -> (blend words, changed target words) with stopword
    filtering (the reference's `find_difference*`, `edit.py:31-56`)."""
    sw, tw = source.split(), target.split()
    if len(sw) == len(tw):
        changed = [(a, b) for a, b in zip(sw, tw) if a != b and b.lower() not in STOPWORDS]
        src_words = tuple(a for a, _ in changed)
        tgt_words = tuple(b for _, b in changed)
    else:
        src_set = {w.lower() for w in sw}
        tgt_words = tuple(w for w in tw if w.lower() not in src_set and w.lower() not in STOPWORDS)
        src_words = ()
    return src_words, tgt_words


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default=None, help="JSON config with flag defaults (configs/*.json)")
    p.add_argument("--model", default="sd15", choices=["sd15", "sdxl", "tiny"])
    p.add_argument("--image", default=None)
    p.add_argument("--source", default=None)
    p.add_argument("--target", default=None)
    p.add_argument("--benchmark", default=None)
    p.add_argument("--image_root", default=None)
    p.add_argument("--max_cnt", type=int, default=None)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--guidance_scale", type=float, default=None,
                   help="default 19.0 (cons editing) / 8.0 (DDIM baselines)")
    p.add_argument("--tau", type=float, default=0.8, help="dynamic-guidance tau1")
    p.add_argument("--tau1", type=float, default=None,
                   help="a model config's tau1 (the generate CLI's); this CLI's tau1 is --tau, "
                        "as in the JAX package's edit CLI: a --tau1 that differs is reported, "
                        "not applied")
    p.add_argument("--tau2", type=float, default=None,
                   help="dynamic-guidance tau2; defaults to --tau. tau1 < tau2 ramps the "
                        "guidance weight linearly between them")
    p.add_argument("--dynamic_guidance", action=argparse.BooleanOptionalAction, default=True,
                   help="schedule the guidance weight over t")
    p.add_argument("--baseline", default="none", choices=["none", "ddim", "npi", "nti"],
                   help="50-step DDIM-inversion editing baselines instead of the consistency "
                        "models: plain DDIM, Negative-Prompt Inversion, or Null-Text Inversion")
    p.add_argument("--nti_guidance_scale", type=float, default=8.0,
                   help="CFG scale inside the NTI optimisation")
    p.add_argument("--nti_inner_steps", type=int, default=10)
    p.add_argument("--uncond_cache", default=None,
                   help="pickle file caching NTI per-step uncond embeddings by source prompt")
    p.add_argument("--num_ddim_steps", type=int, default=50, help="DDIM grid size")
    add_quantize_arg(p)
    p.add_argument("--cross_replace_steps", type=float, default=0.6)
    p.add_argument("--self_replace_steps", type=float, default=0.4)
    p.add_argument("--no_blend", action="store_true")
    p.add_argument("--amplify", type=float, default=None,
                   help="equalizer value for changed words (reweight chain)")
    p.add_argument("--is_replacement", action="store_true",
                   help="strict single-word-replacement mode: skip benchmark rows that are not "
                        "one-word same-length replacements, force the replace controller with "
                        "blend/equalizer on the swapped pair (amplify defaults to 3)")
    add_grid_args(p)
    add_weights_args(p)
    add_model_args(p)
    p.add_argument("--calc_metrics", action="store_true")
    add_scorer_args(p)
    p.add_argument("--crop_left", type=int, default=0,
                   help="load_512 edge-crop offsets before the center square crop")
    p.add_argument("--crop_right", type=int, default=0)
    p.add_argument("--crop_top", type=int, default=0)
    p.add_argument("--crop_bottom", type=int, default=0)
    argv = apply_config_file(p, argv)
    return p.parse_args(argv)


def edit_one_sdxl(pipe, args, image, source, target):
    """SDXL editing protocol (reference `running/sdxl/edit.py:201-234`):
    forward-CD inversion under the source prompt at guidance 0, then the
    TARGET prompt sampled with dynamic guidance and the source prompt
    amplified while t > tau1 * 1000. No p2p controller."""
    tau2 = args.tau if args.tau2 is None else args.tau2
    g = pipe.default_guidance(guidance_scale=args.guidance_scale,
                              dynamic_guidance=args.dynamic_guidance, tau1=args.tau, tau2=tau2)
    imgs, _ = pipe.edit(image, source, target, generator=_generator(pipe, args.seed), guidance=g)
    u8 = to_uint8(imgs)
    return u8[0], u8[1]


def _build_edit_controller(pipe, args, source, target, blend_pair, num_steps):
    """Controller derivation shared by the cons and DDIM-baseline paths
    (reference `edit.py:405-427`): replace vs refine by word counts, blend
    words from the prompt diff, optional reweight chain."""
    if args.is_replacement:
        # force the replace controller, blend and amplify exactly the swapped
        # word pair (main() keeps only one-word same-length replacements)
        w1, w2 = next((a, b) for a, b in zip(source.split(), target.split()) if a != b)
        amp = 3.0 if args.amplify is None else args.amplify
        return make_controller(
            [source, target], pipe.tokenizer, num_steps=num_steps, is_replace_controller=True,
            cross_replace_steps=args.cross_replace_steps,
            self_replace_steps=args.self_replace_steps,
            blend_words=None if args.no_blend else [[w1], [w2]],
            equalizer_params={"words": (w2,), "values": (amp,)},
        )
    sw, tw = find_difference(source, target)
    blend_words = None
    if not args.no_blend:
        if blend_pair and len(blend_pair) >= 2:
            blend_words = [[blend_pair[0]], [blend_pair[1]]]
        elif sw and tw:
            blend_words = [list(sw), list(tw)]
    eq = None
    if args.amplify and tw:
        eq = {"words": tw, "values": (args.amplify,) * len(tw)}
    return make_controller(
        [source, target], pipe.tokenizer, num_steps=num_steps,
        is_replace_controller=len(source.split()) == len(target.split()),
        cross_replace_steps=args.cross_replace_steps,
        self_replace_steps=args.self_replace_steps,
        blend_words=blend_words, equalizer_params=eq,
    )


def _cached_nti(pipe, args, image, source, trajectory=None):
    """NTI per-step uncond embeddings (n_steps, 1, 77, D), through the
    prompt-keyed cache file (reference `running/sd1.5/edit.py:348-397`). An
    entry whose step count does not match the grid is recomputed. Writes
    merge the file anew and replace it atomically, so that sweeps sharing
    one cache path cannot corrupt it."""
    def load():
        if args.uncond_cache and os.path.exists(args.uncond_cache):
            with open(args.uncond_cache, "rb") as f:
                return pickle.load(f)
        return {}

    hit = load().get(source)
    if hit is not None and hit.shape[0] == pipe.grid.n_steps:
        return torch.as_tensor(np.asarray(hit, np.float32))
    per_step, _ = nti_mod.null_text_inversion(
        pipe, image, source, num_inner_steps=args.nti_inner_steps,
        guidance_scale=args.nti_guidance_scale, trajectory=trajectory)
    if args.uncond_cache:
        cache = load()  # merge entries written since we read
        cache[source] = per_step.float().cpu().numpy()
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(args.uncond_cache)))
        with os.fdopen(fd, "wb") as f:
            pickle.dump(cache, f)
        os.replace(tmp, args.uncond_cache)
    return per_step


def edit_one_baseline(pipe, args, image, source, target, blend_pair):
    """DDIM-inversion editing baselines (reference `edit.py:363-397`): the
    50-step DDIM inversion of the image under the source prompt with the
    teacher, per-step uncond embeddings from NTI (optimised) or NPI (the
    cond embeddings) or none (plain DDIM), then the 50-step CFG DDIM loop
    over the [source, target] pair under the p2p controller."""
    n = pipe.grid.n_steps
    traj, _ = pipe.ddim_invert(image, source)
    nti_uncond = None
    if args.baseline == "nti":
        nti_uncond = _cached_nti(pipe, args, image, source, trajectory=traj)
    elif args.baseline == "npi":
        nti_uncond = nti_mod.negative_prompt_inversion(pipe, source)
    if nti_uncond is not None:
        # optimised at batch 1; the pair shares it across both rows
        nti_uncond = nti_uncond.expand((n, 2) + tuple(nti_uncond.shape[2:]))
    ctrl = _build_edit_controller(pipe, args, source, target, blend_pair, n)
    tau2 = args.tau if args.tau2 is None else args.tau2
    g = S.GuidanceConfig(guidance_scale=args.guidance_scale, w_embed_dim=0,
                         dynamic_guidance=args.dynamic_guidance, tau1=args.tau, tau2=tau2)
    latent = traj[-1][:1].expand((2,) + tuple(traj.shape[2:]))
    imgs, _ = pipe.ddim_generate([source, target], latent=latent, guidance=g, controller=ctrl,
                                 nti_uncond=nti_uncond, model="teacher")
    u8 = to_uint8(imgs)
    return u8[0], u8[1]


def edit_one(pipe, args, image, source, target, blend_pair):
    """(reconstruction, edited) uint8 images of one edit."""
    if args.model == "sdxl":
        return edit_one_sdxl(pipe, args, image, source, target)
    if args.baseline != "none":
        return edit_one_baseline(pipe, args, image, source, target, blend_pair)
    ctrl = _build_edit_controller(pipe, args, source, target, blend_pair,
                                  pipe.grid.num_reverse_steps)
    tau2 = args.tau if args.tau2 is None else args.tau2
    g = pipe.default_guidance(guidance_scale=args.guidance_scale,
                              dynamic_guidance=args.dynamic_guidance, tau1=args.tau, tau2=tau2,
                              edit_pair=True)
    imgs, _ = pipe.edit(image, source, target, ctrl, generator=_generator(pipe, args.seed), guidance=g)
    u8 = to_uint8(imgs)
    return u8[0], u8[1]


def _is_one_word_swap(source: str, target: str) -> bool:
    s, t = source.split(), target.split()
    return len(s) == len(t) and sum(a != b for a, b in zip(s, t)) == 1


def main(argv=None, _pipe=None):
    """Edit; `_pipe` (a bundle) replaces the one the flags would build (in
    `--quantize`'s mode for the run, its own restored after)."""
    args = parse_args(argv)
    if args.baseline != "none" and args.model == "sdxl":
        # the reference ships DDIM/NTI/NPI baselines for SD1.5 only; the SDXL
        # editing protocol is amplify_prompt without a p2p controller
        sys.exit("--baseline is SD1.5-only (the reference has no SDXL NTI/NPI baselines); "
                 "drop --baseline or use --model sd15")
    if args.guidance_scale is None:
        # reference defaults: 19 for cons editing, 8.0 for the DDIM baselines
        args.guidance_scale = 8.0 if args.baseline != "none" else 19.0
    if args.tau1 is not None and args.tau1 != args.tau:
        print(f"--tau1 {args.tau1} is a generation setting: editing keeps --tau {args.tau}")
    mesh = cli_mesh(args)
    os.makedirs(args.out, exist_ok=True)
    pipe = _pipe if _pipe is not None else build_pipeline(args)
    with quantized(pipe, args.quantize):
        run(args, pipe, mesh)


def run(args, pipe, mesh=None):
    """The edit CLI's work on a built bundle (this rank's stride of the rows
    with `mesh`)."""
    pix = pipe.latent_size[0] * 2 ** (len(pipe.vae.cfg.block_out_channels) - 1)

    if args.benchmark:
        rows = [(os.path.join(args.image_root or "", r.file_name), r.source_prompt,
                 r.target_prompt, r.blend_words)
                for r in load_benchmark(args.benchmark, kind="editing", max_count=args.max_cnt)]
    else:
        if not (args.image and args.source and args.target):
            sys.exit("pass --image, --source and --target, or --benchmark")
        rows = [(args.image, args.source, args.target, ())]
    if args.is_replacement:
        kept = [r for r in rows if _is_one_word_swap(r[1], r[2])]
        if len(kept) != len(rows):
            print(f"--is_replacement: kept {len(kept)}/{len(rows)} one-word-replacement rows")
        rows = kept

    evals = build_evaluators(args, pipe.device) if args.calc_metrics else None
    mine = {}
    for i in stride(len(rows), mesh):
        path, source, target, blend = rows[i]
        img = load_512(path, left=args.crop_left, right=args.crop_right, top=args.crop_top,
                       bottom=args.crop_bottom, size=pix)
        rec, edited = edit_one(pipe, args, img, source, target, blend)
        out_path = os.path.join(args.out, f"{i:05d}_edited.jpg")
        save_image(edited, out_path)
        save_image(rec, out_path.replace("_edited", "_rec"))
        mine[i] = ({"file": out_path, "source": source, "target": target}, None)
        if evals is not None:
            # the reference's editing bundle (`edit.py:465-486`, metrics.calc_all)
            mine[i] = (mine[i][0], evals.calc_all(
                np.asarray(img, np.float32)[None] / 255.0,
                np.asarray(edited, np.float32)[None] / 255.0, [source], [target]))
        print(f"[{i + 1}/{len(rows)}] {source!r} -> {target!r}")
    done = all_gather_in_order(mine, mesh)
    if not is_main(mesh):
        return
    results = [r for r, _ in done]
    per_row_metrics = [m for _, m in done if m is not None]
    summary = {"results": results}
    if per_row_metrics:
        summary["metrics"] = {k: mean_or_none(per_row_metrics, k) for k in per_row_metrics[0]}
        if any(v is None for v in summary["metrics"].values()):
            summary["metrics_note"] = METRICS_NOTE
        print("metrics:", summary["metrics"])
    with open(os.path.join(args.out, "results.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(f"wrote {len(results)} edits to {args.out}")


if __name__ == "__main__":
    main()
