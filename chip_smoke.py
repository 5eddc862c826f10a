#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`invertible_cd_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (CUDA_HOME, default /usr/local/cuda); imports
nothing of JAX. Phases, each of which must pass:

  1. card:   prints the card's name and power limit (nvidia-smi) and the
             TF32 flags, which are set to False (fp32 references stay fp32);
  2. build:  compiles every kernel from `invertible_cd_tpu_torch/ops/csrc/`
             with nvcc for sm_90a, one process per source, in parallel;
  3. kernels vs plain: each kernel at every shape the main path gives it
             (batch 4; B2 also at batch 1, the batch-1 generate's, where
             it splits its key range), against its plain fp32 version on
             the same bf16 inputs (q and k drawn at scale 2 and v at 0.5,
             so outputs are O(1) at every key count; max abs error <= 2e-2
             * min(1, max |reference|)), timed with CUDA events beside
             its plain version, torch SDPA (a yardstick the port never
             calls) and its bound; B1's logsumexp variant (1e-3 absolute),
             with a hash of B1's o and lse bits on these fixed-seed inputs
             (two builds of B1 compare in one `--kernels-only` call);
             the backward kernels B3 and B4 with dO ~ N(0, 1), against the
             plain explicit backward and against autograd through the plain
             forward (max abs error <= 2e-2 * max |reference| for each of
             dq, dk, dv), bit-identical on a repeat, timed beside the plain
             backward and the backward of torch SDPA;
  4. main path: `InvertibleCD.sd15` at full SD1.5 width with seeded
             weights and a seeded r=64 reverse LoRA, `generate` on 4
             prompts then on 1, four hops at 512^2. Checks shapes, finite
             images in [0, 1], 128 launches of B1 and 1 of B2 per generate,
             identical images for identical latents, the UNet's kernel path
             against its materialised-probability path, and a tiny bundle
             on the card against the same bundle in fp32 on the CPU; then
             times CLIP, one UNet call and the VAE decode, and traces one
             generate (device busy time, idle share, top kernels);
  5. training: `cli.train_icd.main` takes three optimizer steps at full
             SD1.5 width, batch 2, all four losses, seeded weights and
             batches; then the same step through `make_train_step` on the
             generate path's UNet weights: finite metrics under all eight
             names, base and teacher weights unchanged, every adapter's
             `up` zero before and moving after, the derived launch counts
             of B1, B3 and B4 per step, a checkpoint that restores equal;
             ms per step, samples/s, peak memory, one traced step; and the
             adapter gradient of `reverse_cd_loss` through the kernels
             against the same gradient through materialised attention;
  6. harness (run between phases 3 and 4): `cli.exp_softmax.main` runs
             kernel B5's five softmax variants at the tool's headline shape
             (G=128, S=4096, D=64) and the port's (G=32, S=4096, D=40),
             launches counted; each variant's output from that run is held
             against `flash_variant_plain` at the kernel's key tile on the
             same inputs at full G (same limit as the forward kernels), the
             plain call timed beside it, SDPA and the bound; the two bf16
             variants also on `variant_probe` inputs, where the kernel must
             sit within PROBE_RATIO of the variant's distance from base of
             its own plain version; B1 at 4096/40 is set beside B5 `exp2`
             at G=32 (the same work on the same wgmma loop, on a (G, S, D)
             layout instead of (B, S, 8, D));
  7. prints the kernels' JSON line, then the device JSON as the last line.
     A kernel row's `launches` are those of its (Sq, Sk, d) in the generate
     at its batch, plus, for the batch-4 rows, the three counted train
     steps (batch 2); B5's rows carry the harness's.

`--kernels-only` runs phases 1-3 and the harness (6) and prints the kernel
rows; `--package-root DIR` imports the package (and builds its kernels) from
another checkout, e.g. a parent commit unpacked under `build/`, so that two
versions of the kernels are timed in one call by the same code.
Kernel times (every kernel row, the harness's too) are per launch: the
median of 5 loops of 20 back-to-back launches, each loop between one pair of
CUDA events (`cuda_timed`).

Every bound is the largest of FLOPs / 989e12, exponentials / 3.9e12 (7.8e12
for B5's exp2bf16, whose ex2.approx.bf16x2 does two a MUFU issue) and
bytes / 3.35e12, in ms; "bound_limit" names which.

Exits non-zero, without the last line, if any phase fails or no CUDA
device is available.
"""
from __future__ import annotations

import argparse
import collections
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback

# Published dense peaks of one H100 SXM (at its 700 W limit).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# fp32 exponentials a second: the MUFU unit issues 16 a clock per SM, 132 SMs
# at 1.83 GHz (the figure FlashAttention-3's paper quotes for the H100 SXM);
# ex2.approx.bf16x2 does two a issue.
PEAK_EXP_PER_S = 3.9e12

BATCH = 4
PROMPTS = [
    "a photo of a corgi on the beach",
    "an astronaut riding a horse on the moon, detailed",
    "a watercolor painting of a lighthouse at dawn",
    "a bowl of ramen, studio lighting",
]
# bf16 kernel vs fp32 plain on the same inputs: max abs error <= KERNEL_TOL *
# min(1, max |reference|), a limit that shrinks with the output's magnitude
KERNEL_TOL = 2e-2
QK_SCALE = 2.0  # q and k at scale 2: logits spread ~4, outputs O(1) even at Sk=4096
V_SCALE = 0.5  # |output| < ~3, so the output's bf16 rounding stays below 8e-3
UNET_REL_TOL = 5e-2  # relative L2, UNet kernel path vs materialised path, both bf16
# B3/B4 vs the fp32 plain backward on the same bf16 inputs: max abs error <=
# GRAD_TOL * max |reference| for each of dq, dk, dv. The kernels round P and dS
# to bf16 before their products and the result to bf16 (2^-9 relative each);
# the plain backward rounds nothing.
GRAD_TOL = 2e-2
# B1's logsumexp vs torch.logsumexp of the fp32 logits: absolute. Both are
# fp32 over the same bf16 products; 1e-3 is far above their rounding and far
# below a base-2/natural-log or scale mistake (|lse| is 5 to 40 here).
LSE_TOL = 1e-3
GRAD_REL_TOL = 5e-2  # relative L2 over all adapters, kernel path vs materialised path
TRAIN_BATCH = 2
TRAIN_STEPS = 3
METRIC_NAMES = (
    "reverse_cd_loss", "reverse_preserve_loss", "reverse_total_loss", "reverse_grad_norm",
    "forward_cd_loss", "forward_preserve_loss", "forward_total_loss", "forward_grad_norm",
)
TINY_TOL = 5e-2  # max abs image error, tiny bundle bf16 on the card vs fp32 on the CPU
# Kernel times: the median of LOOPS loops of LOOP_CALLS back-to-back calls,
# each loop between one pair of CUDA events, over LOOP_CALLS (the host's work
# for a launch then hides behind the device's; around a single launch the
# two events would include it)
LOOPS = 5
LOOP_CALLS = 20

SOURCES = {
    "flash_fwd": ("invertible_cd_tpu_torch/ops/csrc/flash_fwd.cu",
                  "invertible_cd_tpu/ops/flash_attention.py:49"),
    "flash_fwd_streamed": ("invertible_cd_tpu_torch/ops/csrc/flash_fwd_streamed.cu",
                           "invertible_cd_tpu/ops/flash_attention.py:160"),
    "flash_bwd_dq": ("invertible_cd_tpu_torch/ops/csrc/flash_bwd_dq.cu",
                     "invertible_cd_tpu/ops/flash_attention.py:353"),
    "flash_bwd_dkdv": ("invertible_cd_tpu_torch/ops/csrc/flash_bwd_dkdv.cu",
                       "invertible_cd_tpu/ops/flash_attention.py:419"),
    "flash_variant": ("invertible_cd_tpu_torch/ops/csrc/flash_variant.cu",
                      "tools/exp_softmax.py:53"),
}
# (kernel, batch, Sq, Sk, heads, head dim): the main path's shapes; B2 also at
# the batch-1 generate's batch, where its grid alone would fill 64 SMs
SHAPES = [
    ("flash_fwd", BATCH, 4096, 4096, 8, 40),
    ("flash_fwd", BATCH, 1024, 1024, 8, 80),
    ("flash_fwd", BATCH, 256, 256, 8, 160),
    ("flash_fwd", BATCH, 64, 64, 8, 160),
    ("flash_fwd", BATCH, 4096, 77, 8, 40),
    ("flash_fwd", BATCH, 1024, 77, 8, 80),
    ("flash_fwd", BATCH, 256, 77, 8, 160),
    ("flash_fwd", BATCH, 64, 77, 8, 160),
    ("flash_fwd_streamed", BATCH, 4096, 4096, 1, 512),
    ("flash_fwd_streamed", 1, 4096, 4096, 1, 512),
]
# attention layers of one SD1.5 UNet call by token count (self; as many cross
# layers at Sk = 77): 2 down + 3 up at each of 4096/1024/256, 1 mid at 64
LAYERS_PER_CALL = {4096: 5, 1024: 5, 256: 5, 64: 1}


def bound(flops: float, exps: float, nbytes: float, exp_rate: float = PEAK_EXP_PER_S) -> dict:
    """The least time the card could take for the work: the largest of its
    FLOPs, exponentials and bytes over their peak rates."""
    times = {"flops": flops / PEAK_BF16_FLOPS * 1e3, "exponentials": exps / exp_rate * 1e3,
             "bytes": nbytes / PEAK_BYTES * 1e3}
    limit = max(times, key=times.get)
    return {"bound_ms": times[limit], "bound_by": "bytes" if limit == "bytes" else "operations",
            "bound_limit": limit}


def check(ok: bool, message: str) -> None:
    """A check that holds under `python -O` too."""
    if not ok:
        raise AssertionError(message)


def cuda_timed(fn, per_loop: int = LOOP_CALLS, loops: int = LOOPS, warmup: int = 2):
    """Device ms of one call of `fn`: the median of `loops` loops of
    `per_loop` back-to-back calls, each loop between one pair of CUDA
    events, divided by `per_loop`; and the last call's result. Back to back,
    the host's work for a call (the wrapper, the launch) runs while the card
    runs the calls before it, so a kernel that outlasts that work is timed
    without it."""
    import torch

    result = None
    for _ in range(warmup):
        result = fn()
    times = []
    for _ in range(loops):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_loop):
            result = fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_loop)
    return statistics.median(times), result


def cuda_ms(fn, per_loop: int = LOOP_CALLS, loops: int = LOOPS, warmup: int = 2) -> float:
    """Device ms of one call of `fn`, as `cuda_timed`."""
    return cuda_timed(fn, per_loop, loops, warmup)[0]


def phase_card():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    print(f"torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return card


def phase_build():
    from invertible_cd_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    reports = fa.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(reports) or 'nothing (cached)'}")
    for name, out in reports.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")


def bits_hash(t) -> str:
    """A short hash of a tensor's bytes, to hold two builds' outputs equal."""
    import hashlib

    import torch

    raw = t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes()
    return hashlib.sha256(raw).hexdigest()[:16]


def phase_kernels(card: str):
    import torch
    import torch.nn.functional as F

    from invertible_cd_tpu_torch.ops import flash_attention as fa

    wrappers = {"flash_fwd": fa.flash_attention, "flash_fwd_streamed": fa.flash_attention_streamed}
    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows = []
    failures = []
    print(f"kernels vs plain at the main path's shapes ({card}):")
    for name, batch, sq, sk, h, d in SHAPES:
        def rnd(s, scale=1.0):
            return (scale * torch.randn((batch, s, h, d), generator=gen, device="cuda")).to(
                torch.bfloat16)
        q, k, v = rnd(sq, QK_SCALE), rnd(sk, QK_SCALE), rnd(sk, V_SCALE)
        out = wrappers[name](q, k, v)
        torch.cuda.synchronize()
        ref = fa.attention_plain(q.float(), k.float(), v.float())  # fp32 on the bf16 inputs
        err = (out.float() - ref).abs().max().item()
        ref_max = ref.abs().max().item()
        limit = KERNEL_TOL * min(1.0, ref_max)
        ok = err <= limit and bool(torch.isfinite(out).all())
        if not ok:
            failures.append(f"{name} sq={sq} sk={sk} d={d}: max abs err {err} > {limit}")
        lse_fields = {}
        if name == "flash_fwd":  # the logsumexp variant that training launches
            out_lse, lse = fa.flash_forward_lse(q, k, v)
            torch.cuda.synchronize()
            lse_err = (lse - fa.attention_plain_lse(q.float(), k.float(), v.float())[1]
                       ).abs().max().item()
            if not (torch.equal(out_lse, out) and lse_err <= LSE_TOL):
                failures.append(f"{name}+lse sq={sq} sk={sk} d={d}: lse err {lse_err} > {LSE_TOL} "
                                f"or output differs from the no-lse variant")
            lse_fields = {"lse_max_abs_err": lse_err,
                          "lse_ms": cuda_ms(lambda: fa.flash_forward_lse(q, k, v))}
            # B1's bits on these fixed-seed inputs, for the package this run imports
            print(f"  B1 bits {name}[sq={sq},sk={sk},d={d}]: o {bits_hash(out)} lse {bits_hash(lse)}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = cuda_ms(lambda: wrappers[name](q, k, v))
        plain_ms = cuda_ms(lambda: fa.attention_plain(q, k, v))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
        flops = 4.0 * batch * h * sq * sk * d
        nbytes = 2.0 * batch * h * d * (2 * sq + 2 * sk)  # q, k, v read once, o written once
        rows.append({
            "name": f"{name}[b={batch},sq={sq},sk={sk},h={h},d={d}]",
            "kernel": name,
            "batch": batch,
            "shape": [sq, sk, d],
            "route": "cuda",
            "source": SOURCES[name][0],
            "replaces": SOURCES[name][1],
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            **bound(flops, batch * h * sq * sk, nbytes),
            "library_ms": library_ms,
            **lse_fields,
        })
        with_lse = (f"  with lse {lse_fields['lse_ms']:.3f} ms (lse err "
                    f"{lse_fields['lse_max_abs_err']:.1e})" if lse_fields else "")
        print(f"  {rows[-1]['name']:<48} err {err:.2e} (max|ref| {ref_max:.3f}, "
              f"err/max|ref| {err / ref_max:.2e}, limit {limit:.2e})  "
              f"kernel {ms:.3f} ms{with_lse}  plain {plain_ms:.3f} ms  sdpa {library_ms:.3f} ms  "
              f"bound {rows[-1]['bound_ms']:.4f} ms ({rows[-1]['bound_limit']})  "
              f"{flops / ms / 1e9:.1f} TFLOP/s  {'ok' if ok else 'FAIL'}")
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    check(not failures, "kernel mismatch: " + "; ".join(failures))
    return rows


def phase_backward_kernels(card: str):
    """B3 and B4 at the eight B1 shapes: against the plain explicit backward
    and against autograd through the plain forward (which knows nothing of
    lse, so a wrong lse cannot hide), repeated for bit-identity, and timed.
    `plain_ms` (the plain backward) and `library_ms` (the backward of torch
    SDPA) each compute dq, dk and dv together, so the same time stands on the
    B3 and the B4 row of a shape."""
    import torch
    import torch.nn.functional as F

    from invertible_cd_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(4321)
    rows = []
    failures = []
    print(f"backward kernels vs plain at batch {BATCH} ({card}):")
    for name, batch, sq, sk, h, d in SHAPES:
        if name != "flash_fwd":
            continue

        def rnd(s, scale=1.0):
            return (scale * torch.randn((batch, s, h, d), generator=gen, device="cuda")).to(
                torch.bfloat16)
        q, k, v, do = rnd(sq, QK_SCALE), rnd(sk, QK_SCALE), rnd(sk, V_SCALE), rnd(sq)
        o, lse = fa.flash_forward_lse(q, k, v)
        dq = fa.flash_backward_dq(q, k, v, o, lse, do)
        dk, dv = fa.flash_backward_dkdv(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        same = torch.equal(dq, fa.flash_backward_dq(q, k, v, o, lse, do)) and all(
            torch.equal(a, b) for a, b in zip((dk, dv), fa.flash_backward_dkdv(q, k, v, o, lse, do)))
        if not same:
            failures.append(f"sq={sq} sk={sk} d={d}: a repeat gave other bits")

        qf, kf, vf = (x.float().requires_grad_(True) for x in (q, k, v))
        ref_o, ref_lse = fa.attention_plain_lse(qf, kf, vf)
        auto = torch.autograd.grad(ref_o, (qf, kf, vf), do.float())
        plain = fa.attention_backward_plain(
            q.float(), k.float(), v.float(), ref_o.detach(), ref_lse.detach(), do.float())
        errs = {}
        for gname, got, ref_p, ref_a in zip(("dq", "dk", "dv"), (dq, dk, dv), plain, auto):
            ref_max = ref_p.abs().max().item()
            err = max((got.float() - ref_p).abs().max().item(),
                      (got.float() - ref_a).abs().max().item())
            errs[gname] = (err, ref_max)
            if not (err <= GRAD_TOL * ref_max and bool(torch.isfinite(got).all())):
                failures.append(f"{gname} sq={sq} sk={sk} d={d}: max abs err {err} > "
                                f"{GRAD_TOL} * {ref_max}")
        del qf, kf, vf, ref_o, ref_lse, auto, plain

        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt)
        dot = do.transpose(1, 2)
        times = {
            "flash_bwd_dq": cuda_ms(lambda: fa.flash_backward_dq(q, k, v, o, lse, do)),
            "flash_bwd_dkdv": cuda_ms(lambda: fa.flash_backward_dkdv(q, k, v, o, lse, do)),
        }
        plain_ms = cuda_ms(lambda: fa.attention_backward_plain(q, k, v, o, lse, do))
        library_ms = cuda_ms(
            lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dot, retain_graph=True))
        g = batch * h
        # bf16 tensors read or written once each, plus the fp32 lse
        nbytes = {"flash_bwd_dq": 2.0 * g * d * (4 * sq + 2 * sk) + 4.0 * g * sq,    # q o do dq | k v
                  "flash_bwd_dkdv": 2.0 * g * d * (3 * sq + 4 * sk) + 4.0 * g * sq}  # q o do | k v dk dv
        products = {"flash_bwd_dq": 3, "flash_bwd_dkdv": 4}
        for kernel, grads in (("flash_bwd_dq", ("dq",)), ("flash_bwd_dkdv", ("dk", "dv"))):
            flops = 2.0 * products[kernel] * g * sq * sk * d
            rows.append({
                "name": f"{kernel}[b={batch},sq={sq},sk={sk},h={h},d={d}]",
                "kernel": kernel,
                "batch": batch,
                "shape": [sq, sk, d],
                "route": "cuda",
                "source": SOURCES[kernel][0],
                "replaces": SOURCES[kernel][1],
                "max_abs_err": max(errs[n][0] for n in grads),
                "rel_err": max(errs[n][0] / errs[n][1] for n in grads),
                "ms": times[kernel],
                "plain_ms": plain_ms,
                **bound(flops, g * sq * sk, nbytes[kernel]),  # each recomputes P
                "library_ms": library_ms,
            })
            r = rows[-1]
            print(f"  {r['name']:<48} "
                  + " ".join(f"{n} err {errs[n][0]:.2e} (/max|ref| {errs[n][0] / errs[n][1]:.2e})"
                             for n in grads)
                  + f"  kernel {r['ms']:.3f} ms  plain bwd {plain_ms:.3f} ms  sdpa bwd "
                    f"{library_ms:.3f} ms  bound {r['bound_ms']:.4f} ms ({r['bound_limit']})  "
                    f"{flops / r['ms'] / 1e9:.1f} TFLOP/s  repeat {'same bits' if same else 'DIFFERS'}")
        del q, k, v, do, o, lse, dq, dk, dv, qt, kt, vt, sdpa_out
        torch.cuda.empty_cache()
    check(not failures, "backward kernel mismatch: " + "; ".join(failures))
    return rows


HARNESS_ITERS = LOOP_CALLS  # back-to-back launches in each of the harness's 5 timed loops
# On `variant_probe` inputs a bf16 variant's kernel must sit within this
# share of the variant's distance from base (max abs, both plain in fp32) of
# its own plain version. The kernel and the plain version take the same bf16
# p there, so only the output's bf16 rounding parts them (<= 2^-10 at
# |o| < 0.5), against a distance of 7e-3 to 1.5e-2; a kernel that skipped the
# variant's rounding would be off by the whole distance (ratio ~1).
PROBE_RATIO = 0.25


def phase_harness(card: str, b1_rows):
    """The harness path: `cli.exp_softmax.main` at both of its shapes with the
    counts reset just before and read just after; then each variant's output
    from that run against `flash_variant_plain` at the kernel's key tile on
    the same inputs (one timed plain call gives both `plain_ms` and the
    reference), and the bf16 variants on `variant_probe` inputs."""
    import torch

    from invertible_cd_tpu_torch.cli import exp_softmax
    from invertible_cd_tpu_torch.ops import flash_attention as fa
    from invertible_cd_tpu_torch.ops import flash_variant as fv

    print(f"harness: cli.exp_softmax.main ({card}):")
    # ---- the harness path: counts reset just before, read just after ----
    fa.reset_launch_counts()
    results = exp_softmax.main(["--iters", str(HARNESS_ITERS)])
    torch.cuda.synchronize()
    shape_launches = collections.Counter(fa.LAUNCH_SHAPES)
    # --------------------------------------------------------------------
    rows = []
    failures = []
    for res in results:
        g, s, d = res["shape"]
        q, k, v = exp_softmax.make_inputs(res["shape"], torch.device("cuda"))
        for r in res["variants"]:
            variant, out = r["variant"], r.pop("out")
            plain_ms, ref = cuda_timed(lambda: fv.flash_variant_plain(
                q, k, v, variant, block_k=fv.KEY_TILE, scale=exp_softmax.SCALE),
                per_loop=1, loops=3, warmup=1)
            err = (out.float() - ref.float()).abs().max().item()
            limit = KERNEL_TOL * min(1.0, ref.float().abs().max().item())
            if not (err <= limit and bool(torch.isfinite(out).all())):
                failures.append(f"{variant} G={g} S={s} D={d}: max abs err {err} > {limit}")
            del out, ref
            probe = {}
            if variant in fv.BF16_VARIANTS:
                probe = probe_variant(fv, variant, (g, s, d), exp_softmax.SCALE)
                if not probe["probe_err"] <= PROBE_RATIO * probe["probe_gap"]:
                    failures.append(f"{variant} G={g} S={s} D={d} on the probe: max abs err "
                                    f"{probe['probe_err']} > {PROBE_RATIO} * {probe['probe_gap']}")
            # ex2.approx.bf16x2 does two exponentials a MUFU issue; bf16exp's h2exp
            # widens each half to fp32 and takes two fp32 ex2 (the toolkit's sequence)
            bf16x2 = variant == "exp2bf16"
            flops = 4.0 * g * s * s * d
            rows.append({
                "name": f"flash_variant[{variant},g={g},s={s},d={d}]",
                "kernel": "flash_variant",
                "variant": variant,
                "shape": [s, s, d],
                "route": "cuda",
                "source": SOURCES["flash_variant"][0],
                "replaces": SOURCES["flash_variant"][1],
                "launches": shape_launches[("flash_variant", s, s, d, variant)],
                "max_abs_err": err,
                "max_abs_diff_vs_base": r["max_abs_diff_vs_base"],
                **probe,
                "ms": r["ms"],
                "plain_ms": plain_ms,
                **bound(flops, g * s * s, 2.0 * g * s * d * 4,
                        exp_rate=PEAK_EXP_PER_S * (2 if bf16x2 else 1)),
                "library_ms": res["library_ms"],
            })
            row = rows[-1]
            on_probe = (f"  probe err {probe['probe_err']:.2e} vs distance from base "
                        f"{probe['probe_gap']:.2e}" if probe else "")
            print(f"  {row['name']:<44} err vs plain {err:.2e} (limit {limit:.2e}){on_probe}  kernel "
                  f"{row['ms']:.3f} ms  plain {plain_ms:.3f} ms  sdpa {row['library_ms']:.3f} ms  "
                  f"bound {row['bound_ms']:.4f} ms ({row['bound_limit']})  "
                  f"{row['bound_ms'] / row['ms']:.2f} of bound  {flops / row['ms'] / 1e9:.1f} TFLOP/s  "
                  f"launches {row['launches']}")
        del q, k, v, res["variants"]
        torch.cuda.empty_cache()
    check(not failures, "harness kernel mismatch: " + "; ".join(failures))
    check(all(r["launches"] > 0 for r in rows), "a variant was not launched by the harness")
    b1 = next(r for r in b1_rows if r["kernel"] == "flash_fwd" and r["shape"] == [4096, 4096, 40])
    b5 = next(r for r in rows if r["variant"] == "exp2" and r["shape"] == [4096, 4096, 40])
    print(f"  same work, one loop: B1 at 4096/4096/40, batch {BATCH} x 8 heads: {b1['ms']:.3f} ms; "
          f"B5 exp2 at G=32: {b5['ms']:.3f} ms; B5 / B1 = {b5['ms'] / b1['ms']:.3f} ({card})")
    return rows


def probe_variant(fv, variant: str, shape, scale: float) -> dict:
    """B5 `variant` on `variant_probe` inputs of `shape`: its max abs error
    against the variant's plain version, and the variant's distance from
    base (both plain, fp32 inputs and output, at the kernel's key tile)."""
    import torch

    q, k, v = fv.variant_probe(*shape, variant, scale, device="cuda")
    out = fv.flash_variant(q, k, v, variant, scale=scale)
    qf, kf, vf = q.float(), k.float(), v.float()
    want = fv.flash_variant_plain(qf, kf, vf, variant, block_k=fv.KEY_TILE, scale=scale)
    base = fv.flash_variant_plain(qf, kf, vf, "base", block_k=fv.KEY_TILE, scale=scale)
    result = {"probe_err": (out.float() - want).abs().max().item(),
              "probe_gap": (want - base).abs().max().item()}
    del q, k, v, qf, kf, vf, out, want, base
    torch.cuda.empty_cache()
    return result


def phase_main_path(card: str):
    import torch

    from invertible_cd_tpu_torch.models.attention import AttnMeta
    from invertible_cd_tpu_torch.ops import flash_attention as fa
    from invertible_cd_tpu_torch.pipelines.pipeline import InvertibleCD
    from invertible_cd_tpu_torch.pipelines.sampler import w_embedding_for
    from invertible_cd_tpu_torch.testing import tiny_configs
    from invertible_cd_tpu_torch.utils.tokenizer import HashTokenizer

    t0 = time.perf_counter()
    pipe = InvertibleCD.sd15(device="cuda", dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    n_params = {name: sum(p.numel() for p in m.parameters()) for name, m in (
        ("unet", pipe.unets["reverse"]), ("clip", pipe.text_encoder), ("vae", pipe.vae))}
    print(f"main path: InvertibleCD.sd15 built in {time.perf_counter() - t0:.1f} s, params {n_params}")

    gen = torch.Generator(device="cuda").manual_seed(150)
    latent4 = pipe.init_latent(gen, BATCH)
    latent1 = torch.randn((1, 64, 64, 4), generator=gen, device="cuda")
    # warm-up at both batch sizes: cuBLAS/cuDNN handles and per-shape plans, kernel loads
    pipe.generate(PROMPTS, latent=latent4)
    pipe.generate(PROMPTS[:1], latent=latent1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path: counts reset just before, read just after ----
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    images4, lat4 = pipe.generate(PROMPTS, latent=latent4)
    torch.cuda.synchronize()
    gen4_s = time.perf_counter() - t0
    want = {"flash_fwd": 128, "flash_fwd_streamed": 1, "flash_bwd_dq": 0, "flash_bwd_dkdv": 0,
            "flash_variant": 0}
    after4 = {name: fa.launches(name) for name in want}
    shapes4 = collections.Counter(fa.LAUNCH_SHAPES)
    t0 = time.perf_counter()
    images1, lat1 = pipe.generate(PROMPTS[:1], latent=latent1)
    torch.cuda.synchronize()
    gen1_s = time.perf_counter() - t0
    launches = {name: fa.launches(name) for name in want}
    shape_launches = {BATCH: shapes4, 1: collections.Counter(fa.LAUNCH_SHAPES) - shapes4}
    # --------------------------------------------------------------------
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(f"  launches after batch-{BATCH} generate {after4}, after batch-1 generate {launches}")
    check(after4 == want, f"per-generate launches {after4} != {want}")
    check(launches == {k: 2 * v for k, v in want.items()}, f"launches {launches}")
    for imgs, lat, b in ((images4, lat4, BATCH), (images1, lat1, 1)):
        check(tuple(imgs.shape) == (b, 512, 512, 3) and imgs.dtype == torch.float32,
              f"images {tuple(imgs.shape)} {imgs.dtype}")
        check(tuple(lat.shape) == (b, 64, 64, 4), f"latents {tuple(lat.shape)}")
        check(bool(torch.isfinite(imgs).all()) and bool(torch.isfinite(lat).all()), "non-finite output")
        check(0.0 <= imgs.min().item() and imgs.max().item() <= 1.0, "images outside [0, 1]")
    print(f"  images: batch {BATCH} mean {images4.mean().item():.4f} std {images4.std().item():.4f}; "
          f"latent std {lat4.std().item():.4f}")

    again, _ = pipe.generate(PROMPTS[:1], latent=latent1)
    check(torch.equal(again, images1), "same latent gave different images")
    print("  same latent -> identical images: ok")

    # component times (batch 4), CUDA events around single calls, median of 5
    unet = pipe.unets["reverse"]
    ctx = pipe._encode_all(PROMPTS, need_uncond=False)[1]
    x = lat4.permute(0, 3, 1, 2).contiguous()
    w = w_embedding_for(pipe.default_guidance(), 999, BATCH, device="cuda")
    t = torch.full((BATCH,), 999, device="cuda")
    with torch.inference_mode():
        clip_ms = cuda_ms(lambda: pipe._encode_all(PROMPTS, need_uncond=False), per_loop=1)
        unet_ms = cuda_ms(lambda: unet(x, t, ctx, w), per_loop=1)
        vae_ms = cuda_ms(lambda: pipe._decode_latents(x), per_loop=1, loops=3, warmup=1)

        # the UNet's kernel path against its plain (materialised-probability) path
        def identity_hook(probs, meta: AttnMeta):
            return probs
        eps_kernel = unet(x, t, ctx, w)
        eps_plain = unet(x, t, ctx, w, attn_hook=identity_hook)
    rel = ((eps_kernel - eps_plain).norm() / eps_plain.norm()).item()
    print(f"  UNet kernel path vs materialised path: relative L2 {rel:.3e} (tol {UNET_REL_TOL})")
    check(rel <= UNET_REL_TOL, f"UNet kernel path off by {rel}")

    # a tiny bundle on the card (bf16, kernels) against the same weights in fp32 on the CPU
    unet_cfg, clip_cfg, vae_cfg = tiny_configs()
    cfgs = dict(unet_cfg=unet_cfg, clip_cfg=clip_cfg, vae_cfg=vae_cfg, latent_size=(16, 16))
    cpu_pipe = InvertibleCD.sd15(device="cpu", dtype=torch.float32, seed=7, lora_rank=4,
                                 tokenizer=HashTokenizer(clip_cfg.vocab_size), **cfgs)
    params = {"reverse": cpu_pipe.unets["reverse"].state_dict(),
              "text": cpu_pipe.text_encoder.state_dict(), "vae": cpu_pipe.vae.state_dict()}
    gpu_pipe = InvertibleCD.sd15(params=params, device="cuda", dtype=torch.bfloat16,
                                 tokenizer=cpu_pipe.tokenizer, **cfgs)
    z = torch.randn((2, 16, 16, 4), generator=torch.Generator().manual_seed(3))
    want_img, _ = cpu_pipe.generate(PROMPTS[:2], latent=z)
    got_img, _ = gpu_pipe.generate(PROMPTS[:2], latent=z)
    tiny_err = (got_img.cpu() - want_img).abs().max().item()
    print(f"  tiny bundle, card bf16 vs CPU fp32: max abs image error {tiny_err:.3e} (tol {TINY_TOL})")
    check(tiny_err <= TINY_TOL, f"tiny bundle off by {tiny_err}")

    print(f"  generate batch {BATCH}: {gen4_s * 1e3:.1f} ms ({BATCH / gen4_s:.3f} images/s); "
          f"batch 1: {gen1_s * 1e3:.1f} ms ({1 / gen1_s:.3f} images/s)")
    print(f"  batch {BATCH}: UNet call {unet_ms:.2f} ms, CLIP encode {clip_ms:.2f} ms, "
          f"VAE decode {vae_ms:.2f} ms; peak memory {peak_gb:.2f} GiB ({card})")
    trace_run(f"batch {BATCH} generate", lambda: pipe.generate(PROMPTS, latent=latent4))
    return pipe, shape_launches


def trace_run(label: str, fn) -> None:
    """One call of `fn` under torch.profiler: device busy time (sum of
    kernel times; one stream, so kernels do not overlap), the device's idle
    share of the traced wall time, and the kernels that take the most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print(f"  trace ({label}): the profiler recorded no device events; idle share not measured")
        return
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_name[e.name][1] += 1
    print(f"  trace ({label} under the profiler): wall {wall_ms:.1f} ms, "
          f"device busy {busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
          f"{len(kernels)} kernel launches")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"    {ms:8.2f} ms {n:5d}x  {name[:110]}")
    ours = sorted((kv for kv in by_name.items() if "icd::" in kv[0]), key=lambda kv: -kv[1][0])
    print("  the port's kernels in that trace: " + "; ".join(
        f"{name.split('(')[0].replace('void ', '')[:60]} {ms:.3f} ms / {n}" for name, (ms, n) in ours))


def states_equal(a, b) -> bool:
    """Nested dicts / tensors / scalars equal, tensors bit for bit."""
    import torch

    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            states_equal(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def phase_training(card: str, pipe):
    """The training path: the CLI's three steps, then the same step through
    `make_train_step` on the generate path's UNet weights with the launch
    counters reset. Returns the launches per (kernel, Sq, Sk, d) of the
    counted steps."""
    import dataclasses
    import tempfile

    import torch

    from invertible_cd_tpu_torch.cli import train_icd
    from invertible_cd_tpu_torch.diffusion.solver import make_train_solver
    from invertible_cd_tpu_torch.models import attention as attention_module
    from invertible_cd_tpu_torch.models.attention import AttnMeta
    from invertible_cd_tpu_torch.models.lora import (
        call_with_state, compute_dtypes, merged_state_dict, seeded_lora)
    from invertible_cd_tpu_torch.ops import flash_attention as fa
    from invertible_cd_tpu_torch.training import (
        LossConfig, TrainConfig, init_train_state, make_train_step, reverse_cd_loss)
    from invertible_cd_tpu_torch.training.checkpoint import restore_checkpoint, save_checkpoint

    def all_up(lora, fn):
        return [fn(ab["up"]) for ab in lora.values()]

    # ---- the entry point a user calls ----
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        last = train_icd.main([
            "--model", "sd15", "--synthetic_data", "--batch_size", str(TRAIN_BATCH),
            "--max_steps", str(TRAIN_STEPS), "--log_every", "1", "--output_dir", out_dir])
        torch.cuda.synchronize()
        print(f"training: cli.train_icd.main took {TRAIN_STEPS} steps at batch {TRAIN_BATCH} in "
              f"{time.perf_counter() - t0:.1f} s, weights and checkpoint included")
        check(os.path.exists(os.path.join(out_dir, "checkpoints", str(TRAIN_STEPS), "state.pt")),
              "the CLI wrote no checkpoint")
    check(all(name in last and math.isfinite(last[name]) for name in METRIC_NAMES),
          f"CLI metrics missing or not finite: {last}")
    torch.cuda.empty_cache()

    # ---- the same step through make_train_step, on the generate path's weights ----
    unet = pipe.unets["reverse"]
    teacher = unet.state_dict()
    base = {k: v.float() for k, v in teacher.items()}  # fp32 master copy of the bf16 weights
    base_before = {k: v.clone() for k, v in base.items()}
    teacher_before = {k: v.clone() for k, v in teacher.items()}
    solver = make_train_solver(
        pipe.schedule.alphas_cumprod, num_endpoints=4, num_forward_endpoints=4,
        endpoints="0,259,519,779", forward_endpoints="259,519,779,999", device="cuda")
    tcfg = TrainConfig(loss=LossConfig(w_embed_dim=unet.cfg.time_cond_proj_dim))
    gen = torch.Generator(device="cuda").manual_seed(11)
    state = init_train_state(gen, base, tcfg)
    n_adapters = len(state.lora_reverse)
    n_lora_params = sum(t.numel() for ab in state.lora_reverse.values() for t in ab.values())
    check(all(all_up(state.lora_reverse, lambda u: not u.any()))
          and all(all_up(state.lora_forward, lambda u: not u.any())), "an adapter's up is not 0 at init")
    step_fn = make_train_step(unet, base, teacher, solver, pipe.schedule, tcfg)

    def batch(i):
        g = torch.Generator(device="cuda").manual_seed(1000 + i)
        return {"latents": torch.randn((TRAIN_BATCH, 64, 64, 4), generator=g, device="cuda"),
                "context": 0.1 * torch.randn((TRAIN_BATCH, 77, 768), generator=g, device="cuda")}

    state, metrics = step_fn(state, batch(0), gen)  # warm-up: plans, handles, allocator
    torch.cuda.synchronize()
    for name, lora in (("reverse", state.lora_reverse), ("forward", state.lora_forward)):
        check(any(all_up(lora, lambda u: bool(u.any()))), f"no up of the {name} student moved in step 1")
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path: counts reset just before, read just after ----
    fa.reset_launch_counts()
    step_ms = []
    for i in range(1, 1 + TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch(i), gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    shape_launches = collections.Counter(fa.LAUNCH_SHAPES)
    # --------------------------------------------------------------------
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    metrics = {k: float(v) for k, v in metrics.items()}
    print("  last step: " + " ".join(f"{k}={v:.5f}" for k, v in sorted(metrics.items())))
    check(sorted(metrics) == sorted(METRIC_NAMES), f"metric names {sorted(metrics)}")
    check(all(math.isfinite(v) for v in metrics.values()), f"non-finite metric in {metrics}")
    check(state.step == 1 + TRAIN_STEPS, f"state.step {state.step}")

    # Launches per step. UNet forwards: reverse_cd 3 (student, teacher, the
    # student's no-grad target) + reverse_preserve 2 (frozen forward hop, one
    # rollout call: 4 endpoints / 4 forward endpoints = 1 hop) + forward_cd 3
    # + forward_preserve 2 (one frozen reverse hop, the student) = 10, plus
    # the rollout call recomputed by reverse_preserve_loss's checkpoint
    # = 11 forwards of B1; 4 differentiated student calls go backward through
    # B3 and B4. Each call has LAYERS_PER_CALL self layers and as many cross
    # layers (Sk = 77) at each token count.
    want = collections.Counter()
    for tokens, layers in LAYERS_PER_CALL.items():
        d = {4096: 40, 1024: 80, 256: 160, 64: 160}[tokens]
        for sk in (tokens, 77):
            want[("flash_fwd", tokens, sk, d)] = 11 * layers * TRAIN_STEPS
            want[("flash_bwd_dq", tokens, sk, d)] = 4 * layers * TRAIN_STEPS
            want[("flash_bwd_dkdv", tokens, sk, d)] = 4 * layers * TRAIN_STEPS
    totals = {name: sum(n for key, n in shape_launches.items() if key[0] == name) // TRAIN_STEPS
              for name in fa.KERNELS}
    print(f"  launches per train step: {totals}")
    check(shape_launches == want, f"launches {dict(shape_launches)} != {dict(want)}")
    check(totals == {"flash_fwd": 352, "flash_fwd_streamed": 0, "flash_bwd_dq": 128,
                     "flash_bwd_dkdv": 128, "flash_variant": 0}, f"launches per step {totals}")

    check(all(torch.equal(base[k], base_before[k]) for k in base), "a base weight changed")
    check(all(torch.equal(teacher[k], teacher_before[k]) for k in teacher), "a teacher weight changed")
    del base_before, teacher_before
    print("  base and teacher weights unchanged; both students' adapters moved")

    with tempfile.TemporaryDirectory() as ckpt_dir:
        save_checkpoint(ckpt_dir, state, keep=1)
        restored = restore_checkpoint(ckpt_dir, init_train_state(gen, base, tcfg))
    same = all(states_equal(getattr(state, f.name), getattr(restored, f.name))
               for f in dataclasses.fields(state))
    check(same, "the restored checkpoint differs from the saved state")
    del restored
    print("  checkpoint saved and restored: equal state")

    mean_ms = statistics.mean(step_ms)
    print(f"  train step, batch {TRAIN_BATCH}, {n_adapters} adapters of rank {tcfg.lora_rank} per "
          f"student ({n_lora_params / 1e6:.1f} M parameters): "
          + " / ".join(f"{ms:.1f}" for ms in step_ms)
          + f" ms; {1e3 / mean_ms:.3f} steps/s, {TRAIN_BATCH * 1e3 / mean_ms:.3f} samples/s; "
            f"peak memory {peak_gb:.2f} GiB ({card})")
    state_box = [state]

    def traced_step():
        state_box[0], _ = step_fn(state_box[0], batch(9), gen)
    trace_run(f"batch {TRAIN_BATCH} train step", traced_step)
    del state_box, state
    torch.cuda.empty_cache()

    # ---- kernel path against materialised path under grad: reverse_cd_loss, batch 1 ----
    # Gated at t = 119 (ddim index 5). Informational at t = 619 (index 30),
    # with the distance of a second plain path (the plain forward and the
    # plain explicit backward, fp32, through an autograd.Function) from the
    # materialised path beside it: at large t the sign-like huber gradient
    # turns the bf16 forward differences of ANY two attention paths into a few
    # percent of the adapter gradient, which measures the loss, not a kernel.
    lora = seeded_lora(base, gen, tcfg.lora_rank)  # non-zero ups: both factors get gradients
    leaves = [t.requires_grad_(True) for ab in lora.values() for t in ab.values()]
    one = batch(20)
    latents = one["latents"][:1].permute(0, 3, 1, 2)
    context = one["context"][:1]
    noise = torch.randn(latents.shape, generator=gen, device="cuda")
    w = torch.tensor([7.0], device="cuda")
    dtypes = compute_dtypes(unet)

    def identity_hook(probs, meta: AttnMeta):
        return probs

    class PlainAttentionFn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            o, lse = fa.attention_plain_lse(q, k, v)
            ctx.save_for_backward(q, k, v, o, lse)
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, o, lse = ctx.saved_tensors
            return fa.attention_backward_plain(q, k, v, o, lse, do.to(q.dtype))

    def adapter_grad(index, hook=None, plain_function=False):
        merged = merged_state_dict(base, lora, alpha=tcfg.lora_alpha, rank=tcfg.lora_rank,
                                   dtypes=dtypes)

        def student(params, x, t, w_emb):
            return call_with_state(unet, merged, x, t, context, w_cond=w_emb, attn_hook=hook)

        def teacher_apply(params, x, t, w_emb):
            return call_with_state(unet, teacher, x, t, context, w_cond=w_emb)
        fused = attention_module.fused_attention
        if plain_function:
            attention_module.fused_attention = PlainAttentionFn.apply
        try:
            loss, _ = reverse_cd_loss(
                student, None, teacher_apply, None, latents, noise, w, None, solver,
                pipe.schedule, tcfg.loss, index=torch.tensor([index], device="cuda"))
            grad = torch.cat([g.flatten() for g in torch.autograd.grad(loss, leaves)])
        finally:
            attention_module.fused_attention = fused
        return loss.item(), grad

    def rel_l2(a, b):
        return ((a - b).norm() / b.norm()).item()

    fa.reset_launch_counts()
    loss_k, grad_k = adapter_grad(5)
    counted = {name: fa.launches(name) for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")}
    loss_p, grad_p = adapter_grad(5, hook=identity_hook)
    check(counted == {"flash_fwd": 96, "flash_bwd_dq": 32, "flash_bwd_dkdv": 32},
          f"reverse_cd_loss launches {counted}")
    check({name: fa.launches(name) for name in counted} == dict(
        counted, flash_fwd=counted["flash_fwd"] + 32),  # the teacher call keeps the kernel
        "the materialised path launched a backward kernel")
    rel = rel_l2(grad_k, grad_p)
    print(f"  reverse_cd_loss adapter gradient ({grad_k.numel() / 1e6:.1f} M entries) at t=119, kernel "
          f"path vs materialised path: relative L2 {rel:.3e} (tol {GRAD_REL_TOL}); loss {loss_k:.6f} "
          f"vs {loss_p:.6f}; |grad| {grad_p.norm().item():.3e}")
    check(math.isfinite(rel) and rel <= GRAD_REL_TOL and grad_p.norm().item() > 0,
          f"kernel-path gradient off by {rel}")
    del grad_k, grad_p
    grads = {mode: adapter_grad(30, **kw)[1] for mode, kw in (
        ("kernel", {}), ("materialised", {"hook": identity_hook}), ("plain", {"plain_function": True}))}
    print(f"  the same at t=619 (not gated): kernel vs materialised "
          f"{rel_l2(grads['kernel'], grads['materialised']):.3e}, plain-function path vs materialised "
          f"{rel_l2(grads['plain'], grads['materialised']):.3e}, kernel vs plain-function path "
          f"{rel_l2(grads['kernel'], grads['plain']):.3e}")
    return shape_launches


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one GPU.")
    p.add_argument("--kernels-only", action="store_true",
                   help="run phases 1-3 and 6 only and print the kernel rows (not the device line)")
    p.add_argument("--package-root", default=None,
                   help="import invertible_cd_tpu_torch from this checkout (e.g. an unpacked "
                        "parent commit, to time two versions of the kernels in one call)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if args.package_root:
        sys.path.insert(0, os.path.abspath(args.package_root))
    try:
        import invertible_cd_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

        print(f"package: {os.path.dirname(invertible_cd_tpu_torch.__file__)}")
        card = phase_card()
        phase_build()
        rows = phase_kernels(card) + phase_backward_kernels(card)
        harness_rows = phase_harness(card, rows)
        if args.kernels_only:
            print(json.dumps({"kernels": rows + harness_rows}))
            return 0
        pipe, generate_launches = phase_main_path(card)
        train_launches = phase_training(card, pipe)
    except Exception:  # report every phase failure and exit non-zero
        traceback.print_exc()
        return 1
    # launches on the main paths: the generate at the row's batch, plus three
    # train steps (batch 2) for the rows at the generate's main batch
    for row in rows:
        key = (row["kernel"],) + tuple(row["shape"])
        row["launches"] = generate_launches[row["batch"]][key] + (
            train_launches[key] if row["batch"] == BATCH else 0)
    # B5 runs on the harness path alone; its rows carry that path's launches
    rows += harness_rows
    missing = [r["name"] for r in rows if r["launches"] == 0]
    if missing:
        print(f"chip_smoke: kernels not launched on their path: {missing}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
