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
             (batch 4), against its plain fp32 version on the same bf16
             inputs (q and k drawn at scale 2 and v at 0.5, so outputs are
             O(1) at every key count; max abs error <= 2e-2 *
             min(1, max |reference|)),
             timed with CUDA events beside
             its plain version, torch SDPA (a yardstick the port never
             calls) and its bound;
  4. main path: `InvertibleCD.sd15` at full SD1.5 width with seeded
             weights and a seeded r=64 reverse LoRA, `generate` on 4
             prompts then on 1, four hops at 512^2. Checks shapes, finite
             images in [0, 1], 128 launches of B1 and 1 of B2 per generate,
             identical images for identical latents, the UNet's kernel path
             against its materialised-probability path, and a tiny bundle
             on the card against the same bundle in fp32 on the CPU; then
             times CLIP, one UNet call and the VAE decode, and traces one
             generate (device busy time, idle share, top kernels);
  5. prints the kernels' JSON line, then the device JSON as the last line.

Exits non-zero, without the last line, if any phase fails or no CUDA
device is available.
"""
from __future__ import annotations

import collections
import json
import statistics
import subprocess
import sys
import time
import traceback

# Published dense peaks of one H100 SXM (at its 700 W limit).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

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
TINY_TOL = 5e-2  # max abs image error, tiny bundle bf16 on the card vs fp32 on the CPU

SOURCES = {
    "flash_fwd": ("invertible_cd_tpu_torch/ops/csrc/flash_fwd.cu",
                  "invertible_cd_tpu/ops/flash_attention.py:49"),
    "flash_fwd_streamed": ("invertible_cd_tpu_torch/ops/csrc/flash_fwd_streamed.cu",
                           "invertible_cd_tpu/ops/flash_attention.py:160"),
}
# (kernel, Sq, Sk, heads, head dim) at the main path's batch
SHAPES = [
    ("flash_fwd", 4096, 4096, 8, 40),
    ("flash_fwd", 1024, 1024, 8, 80),
    ("flash_fwd", 256, 256, 8, 160),
    ("flash_fwd", 64, 64, 8, 160),
    ("flash_fwd", 4096, 77, 8, 40),
    ("flash_fwd", 1024, 77, 8, 80),
    ("flash_fwd", 256, 77, 8, 160),
    ("flash_fwd", 64, 77, 8, 160),
    ("flash_fwd_streamed", 4096, 4096, 1, 512),
]


def check(ok: bool, message: str) -> None:
    """A check that holds under `python -O` too."""
    if not ok:
        raise AssertionError(message)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of `fn` in ms (CUDA events around each call)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def phase_kernels(card: str):
    import torch
    import torch.nn.functional as F

    from invertible_cd_tpu_torch.ops import flash_attention as fa

    wrappers = {"flash_fwd": fa.flash_attention, "flash_fwd_streamed": fa.flash_attention_streamed}
    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows = []
    failures = []
    print(f"kernels vs plain at batch {BATCH} ({card}):")
    for name, sq, sk, h, d in SHAPES:
        def rnd(s, scale=1.0):
            return (scale * torch.randn((BATCH, s, h, d), generator=gen, device="cuda")).to(
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
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = cuda_ms(lambda: wrappers[name](q, k, v))
        plain_ms = cuda_ms(lambda: fa.attention_plain(q, k, v))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
        flops = 4.0 * BATCH * h * sq * sk * d
        nbytes = 2.0 * BATCH * h * d * (2 * sq + 2 * sk)  # q, k, v read once, o written once
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        rows.append({
            "name": f"{name}[sq={sq},sk={sk},h={h},d={d}]",
            "kernel": name,
            "shape": [sq, sk, d],
            "route": "cuda",
            "source": SOURCES[name][0],
            "replaces": SOURCES[name][1],
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms,
        })
        print(f"  {rows[-1]['name']:<44} err {err:.2e} (max|ref| {ref_max:.3f}, "
              f"err/max|ref| {err / ref_max:.2e}, limit {limit:.2e})  "
              f"kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  sdpa {library_ms:.3f} ms  "
              f"bound {rows[-1]['bound_ms']:.4f} ms ({rows[-1]['bound_by']})  "
              f"{flops / ms / 1e9:.1f} TFLOP/s  {'ok' if ok else 'FAIL'}")
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    check(not failures, "kernel mismatch: " + "; ".join(failures))
    return rows


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
    after4 = {name: fa.launches(name) for name in fa.KERNELS}
    t0 = time.perf_counter()
    images1, lat1 = pipe.generate(PROMPTS[:1], latent=latent1)
    torch.cuda.synchronize()
    gen1_s = time.perf_counter() - t0
    launches = {name: fa.launches(name) for name in fa.KERNELS}
    shape_launches = dict(fa.LAUNCH_SHAPES)
    # --------------------------------------------------------------------
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(f"  launches after batch-{BATCH} generate {after4}, after batch-1 generate {launches}")
    want = {"flash_fwd": 128, "flash_fwd_streamed": 1}
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

    # component times (batch 4), CUDA events, median of 5
    unet = pipe.unets["reverse"]
    ctx = pipe._encode_all(PROMPTS, need_uncond=False)[1]
    x = lat4.permute(0, 3, 1, 2).contiguous()
    w = w_embedding_for(pipe.default_guidance(), 999, BATCH, device="cuda")
    t = torch.full((BATCH,), 999, device="cuda")
    with torch.inference_mode():
        clip_ms = cuda_ms(lambda: pipe._encode_all(PROMPTS, need_uncond=False), reps=5)
        unet_ms = cuda_ms(lambda: unet(x, t, ctx, w), reps=5)
        vae_ms = cuda_ms(lambda: pipe._decode_latents(x), reps=3, warmup=1)

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
    trace_generate(pipe, latent4)
    return launches, shape_launches


def trace_generate(pipe, latent4):
    """One batch-4 generate under torch.profiler: device busy time (sum of
    kernel times; one stream, so kernels do not overlap), the device's idle
    share of the traced wall time, and the kernels that take the most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.generate(PROMPTS, latent=latent4)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print("  trace: the profiler recorded no device events; idle share not measured")
        return
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_name[e.name][1] += 1
    print(f"  trace (batch {BATCH} generate under the profiler): wall {wall_ms:.1f} ms, "
          f"device busy {busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
          f"{len(kernels)} kernel launches")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"    {ms:8.2f} ms {n:5d}x  {name[:110]}")


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    try:
        import invertible_cd_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

        card = phase_card()
        phase_build()
        rows = phase_kernels(card)
        launches, shape_launches = phase_main_path(card)
    except Exception:  # report every phase failure and exit non-zero
        traceback.print_exc()
        return 1
    for row in rows:
        row["launches"] = shape_launches.get((row["kernel"],) + tuple(row["shape"]), 0)
    missing = [r["name"] for r in rows if r["launches"] == 0]
    if missing or any(v == 0 for v in launches.values()):
        print(f"chip_smoke: kernels not launched on the main path: {missing or launches}",
              file=sys.stderr)
        return 1
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
