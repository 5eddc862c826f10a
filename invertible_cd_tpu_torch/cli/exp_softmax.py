"""The softmax-variant harness of the PyTorch port (kernel B5).

    python -m invertible_cd_tpu_torch.cli.exp_softmax [--iters N] \\
        [--device cuda|cpu] [--shape G,S,D]

Counterpart of `tools/exp_softmax.py`: runs B1's forward in the five softmax
variants of `ops/flash_variant.py` (base, exp2, bf16exp, exp2bf16, nomax) on
seeded N(0, 1) bf16 inputs with the logit scale 40^-0.5, and prints for each
variant its time per launch and max|out - base|. Without `--shape` it runs
two shapes:

  * the tool's headline, G=128, S=4096, D=64 (batch 16 x 8 heads of the
    UNet's 4096-token d=40 self-attention, d padded to 64);
  * the port's own, G=32 (batch 4 x 8 heads), S=4096, D=40.

On the card each time is per launch: the median of 5 loops of `--iters`
back-to-back launches, each loop between one pair of CUDA events, after two
warm-up launches; each shape also prints the time of torch's
`scaled_dot_product_attention` on the same inputs as a yardstick (the port
never calls it). It runs on the CUDA device unless `--device cpu` is given;
there it runs the plain version, and its times are host-clock times of the
CPU, not of any device.
"""
from __future__ import annotations

import argparse
import statistics
import time
from typing import List, Tuple

import torch
import torch.nn.functional as F

from ..ops.flash_variant import VARIANTS, flash_variant
from ..pipelines.pipeline import resolve_device

SHAPES: List[Tuple[int, int, int]] = [(128, 4096, 64), (32, 4096, 40)]
SCALE = 40.0 ** -0.5  # the true d=40 softmax scale, also at the padded D=64


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--iters", type=int, default=16,
                   help="back-to-back launches in each of the 5 timed loops per variant")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--shape", default=None, help="G,S,D (default: both shapes above)")
    return p.parse_args(argv)


def make_inputs(shape, device):
    """Seeded N(0, 1) q, k, v of (G, S, D) in bf16 on `device`."""
    gen = torch.Generator(device=device).manual_seed(0)
    return tuple(torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
                 for _ in range(3))


def time_ms(fn, iters: int, device, loops: int = 5) -> float:
    """ms of one call of `fn`, after two warm-up calls: on the card the
    median of `loops` loops of `iters` back-to-back calls, each loop between
    one pair of CUDA events, divided by `iters` (the wrapper's host work then
    runs under the card's work); on the CPU the median host-clock time of
    `iters` single calls."""
    fn()
    fn()
    times = []
    if device.type == "cuda":
        for _ in range(loops):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / iters)
        return statistics.median(times)
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run_shape(shape, device, iters: int) -> dict:
    """Every variant at one shape: {"shape", "library_ms", "variants":
    [{"variant", "ms", "max_abs_diff_vs_base", "out"}]}, where "out" is the
    variant's output on the inputs of `make_inputs(shape, device)`."""
    q, k, v = make_inputs(shape, device)
    base = None
    rows = []
    for variant in VARIANTS:
        out = flash_variant(q, k, v, variant, scale=SCALE)
        if base is None:
            base = out.float()
        diff = (out.float() - base).abs().max().item()
        ms = time_ms(lambda: flash_variant(q, k, v, variant, scale=SCALE), iters, device)
        rows.append({"variant": variant, "ms": ms, "max_abs_diff_vs_base": diff, "out": out})
    library_ms = None
    if device.type == "cuda":  # as (G, 1 head, S, D), the layout SDPA's flash backend takes
        q4, k4, v4 = (x.unsqueeze(1) for x in (q, k, v))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=SCALE),
                             iters, device)
    return {"shape": tuple(shape), "library_ms": library_ms, "variants": rows}


def main(argv=None) -> List[dict]:
    args = parse_args(argv)
    device = resolve_device(args.device)
    shapes = [tuple(int(x) for x in args.shape.split(","))] if args.shape else SHAPES
    where = (f"{torch.cuda.get_device_name(device)}, CUDA events" if device.type == "cuda"
             else "CPU, host clock, plain version")
    results = []
    for shape in shapes:
        res = run_shape(shape, device, args.iters)
        g, s, d = shape
        print(f"G={g} S={s} D={d} scale={SCALE:.6f} ({where}, {args.iters} launches a loop)",
              flush=True)
        for row in res["variants"]:
            print(f"  {row['variant']:9s} {row['ms']:9.3f} ms/launch   "
                  f"max|out-base|={row['max_abs_diff_vs_base']:.2e}", flush=True)
        if res["library_ms"] is not None:
            print(f"  {'sdpa':9s} {res['library_ms']:9.3f} ms/launch   (yardstick; not a port path)",
                  flush=True)
        results.append(res)
    return results


if __name__ == "__main__":
    main()
