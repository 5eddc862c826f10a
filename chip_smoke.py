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
             it splits its key range; then the edit's and SDXL's shapes, B2's
             fp32 build on fp32 inputs with its lse held to the plain lse on
             q and k rounded to TF32; then phase 5e's: B1 and B2 at sp = 2's
             Sq = S / 2, batch 1 and 2, and B1 at tp = 2's 4 heads, batch
             2), against its plain fp32 version on
             the same bf16 inputs (q and k drawn at scale 2 and v at 0.5,
             so outputs are O(1) at every key count; max abs error <= 2e-2
             * min(1, max |reference|)), timed with CUDA events beside
             its plain version, torch SDPA (a yardstick the port never
             calls) and its bound; B1's logsumexp variant (1e-3 absolute),
             with a hash of B1's o and lse bits on these fixed-seed inputs
             (two builds of B1 compare in one `--kernels-only` call);
             the backward kernels B3 and B4 with dO ~ N(0, 1) at the train
             step's batch, at NTI's (batch 1) and at SDXL training's four
             d = 64 shapes (phase 5b's batch; B3/B4's DP 64 route) and at
             phase 5e's tp = 2 train step's (batch 2, 4 heads), against the
             plain explicit backward and against autograd through the plain
             forward (max abs error <= 2e-2 * max |reference| for each of
             dq, dk, dv), bit-identical on a repeat, timed beside the plain
             backward and the backward of torch SDPA;
  4. main path: `InvertibleCD.sd15` at full SD1.5 width with seeded
             weights and seeded r=64 reverse and forward LoRAs, `generate`
             on 4 prompts then on 1, four hops at 512^2. Checks shapes,
             finite images in [0, 1], 128 launches of B1 and 1 of B2 per
             generate, identical images for identical latents, the UNet's
             kernel path against its materialised-probability path, and a
             tiny bundle on the card against the same bundle in fp32 on the
             CPU; then times CLIP, one UNet call and the VAE decode, and
             traces one generate (device busy time, idle share, top kernels);
  4b. edit:  on the same bundle, `invert` of a seeded 512^2 uint8 image
             (batch 1: VAE encode, four forward hops) and `edit` (that
             inversion, then the [source, target] pair decoded under a
             replace + reweight + LocalBlend controller at the edit CLI's
             cross 0.6 / self 0.4 steps). Checks shapes, finite images in
             [0, 1], exact launches per shape: 128 x B1 + 1 x B2 for
             `invert`, and for the controlled generate of `edit` the B1
             count derived from the spec (the 5 self layers at 4096 tokens
             every hop, the 11 others outside the self-replace hops; every
             cross layer is hooked) + 1 x B2; identical output for an
             identical image and noise; row 0 of the pair (never edited)
             against `generate([source], latent=inversion, w=0)` within
             UNET_REL_TOL; a tiny bundle's invert + edit on the card
             against the same weights in fp32 on the CPU (the VAE encode,
             and every UNet call and LocalBlend step teacher-forced);
             times invert, the
             controlled generate and edit, and traces one edit;
  4e. serve: on the same bundle, the serving layer and the CLIs users
             call. `BatchingExecutor(batch_sizes=(1, 4), max_delay=0.01)`: a
             lone request, then a burst of eight distinct requests from eight
             threads (seeds at both ends of int64 among them); checks the
             stats (one batch of 1, two of 4, none padded), finite images in
             [0, 1], each served image bit for bit its row of a direct
             `generate` of its batch at the same size on the executor's
             latents (and with the batch's rows reversed), exact launches
             (128 x B1 + 1 x B2 a batch), a cancelled request beside two
             that are served; prints the lone request against the same
             request served at batch 4 (not gated) and times the lone
             request (median of 5) and the burst (requests/s, 3 bursts).
             `cli.serve.make_server` at one batch size (4) on 127.0.0.1:
             four concurrent POST /generate over a socket, each PNG equal to
             the executor's image for its seed, exact launches, GET /healthz,
             400 for a malformed body, the round trip. The generate CLI in a
             subprocess (`python -m invertible_cd_tpu_torch.cli.generate
             --model sd15`, two prompts; its own seeded bundle): exit 0, two
             512^2 JPEGs and the manifest, the process's and its generate's
             time. The edit CLI through `main(argv, _pipe=bundle)` on a seeded
             512^2 JPEG: cons, `--baseline npi`, `--baseline nti
             --nti_inner_steps 2 --uncond_cache` (the baselines on the bundle
             at `ddim_grid(EDIT_CLI_DDIM_STEPS)`, 10 steps), and the NTI run
             again, which
             must read its cache (no B3/B4, the same edited file); exact
             launches derived from the spec, the grid and NTI's inner
             iterations (B3's count over the 31 layers under the gradient);
             times each run. The executor and the server are shut down, their
             threads joined, before 4d; one JSON line holds the phase's
             times, stats and launches with the card's name and power limit;
  4d. baselines: on the same bundle's seeded teacher (the unmerged base),
             the 50-step DDIM baselines: `ddim_invert` of a seeded 512^2
             image (CFG 1.0, run on the doubled batch as JAX does),
             `ddim_generate` from its inversion at CFG 7.5, the controlled
             pair under the edit's controller at 50 steps (CFG batch 4), NPI's
             reconstruction and `null_text_inversion` (NTI_INNER_STEPS inner
             iterations at most, 1 of the reference's default of 10, so that
             the script fits its time limit with phase 5e; epsilon 1e-5)
             with its reconstruction. Checks shapes, finite images in [0, 1], exact
             launches per (kernel, Sq, Sk, d) and batch derived from the
             config, the grid, the spec and NTI's inner iterations as the run
             reports them (32 x B1 a UNet call; an NTI step of k iterations
             (2 + k) x 32 x B1 and k x 31 x B3 and B4, the layers after the
             first cross layer), an identical repeat, NTI's gradient through
             B1 with lse, B3 and B4 against the materialised path within
             UNET_REL_TOL, a tiny bundle on the card against the CPU on a
             TINY_GRID-step grid (every UNet call of the DDIM paths and the
             pair's LocalBlend maps teacher-forced; NTI per outer step with
             every inner iteration run: its first gradient and its
             embedding); times each path,
             one teacher call at batch 2 and one NTI inner iteration, and
             traces one `ddim_generate`;
  4f. int8 (after 4d, on the same bundle): int8 W8A8 inference through
             kernels Q2 (`ops/csrc/int8_quantize.cu`, the quantising pass)
             and Q1 (`ops/csrc/int8_gemm.cu`): `generate` at batch 4 then
             1 under every `quantize` mode (off, int8, int8_vae, int8_static
             before calibration), `collect_quant_stats()`, int8_static again,
             `invert` and the controlled `edit` under int8. Checks exact
             launches derived from the configs (`q1_unet_launches`,
             `q1_vae_launches`: 283 Q1 a UNet call, 40 a VAE decode, 32 an
             encode, held to the count of int8 layers, and as many Q2; B1
             and B2 at their "off" counts), finite outputs, int8 different
             from off (mean
             and max |diff| printed), int8_vae latents and "off" after
             calibration bit for bit "off"'s, int8_static without stats bit
             for bit int8; Q1 against its plain version (float64 products
             of the codes) at every launch shape of those runs on seeded
             codes: int32 accumulators equal, outputs bit for bit, with
             and without the fused bias; Q2 against its plain version at
             every launch shape of those runs (NCHW and channels-last input
             for a convolution), codes and scales bit for bit; a UNet call
             whose weight codes were dropped quantises each weight once and
             the next call none (`quant.weight_quantizations`); the generate
             CLI with `--quantize int8_static` (calibrating once), the edit
             CLI with `--quantize int8`, a `BatchingExecutor((1, 4))` on
             the int8 bundle (a lone request and a burst of 3 padded to 4,
             each served row bit for bit its row of a direct int8 generate
             of the same padded batch), `cli.quant_quality` with n = 2;
             times (one UNet call and one VAE decode off against int8,
             generate under each mode, `collect_quant_stats`), peak memory
             and the cached weight codes' bytes, Q1's rows at the batch-4
             int8 generate's five costliest shapes and its costliest dense
             one (bound: 2 M N K / 1979e12 and bytes / 3.35e12; yardsticks
             the port never calls: `torch._int_mm` plus its dequantising
             pass for a dense shape, cuDNN's bf16 convolution for a conv
             shape), and Q2's rows at its three costliest shapes and its
             costliest dense one (bound: bytes of one read of x and one
             write of codes and scales; plain: the eager quantiser; no
             library call), all on one JSON line with the card. At the end
             of 4c, the SDXL bundle's int8 generate at 1024^2, batch 1
             (`phase_int8_sdxl`): exact launches (795 Q1 and Q2 a UNet
             call; the fp32 VAE's 40 writing fp32), finite, Q1 and Q2
             against their plain versions at every shape of the fp32 VAE
             decode, and their rows at the decode's costliest shape;
  4c. sdxl:  `InvertibleCDXL.sdxl` at full SDXL width (the 2.6B UNet, ViT-L
             and bigG, the fp32 VAE) with seeded weights and seeded r=64
             reverse and forward LoRAs, at 1024^2: `generate` of one prompt
             (config 3), `invert` of a seeded 1024^2 image and the amplify
             `edit` without a controller (config 4). Checks shapes, finite
             images in [0, 1], identical output on a repeat, exact launches
             per (kernel, Sq, Sk, d) derived from `UNetConfig.sdxl()` and the
             hop count (140 x B1 a UNet call, B2's fp32 build once per VAE
             encode or decode), the bf16-VAE opt-in's decodes at batch 1 and
             2 through B2's bf16 build, one request through
             `BatchingExecutor(batch_size=1)` equal to `generate` on its
             latent bit for bit, with its launches, one full-width UNet
             call's kernel path against its materialised path, and the tiny XL bundle on
             the card against the same weights in fp32 on the CPU (every UNet
             call teacher-forced; the card's tiny VAE takes the bf16 opt-in,
             its d = 32 head going to B1); times generate, invert and edit,
             one UNet call, the fp32 VAE decode and encode and both text
             encoders, reads peak memory and traces one generate;
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
  5b. sdxl training (after 5, the SD1.5 bundle freed): full-depth
             `UNetConfig.sdxl()` at 1024^2, batch XL_TRAIN_BATCH.
             `cli.train_icd.main --model sdxl --lazy_lora --remat --data_root`
             for XL_TRAIN_STEPS (1) step on a seeded folder of 1024^2 JPEGs
             with a train.csv (the fp32 VAE encode through B2's fp32 build,
             ViT-L and bigG), with the eval after its last step on the same
             images as the val
             set (XL_EVAL_CLI_FLAGS: the inversion eval, one validation panel
             and two triptychs at the batch, with SDXL's added conditioning):
             exact launches, finite metrics under all eight names and the
             eval's three, its panels, a checkpoint, both kohya exports read
             back by `load_inference_lora` equal to the checkpoint's
             adapters; then `make_train_step` (lazy,
             remat) on synthetic batches with `added_cond`, XL_DIRECT_STEPS
             (2) counted steps after a warm-up: exact launches of
             B1, B3 and B4 per (Sq, Sk, d) (14 x 140 B1 and 4 x 140 B3 and B4
             a step, `xl_step_launches`), base (= teacher) unchanged, step ms,
             samples/s, peak memory, one traced step; one step of the merged
             path against the lazy one from one state and draws (metrics
             within UNET_REL_TOL, gradients within LAZY_GRAD_TOL) with both
             peaks; and the adapter gradient of `reverse_cd_loss` through B1
             (lse), B3 and B4 at d = 64 against the materialised path;
  5c. eval (after 5, on the generate path's bundle, before 5b frees it):
             the metric suite at full width with seeded weights in fp32,
             written as files in the published checkpoints' formats and read
             back by `evaluators_from_weights` (FID-Inception, CLIP ViT-L/14
             vision and its text tower projecting to 768, DINOv2 ViT-B/14,
             VGG16 + LPIPS heads, ImageReward = BLIP ViT-L/16 + BERT-base with
             a small vocab file): each scorer on 2 seeded images on the card
             against the same files on the CPU (relative L2 <= SCORER_TOL;
             the card's run with TF32 allowed by the caller, which the
             scorers turn off themselves), the
             FID of 8 seeded images against themselves, `fid_of_student` with
             up = 0 adapters against the teacher's images from the same bundle
             (|FID| < FID_TOL both), `eval_inversion` of 4 seeded latents with
             the bundle's students (finite latent MSE and recon-FID), no launch
             of the port's kernels from `calc_all` / `calc_inversion`;
             `cli.train_icd.main` bare (three steps at batch 2, no eval) and
             then with every eval flag on at step 3 (the FID sweep of 8
             prompts, the inversion eval of 4, one validation panel at batch
             2, two triptychs), its metrics.jsonl keys and panels (PNG files,
             or TensorBoard events where `torch.utils.tensorboard` imports);
             the generate CLI in a subprocess and the
             edit CLI through `main(_pipe=...)`, both with `--calc_metrics`
             and every scorer flag: every metric finite. Exact launches per
             (kernel, Sq, Sk, d) and batch for each counted run, derived from
             the config and the grid (a generate 4 x 32 B1 + 1 B2; a round
             trip 8 x 32 B1); times (Inception features of 8 images, each
             scorer per image, `calc_all` per pair, `fid_of_student` over 8
             prompts, the eval-enabled CLI against its three bare steps run
             just before it, and the time of each eval hook inside it) and
             peak memory with the scorers resident;
  5d. distribution (after 5, on phase 4's bundle, before 5c): the
             distribution layer (`invertible_cd_tpu_torch.parallel`) on the
             one card. (a) World size 1 over NCCL in this process: one train
             step through `make_train_step(..., mesh=make_mesh())` at batch
             2 against the step without a mesh from the same state and
             generator, bit for bit (adapters, both optimizer states,
             metrics), exact launches, both timed twice; a burst of 4
             through `BatchingExecutor(mesh=make_mesh(dp=1))` bit for bit the
             executor's without a mesh, exact launches. (b) Two ranks sharing
             the card over gloo (`--dist-worker`, two subprocesses, each
             building the seeded bundle): one step, one row a rank, against
             the one-process step at batch 2 from the same draws (the
             update within DIST_STEP_TOL and the gradients within
             DIST_GRAD_TOL relative L2, each logged metric within
             DIST_METRIC_TOL relative), both ranks' adapters and metrics
             bit for bit, the gloo all_reduce of one student's gradients
             timed alone; a dp = 2 served burst of 4, each row bit for bit
             its rank's direct generate at batch 2; exact launches per rank.
             (c) `python -m torch.distributed.run --nproc_per_node 1` of the
             train CLI (`--synthetic_data --fsdp 1`, one step at batch 2,
             NCCL): exit 0, one checkpoint and both exports, its resident
             base bytes. (d) One JSON line: the phase's times, peak memory
             (this process and each rank), launches by batch, the card. No
             dp or fsdp speed: the machine has one card;
  5e. sp and tp (after 5d): `parallel.spatial`, `parallel.tp` and the train
             step over tp and fsdp, over two
             ranks sharing the card over gloo (`--dist-worker ... --dist-job
             sptp`, two subprocesses, each building the seeded SD1.5 bundle;
             NCCL refuses two ranks on one device). Each rank generates the
             one-process references of SP_SERVE's first 1 and 2 requests (its
             peak memory above its resident bytes at sp = 1), and one UNet
             call at batch 2 on a latent whose rows grow 0.5x to 3x top to
             bottom, then the same call at sp = 2 (each rank's rows, under
             `spatial`), within SP_UNET_TOL relative L2 (exact launches);
             then a lone request and a burst of two are served at dp 1 x sp 2 through
             `BatchingExecutor(mesh=make_mesh(sp=2))` and `serve_follower`:
             exact launches per rank (B1 at Sq = S / 2 against Sk = S and at
             Sq = S / 2 against 77, B2 at (2048, 4096, 512)), the served
             images within SP_IMAGE_TOL relative L2 of the references, each
             rank's peak at sp = 2 below its peak at sp = 1 (the split shows
             in the activation bytes); then the train step from phase 5d's
             state, batch and draws (`sptp_train`), against the one-process
             step at batch 2 that rank 0 takes first, at phase 5d(b)'s gates
             (the update within DIST_STEP_TOL, the gradients within
             DIST_GRAD_TOL, each logged metric within DIST_METRIC_TOL), both
             ranks' adapters and first moments bit for bit, exact launches
             per rank: (i) `make_train_step(mesh=make_mesh(tp=2))`, merged
             LoRA, both ranks the whole batch of 2 (B1 with and without
             lse, B3 and B4 at 4 heads); (ii) `make_mesh(fsdp=2)`, one row a
             rank, each UNet unit gathered where it runs: the store's
             gathered buffers alive for no more than one unit at a time,
             their bytes never above the largest unit's of base or of
             teacher (each gather is of one of them), resident plus
             them below the whole weights, none left after the step, and
             each rank's max_memory_allocated above what it held, for the
             step and for gathering the weights whole (`step_fn.gather()`,
             measured beside it); then each rank's UNet is split over
             tp = 2 (`tensor_parallel`): one UNet call and one generate at
             batch 2, exact launches (B1 at 4 heads), within TP_UNET_TOL and
             TP_IMAGE_TOL of the one-process ones. One JSON line with the
             readings, times and peaks. No sp, tp or fsdp speed: two ranks
             share one card;
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
  7. prints each phase's wall seconds and the script's so far as one JSON
     line, the kernels' JSON line, then the device JSON as the last line.
     A kernel row's `launches` are those of its (Sq, Sk, d) in the generate
     at its batch, plus, for the batch-4 rows, the three counted train
     steps (batch 2), for the batch-1 rows the counted `invert`, and for
     the batch-2 rows the controlled generate of the counted `edit`; plus
     phase 4e's counted requests (batch 1: the lone request; batch 4: the
     burst and the HTTP requests) and edit CLI runs, at the batch each kernel
     ran at (as the baselines' below; the CLI's `invert` at 1, its pair at 2);
     the baselines' (phase 4d) at the batch each kernel ran at: NTI's B1,
     B3 and B4 at batch 1, the DDIM paths' B1 at batch 2 (the controlled
     pair's at 4), B2 at the prompts' batch; the SDXL rows those of phase
     4c (batch 1: generate, invert, the served request and the bf16 opt-in's
     decode; batch 2:
     the edited pair and its opt-in decode), plus phase 5b's counted CLI and
     direct steps at its batch; plus phase 5c's counted eval runs at the
     batch each kernel ran at (its FID sweeps at 8, the batch-8 rows' only
     launches; the train CLI's steps with phase 5's, on the batch-4 rows);
     plus phase 5d's counted runs: (a)'s mesh step with phase 5's, on the
     batch-4 rows, and its burst at 4; (b)'s two ranks' steps at 1 and their
     served rows at 2 (the ranks count in their own processes and report);
     plus phase 5e's: both ranks' served sp runs at 1 and 2 (the Sq = S / 2
     rows), the tp decode's B2 at 2 and the fsdp train step's B1, B3 and B4
     at 1; the tp runs' launches at 4 heads (the UNet call's, the
     generate's and the train step's) go to the `TP_SHAPES` rows (B1, the
     lse variant's with the plain one's) and the `TP_BACKWARD_SHAPES` rows
     (B3, B4) alone;
     B5's rows carry the harness's; Q1's rows the counted int8 runs of
     phase 4f (the generates at batch 4 and 1, invert and edit) and of the
     SDXL int8 generate, at each row's launch shape.

`--kernels-only` runs phases 1-3 and the harness (6), times Q1 at the int8
paths' costliest shapes (`Q1_COMPARE`), and prints the kernel rows;
`--q1-compare` times Q1 alone there, `--b2f32-compare` B2's fp32 build
alone at SDXL's VAE shapes (`B2F32_COMPARE`) and `--bwd160-compare` B3 and
B4 at `BACKWARD_SHAPES` (the d = 160 rows against the plain backward and
beside SDPA's backward), each printing one JSON line of rows;
`--dist-fault none|sum` runs phase 5d(b)'s two ranks alone with the
trainer's gradient reduction skipped or summed (`plant_reduction_fault`),
and `--dist-fault to_tp` phase 5e's tp = 2 train step alone with
`to_tp`'s backward sum taken out (`plant_tp_fault`), and each prints what
the step's gates read, checking nothing; `--sp-fault
halo|gn|kv` runs phase 5e's two ranks alone with sp's halo rows, GroupNorm's
reduction or the K/V gather taken out (`plant_sp_fault`) and prints what
the sp gate reads, checking nothing;
`--package-root DIR` imports the package (and builds its kernels)
from another checkout, e.g. a parent commit unpacked under `build/`, so
that two versions of the kernels are timed in one call by the same code.
Kernel times are per launch: 20 launches captured in one CUDA graph, the
graph replayed 5 times between pairs of CUDA events, the median
(`graph_ms`), so a launch shorter than its wrapper's host work is timed
too; SDPA's forward the same way. The plain versions, SDPA's backward and
the harness's rows (each above ~0.1 ms) are the median of 5 loops of 20
back-to-back calls, each loop between one pair of CUDA events (`cuda_timed`).

Q1's bound is the larger of its int8 operations / 1979e12 and its bytes
(codes, scales and output each once) / 3.35e12; Q2's its bytes (x read
once, codes and scales written once) / 3.35e12. Every other bound is the
largest of FLOPs / 989e12 (/ 494.7e12, TF32's rate, for
B2's fp32 build, whose products are TF32), exponentials / 3.9e12 (7.8e12
for B5's exp2bf16, whose ex2.approx.bf16x2 does two a MUFU issue) and
bytes / 3.35e12, in ms; "bound_limit" names which.

Exits non-zero, without the last line, if any phase fails or no CUDA
device is available.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import os
import pickle
import statistics
import subprocess
import sys
import time
import traceback

# Published dense peaks of one H100 SXM (at its 700 W limit).
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 494.7e12  # B2's fp32 build multiplies on the tensor cores in TF32
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
# Lazy against merged LoRA, one SDXL step from one state and draws: every
# metric within UNET_REL_TOL (relative), and the adapter gradients (Adam's
# first moments) within LAZY_GRAD_TOL relative L2. The merged path rounds
# every W + dW to bf16 (2^-9 relative), the lazy one keeps W and the
# low-rank path apart, and the huber loss's sign-like gradient carries
# that rounding into the adapter gradients. Both are the same function: in
# fp32 the two steps agree to ~1e-6 (tests/test_torch_training_sdxl.py); an
# adapter dropped, doubled or mis-scaled moves the gradient by O(1).
LAZY_GRAD_TOL = 0.15
TRAIN_BATCH = 2
TRAIN_STEPS = 3
METRIC_NAMES = (
    "reverse_cd_loss", "reverse_preserve_loss", "reverse_total_loss", "reverse_grad_norm",
    "forward_cd_loss", "forward_preserve_loss", "forward_total_loss", "forward_grad_norm",
)
TINY_TOL = 5e-2  # max abs image error, tiny bundle bf16 on the card vs fp32 on the CPU
# the edit phase: a source/target pair with the edit CLI's controller steps
# (cli/edit.py: cross 0.6, self 0.4), LocalBlend on the swapped word and an
# equalizer on the new one
EDIT_SOURCE = "a photo of a corgi on the beach"
EDIT_TARGET = "a photo of a cat on the beach"
EDIT_CONTROLLER = dict(cross_replace_steps=0.6, self_replace_steps=0.4,
                       blend_words=[["corgi"], ["cat"]],
                       equalizer_params={"words": ["cat"], "values": [2.0]})
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
    "flash_fwd_streamed_f32": ("invertible_cd_tpu_torch/ops/csrc/flash_fwd_streamed_f32.cu",
                               "invertible_cd_tpu/ops/flash_attention.py:160"),
    "flash_bwd_dq": ("invertible_cd_tpu_torch/ops/csrc/flash_bwd_dq.cu",
                     "invertible_cd_tpu/ops/flash_attention.py:353"),
    "flash_bwd_dkdv": ("invertible_cd_tpu_torch/ops/csrc/flash_bwd_dkdv.cu",
                       "invertible_cd_tpu/ops/flash_attention.py:419"),
    "flash_variant": ("invertible_cd_tpu_torch/ops/csrc/flash_variant.cu",
                      "tools/exp_softmax.py:53"),
}
# (kernel, batch, Sq, Sk, heads, head dim): the main path's shapes; B2 also at
# the batch-1 generate's batch, where its grid alone would fill 64 SMs. Then
# the edit path's (appended, so the inputs drawn for the rows above stay the
# same): B1 at batch 1 (the batch-1 generate and `invert`) and at batch 2 (the
# self layers of the controlled pair that the controller leaves unhooked), B2
# at batch 2 (the pair's decode)
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
    ("flash_fwd", 1, 4096, 4096, 8, 40),
    ("flash_fwd", 1, 1024, 1024, 8, 80),
    ("flash_fwd", 1, 256, 256, 8, 160),
    ("flash_fwd", 1, 64, 64, 8, 160),
    ("flash_fwd", 1, 4096, 77, 8, 40),
    ("flash_fwd", 1, 1024, 77, 8, 80),
    ("flash_fwd", 1, 256, 77, 8, 160),
    ("flash_fwd", 1, 64, 77, 8, 160),
    ("flash_fwd", 2, 4096, 4096, 8, 40),
    ("flash_fwd", 2, 1024, 1024, 8, 80),
    ("flash_fwd", 2, 256, 256, 8, 160),
    ("flash_fwd", 2, 64, 64, 8, 160),
    ("flash_fwd_streamed", 2, 4096, 4096, 1, 512),
] + [  # SDXL at 1024^2: every head d = 64 (10 heads at 64^2 tokens, 20 at 32^2),
    # batch 1 (generate, invert) and 2 (the edited pair); the VAE's d = 512 head
    # over 128^2 tokens in fp32 (the default VAE) and bf16 (the opt-in)
    ("flash_fwd", b, sq, sk, h, 64) for b in (1, 2)
    for sq, h in ((4096, 10), (1024, 20)) for sk in (sq, 77)
] + [
    (name, b, 16384, 16384, 1, 512) for name in ("flash_fwd_streamed_f32", "flash_fwd_streamed")
    for b in (1, 2)
] + [  # the DDIM baselines' CFG batch 2 leaves the cross layers unhooked
    ("flash_fwd", 2, sq, 77, 8, d) for sq, d in ((4096, 40), (1024, 80), (256, 160), (64, 160))
] + [  # the eval's FID sweeps (phase 5c) generate at batch 8
    ("flash_fwd", 8, sq, sk, 8, d) for sq, d in ((4096, 40), (1024, 80), (256, 160), (64, 160))
    for sk in (sq, 77)
] + [("flash_fwd_streamed", 8, 4096, 4096, 1, 512)] + [
    # phase 5e at sp = 2, batch 1 and 2 (the served lone request and burst):
    # a rank's queries (half the tokens) against the whole height's keys, the
    # cross layers at half the queries, the VAE mid-block's head likewise
    ("flash_fwd", b, sq // 2, sk, 8, d) for b in (1, 2)
    for sq, d in ((4096, 40), (1024, 80), (256, 160), (64, 160)) for sk in (sq, 77)
] + [("flash_fwd_streamed", b, 2048, 4096, 1, 512) for b in (1, 2)]
# phase 5e at tp = 2, batch 2: every UNet layer at half its heads
TP_SHAPES = [("flash_fwd", 2, sq, sk, 4, d)
             for sq, d in ((4096, 40), (1024, 80), (256, 160), (64, 160)) for sk in (sq, 77)]
SHAPES += TP_SHAPES
# the SDXL training phase (5b): its batch (the reference's is 8,
# configs/train_sdxl_lora.json) and steps
XL_TRAIN_BATCH = 2
XL_TRAIN_STEPS = 1  # the CLI's
XL_DIRECT_STEPS = 2  # make_train_step's counted steps, after a warm-up
XL_EVAL_CLI_FLAGS = [  # phase 5b's eval, at its last step, at its batch; no FID files
    "--validation_steps", str(XL_TRAIN_STEPS), "--validation_prompts_max", "1",
    "--validation_batch", str(XL_TRAIN_BATCH), "--inversion_validation_samples", str(XL_TRAIN_BATCH),
    "--inversion_eval_steps", str(XL_TRAIN_STEPS), "--inversion_eval_samples", str(XL_TRAIN_BATCH)]
XL_RESOLUTION = 1024
# (batch, Sq, Sk, heads, head dim) of B3 and B4: the train step's eight shapes
# (at the generate's batch) and NTI's (batch 1); then SDXL's training shapes
# at 1024^2 (d = 64: 10 heads at 64^2 tokens, 20 at 32^2) at phase 5b's batch
BACKWARD_SHAPES = [
    (b, sq, sk, 8, d) for b in (BATCH, 1)
    for sq, d in ((4096, 40), (1024, 80), (256, 160), (64, 160)) for sk in (sq, 77)
] + [
    (XL_TRAIN_BATCH, sq, sk, h, 64) for sq, h in ((4096, 10), (1024, 20)) for sk in (sq, 77)
]
# phase 5e's tp = 2 train step at batch 2: B3 and B4 at half the heads
TP_BACKWARD_SHAPES = [(2, sq, sk, 4, d)
                      for sq, d in ((4096, 40), (1024, 80), (256, 160), (64, 160)) for sk in (sq, 77)]
BACKWARD_SHAPES += TP_BACKWARD_SHAPES
# attention layers of one SD1.5 UNet call by token count (self; as many cross
# layers at Sk = 77): 2 down + 3 up at each of 4096/1024/256, 1 mid at 64
LAYERS_PER_CALL = {4096: 5, 1024: 5, 256: 5, 64: 1}
HEAD_DIM = {4096: 40, 1024: 80, 256: 160, 64: 160}


def bound(flops: float, exps: float, nbytes: float, exp_rate: float = PEAK_EXP_PER_S,
          flop_rate: float = PEAK_BF16_FLOPS) -> dict:
    """The least time the card could take for the work: the largest of its
    FLOPs, exponentials and bytes over their peak rates."""
    times = {"flops": flops / flop_rate * 1e3, "exponentials": exps / exp_rate * 1e3,
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


def graph_ms(fn, per_loop: int = LOOP_CALLS, loops: int = LOOPS, warmup: int = 2) -> float:
    """Device ms of one call of `fn`: `per_loop` calls captured in one CUDA
    graph (after a warm-up on a side stream, as capture asks), the graph
    replayed `loops` times, each replay between one pair of CUDA events; the
    median over `per_loop`. A replay issues the captured kernels with no host
    work between them, so a call shorter than its wrapper's host work is
    timed without that work. The wrappers launch on the current stream,
    which inside the capture is the graph's; their launch counts rise once
    per captured call, not per replay."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_loop):
            fn()
    graph.replay()
    times = []
    for _ in range(loops):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_loop)
    del graph
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


def phase_build(names=None):
    from invertible_cd_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    reports = fa.build(fa.LIBRARIES if names is None else names)
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

    wrappers = {"flash_fwd": fa.flash_attention, "flash_fwd_streamed": fa.flash_attention_streamed,
                "flash_fwd_streamed_f32": fa.flash_attention_streamed}
    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows = []
    failures = []
    print(f"kernels vs plain at the main path's shapes ({card}):")
    for name, batch, sq, sk, h, d in SHAPES:
        if name not in fa.KERNELS:  # a `--package-root` checkout from before that kernel
            print(f"  {name}[b={batch},sq={sq},sk={sk},h={h},d={d}]: not in this package")
            continue
        fp32 = name == "flash_fwd_streamed_f32"  # B2's fp32 build takes fp32 inputs

        def rnd(s, scale=1.0):
            x = scale * torch.randn((batch, s, h, d), generator=gen, device="cuda")
            return x if fp32 else x.to(torch.bfloat16)
        q, k, v = rnd(sq, QK_SCALE), rnd(sk, QK_SCALE), rnd(sk, V_SCALE)
        out = wrappers[name](q, k, v)
        torch.cuda.synchronize()
        if name.startswith("flash_fwd_streamed") and sq == 16384 and not torch.equal(
                out, wrappers[name](q, k, v)):
            failures.append(f"{name} b={batch} sq={sq}: a repeat gave other bits")
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
                          "lse_ms": graph_ms(lambda: fa.flash_forward_lse(q, k, v))}
            # B1's bits on these fixed-seed inputs, for the package this run imports
            print(f"  B1 bits {name}[b={batch},sq={sq},sk={sk},d={d}]: o {bits_hash(out)} "
                  f"lse {bits_hash(lse)}")
        if fp32:  # TF32 products: the lse against the plain one on q, k rounded to TF32 and to bf16
            _, lse = fa._forward_streamed_f32(q, k, v, with_lse=True)
            errs = {r: (lse - fa.attention_plain_lse(fn(q), fn(k), v)[1]).abs().max().item()
                    for r, fn in (("tf32", fa.round_tf32), ("bf16", lambda x: x.bfloat16().float()))}
            if not errs["tf32"] <= LSE_TOL:
                failures.append(f"{name} b={batch}: lse {errs['tf32']} off the TF32 plain lse")
            lse_fields = {"lse_max_abs_err_vs_tf32_inputs": errs["tf32"],
                          "lse_max_abs_err_vs_bf16_inputs": errs["bf16"]}
            del lse
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = graph_ms(lambda: wrappers[name](q, k, v))
        plain_ms = cuda_ms(lambda: fa.attention_plain(q, k, v))
        library_ms = graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
        flops = 4.0 * batch * h * sq * sk * d
        # q, k, v read once, o written once
        nbytes = (4.0 if fp32 else 2.0) * batch * h * d * (2 * sq + 2 * sk)
        rows.append({
            "name": f"{name}[b={batch},sq={sq},sk={sk},h={h},d={d}]",
            "kernel": name,
            "batch": batch,
            "shape": [sq, sk, d],
            "spec": (name, batch, sq, sk, h, d),
            "tp_split": (name, batch, sq, sk, h, d) in TP_SHAPES,
            "route": "cuda",
            "source": SOURCES[name][0],
            "replaces": SOURCES[name][1],
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            **bound(flops, batch * h * sq * sk, nbytes,
                    flop_rate=PEAK_TF32_FLOPS if fp32 else PEAK_BF16_FLOPS),
            "library_ms": library_ms,
            **lse_fields,
        })
        with_lse = (f"  with lse {lse_fields['lse_ms']:.3f} ms (lse err "
                    f"{lse_fields['lse_max_abs_err']:.1e})" if "lse_ms" in lse_fields else "")
        if fp32:
            with_lse = (f"  lse err vs plain on TF32-rounded q, k "
                        f"{lse_fields['lse_max_abs_err_vs_tf32_inputs']:.1e} (limit {LSE_TOL}), on "
                        f"bf16-rounded {lse_fields['lse_max_abs_err_vs_bf16_inputs']:.1e}")
        print(f"  {rows[-1]['name']:<48} err {err:.2e} (max|ref| {ref_max:.3f}, "
              f"err/max|ref| {err / ref_max:.2e}, limit {limit:.2e})  "
              f"kernel {ms:.3f} ms{with_lse}  plain {plain_ms:.3f} ms  sdpa {library_ms:.3f} ms  "
              f"bound {rows[-1]['bound_ms']:.4f} ms ({rows[-1]['bound_limit']})  "
              f"{flops / ms / 1e9:.1f} TFLOP/s  {'ok' if ok else 'FAIL'}")
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    check(not failures, "kernel mismatch: " + "; ".join(failures))
    return rows


def backward_flops(kernel: str, batch: int, sq: int, sk: int, h: int, d: int) -> float:
    """FLOPs of B3 (three products: S, dP, dQ) or B4 (four: S^T, dP^T, dV,
    dK) at one shape."""
    return 2.0 * {"flash_bwd_dq": 3, "flash_bwd_dkdv": 4}[kernel] * batch * h * sq * sk * d


def backward_bound(kernel: str, batch: int, sq: int, sk: int, h: int, d: int) -> dict:
    """`bound` of B3 or B4 at one shape: its products, one exponential a
    (query, key) (each recomputes P), and its bf16 tensors read or written
    once each plus the fp32 lse."""
    g = batch * h
    nbytes = {"flash_bwd_dq": 2.0 * g * d * (4 * sq + 2 * sk) + 4.0 * g * sq,    # q o do dq | k v
              "flash_bwd_dkdv": 2.0 * g * d * (3 * sq + 4 * sk) + 4.0 * g * sq}  # q o do | k v dk dv
    return bound(backward_flops(kernel, batch, sq, sk, h, d), g * sq * sk, nbytes[kernel])


def phase_backward_kernels(card: str):
    """B3 and B4 at the eight B1 shapes, at the generate's batch (the train
    step's shapes) and at batch 1 (NTI's): against the plain explicit backward
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
    print(f"backward kernels vs plain at batch {BATCH} and 1, SDXL's at {XL_TRAIN_BATCH} ({card}):")
    for batch, sq, sk, h, d in BACKWARD_SHAPES:
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
            "flash_bwd_dq": graph_ms(lambda: fa.flash_backward_dq(q, k, v, o, lse, do)),
            "flash_bwd_dkdv": graph_ms(lambda: fa.flash_backward_dkdv(q, k, v, o, lse, do)),
        }
        plain_ms = cuda_ms(lambda: fa.attention_backward_plain(q, k, v, o, lse, do))
        library_ms = cuda_ms(
            lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dot, retain_graph=True))
        for kernel, grads in (("flash_bwd_dq", ("dq",)), ("flash_bwd_dkdv", ("dk", "dv"))):
            flops = backward_flops(kernel, batch, sq, sk, h, d)
            rows.append({
                "name": f"{kernel}[b={batch},sq={sq},sk={sk},h={h},d={d}]",
                "kernel": kernel,
                "batch": batch,
                "shape": [sq, sk, d],
                "tp_split": (batch, sq, sk, h, d) in TP_BACKWARD_SHAPES,
                "route": "cuda",
                "source": SOURCES[kernel][0],
                "replaces": SOURCES[kernel][1],
                "max_abs_err": max(errs[n][0] for n in grads),
                "rel_err": max(errs[n][0] / errs[n][1] for n in grads),
                "ms": times[kernel],
                "plain_ms": plain_ms,
                **backward_bound(kernel, batch, sq, sk, h, d),
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


def edit_path_launches(spec, n_hops: int, per_call, vae_key):
    """Kernel launches per (kernel, Sq, Sk, d) of `invert` at batch 1 and of
    the controlled generate of `edit`, derived from one UNet call's launches
    (`per_call`, see `unet_launches_per_call`) and the controller spec (not
    from its routing predicate, which they check). `invert`: every layer of
    every hop on B1, and B2 (`vae_key`) in the VAE encoder's mid-block. The
    controlled pair: a replace or refine controller hooks every cross layer;
    a self layer of more than 32^2 tokens is never hooked (it passes through
    unedited and unstored); one of <= 32^2 tokens is hooked in the
    self-replace hops, and in every hop when the spec stores all maps; B2
    decodes the pair."""
    check(spec.kind in ("replace", "refine"), f"controller kind {spec.kind}")
    lo, hi = spec.self_replace_range
    invert = collections.Counter({key: n_hops * c for key, c in per_call.items()})
    pair = collections.Counter()
    for (kernel, sq, sk, d), c in per_call.items():
        for step in range(n_hops):
            if sk == sq and (sq > 32 * 32 or not (spec.store_all or lo <= step < hi)):
                pair[(kernel, sq, sk, d)] += c
    invert[vae_key] = 1
    pair[vae_key] = 1
    return invert, pair


def forced_edit_errors(cpu_pipe, gpu_pipe, image, noise, controller):
    """The CPU pipe's fp32 `edit` (its invert's forward hops, then the
    controlled pair's reverse hops), with every UNet call and every step
    callback (LocalBlend) repeated by the card pipe on the same inputs
    (teacher forcing) under the card's own controller runtime, stepping in
    lockstep with the CPU's. Returns the relative L2, card against CPU, of
    each call's epsilon (`unet`), of each blended latent (`blend`) and of the
    16^2 cross maps each blend accumulated (`maps`, the worst layer), how
    far each CPU blend moved its latent (`moved`, relative L2; 0 where it
    kept every pixel), and the CPU's images. A random tiny bundle amplifies rounding along the hops (on
    the CPU alone, bf16 against fp32, its edited images differ by up to 1.0),
    so the two pipes are compared call by call, not end to end."""
    from invertible_cd_tpu_torch.edit import ControllerRuntime
    from invertible_cd_tpu_torch.pipelines import sampler
    from invertible_cd_tpu_torch.pipelines.pipeline import InvertibleCD

    dev = gpu_pipe.device
    card_rt = ControllerRuntime(controller[0], controller[1].to(dev))
    step, errs = [0], {"unet": [], "blend": [], "maps": [], "moved": []}

    def rel(got, want):
        return ((got.float().cpu() - want).norm() / want.norm()).item()

    def forced(unet, added=None):  # stands in for the CPU pipe's `_noise_model`
        name = next(k for k, u in cpu_pipe.unets.items() if u is unet)
        cpu_nm = InvertibleCD._noise_model(cpu_pipe, unet)
        card_nm = InvertibleCD._noise_model(gpu_pipe, gpu_pipe.unets[name])

        def nm(latent, t, context, w_emb, hook=None):
            eps = cpu_nm(latent, t, context, w_emb, hook)
            card_hook = None
            if hook is not None:  # one hook a hop, in hop order
                card_hook, step[0] = card_rt.hook_factory(step[0]), step[0] + 1
            got = card_nm(latent.to(dev), t, context.to(dev),
                          None if w_emb is None else w_emb.to(dev), card_hook).cpu()
            errs["unet"].append(rel(got, eps))
            return eps
        return nm

    cons_generation = sampler.cons_generation

    def forced_generation(*args, step_callback=None, **kwargs):
        def blend(latent, i):  # the card runtime's step callback on the same pre-blend latent
            want = step_callback(latent, i)
            errs["blend"].append(rel(card_rt.step_callback(latent.to(dev), i), want))
            errs["moved"].append(rel(want, latent))
            cpu_maps = step_callback.__self__._accum_maps  # the CPU's runtime
            errs["maps"].append(max(rel(g, w) for g, w in zip(card_rt._accum_maps, cpu_maps)))
            return want
        return cons_generation(*args, step_callback=blend if step_callback else None, **kwargs)

    cpu_pipe._noise_model = forced
    sampler.cons_generation = forced_generation
    try:
        images, _ = cpu_pipe.edit(image, EDIT_SOURCE, EDIT_TARGET, controller, noise=noise)
    finally:
        del cpu_pipe._noise_model
        sampler.cons_generation = cons_generation
    return errs, images


def phase_edit(card: str, pipe):
    """The edit path on the generate path's bundle: `invert` and `edit` with
    the launch counters reset, checks, times and one traced edit. Returns the
    launches per (kernel, Sq, Sk, d) at batch 1 (the counted `invert`) and
    at batch 2 (the controlled generate of the counted `edit`)."""
    import numpy as np
    import torch

    from invertible_cd_tpu_torch.edit import make_controller
    from invertible_cd_tpu_torch.ops import flash_attention as fa
    from invertible_cd_tpu_torch.pipelines.pipeline import InvertibleCD
    from invertible_cd_tpu_torch.testing import tiny_configs
    from invertible_cd_tpu_torch.utils.tokenizer import HashTokenizer

    n_hops = pipe.grid.num_reverse_steps
    pair = [EDIT_SOURCE, EDIT_TARGET]
    image = np.random.default_rng(21).integers(0, 256, (512, 512, 3), dtype=np.uint8)
    noise = torch.randn((1, 64, 64, 4), generator=torch.Generator(device="cuda").manual_seed(22),
                        device="cuda")
    controller = make_controller(pair, pipe.tokenizer, n_hops, **EDIT_CONTROLLER)
    want_invert, want_pair = edit_path_launches(
        controller[0], n_hops, unet_launches_per_call(pipe.unets["reverse"].cfg, 64),
        ("flash_fwd_streamed", 4096, 4096, 512))
    print(f"edit: {controller[0]}")

    def edit():
        return pipe.edit(image, EDIT_SOURCE, EDIT_TARGET, controller, noise=noise)

    pipe.invert(image, EDIT_SOURCE, noise=noise)  # warm-up: plans and handles at batch 1 and 2
    edit()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # ---- the edit path: counts reset just before, read just after ----
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    inv, clean = pipe.invert(image, EDIT_SOURCE, noise=noise)
    torch.cuda.synchronize()
    invert_s = time.perf_counter() - t0
    invert_launches = collections.Counter(fa.LAUNCH_SHAPES)
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    images, latents = edit()
    torch.cuda.synchronize()
    edit_s = time.perf_counter() - t0
    edit_launches = collections.Counter(fa.LAUNCH_SHAPES)
    # --------------------------------------------------------------------
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    pair_launches = edit_launches - invert_launches
    totals = {name: (sum(n for k, n in invert_launches.items() if k[0] == name),
                     sum(n for k, n in pair_launches.items() if k[0] == name)) for name in fa.KERNELS}
    print(f"  launches (invert, controlled pair of edit): {totals}")
    check(invert_launches == want_invert, f"invert launches {dict(invert_launches)} != {dict(want_invert)}")
    check(edit_launches == want_invert + want_pair,
          f"edit launches {dict(edit_launches)} != {dict(want_invert + want_pair)}")
    print(f"  derived from the spec and launched: invert {sum(want_invert.values())} "
          f"(B1 {totals['flash_fwd'][0]}, B2 {totals['flash_fwd_streamed'][0]}); controlled pair "
          f"{sum(want_pair.values())} (B1 {totals['flash_fwd'][1]}, B2 {totals['flash_fwd_streamed'][1]})")

    for name, t, shape in (("inverted latent", inv, (1, 64, 64, 4)), ("clean latent", clean, (1, 64, 64, 4)),
                           ("edited latents", latents, (2, 64, 64, 4)), ("images", images, (2, 512, 512, 3))):
        check(tuple(t.shape) == shape and bool(torch.isfinite(t).all()),
              f"{name} {tuple(t.shape)} != {shape} or not finite")
    check(0.0 <= images.min().item() and images.max().item() <= 1.0, "images outside [0, 1]")
    again, _ = edit()
    check(torch.equal(again, images), "the same image and noise gave a different edit")
    print("  same image and noise -> identical edit: ok")

    # row 0 is never edited: the reconstruction of the inversion at w = 0
    recon, recon_lat = pipe.generate([EDIT_SOURCE], latent=inv,
                                     guidance=pipe.default_guidance(guidance_scale=0.0))
    rel = ((latents[:1] - recon_lat).norm() / recon_lat.norm()).item()
    moved = ((latents[1:] - latents[:1]).norm() / latents[:1].norm()).item()
    print(f"  row 0 vs generate([source], latent=inversion, w=0): latent relative L2 {rel:.3e} "
          f"(tol {UNET_REL_TOL}), max abs image error {(images[:1] - recon).abs().max().item():.3e}; "
          f"row 1 differs from row 0 by {moved:.3f} (relative L2)")
    check(rel <= UNET_REL_TOL, f"row 0 of the edit off the reconstruction by {rel}")

    t0 = time.perf_counter()
    pipe.generate(pair, latent=inv.expand(2, -1, -1, -1), controller=controller,
                  guidance=pipe.default_guidance(guidance_scale=19.0, dynamic_guidance=True,
                                                 tau1=0.8, tau2=0.8, edit_pair=True))
    torch.cuda.synchronize()
    pair_s = time.perf_counter() - t0

    # a tiny bundle's invert + edit on the card (bf16, kernels) against the same
    # weights in fp32 on the CPU: the VAE encode end to end, every UNet call and
    # every LocalBlend step teacher-forced (see `forced_edit_errors`). Its LoRAs have rank 64, so they
    # merge at the full-size bundle's scale alpha / rank = 8 / 64 (at rank 4 the
    # scale is 2 and the tiny UNet's own bf16 rounding reaches 2-5% a call)
    unet_cfg, clip_cfg, vae_cfg = tiny_configs()
    cfgs = dict(unet_cfg=unet_cfg, clip_cfg=clip_cfg, vae_cfg=vae_cfg, latent_size=(16, 16))
    cpu_pipe = InvertibleCD.sd15(device="cpu", dtype=torch.float32, seed=7, lora_rank=64,
                                 tokenizer=HashTokenizer(clip_cfg.vocab_size), **cfgs)
    params = {name: m.state_dict() for name, m in (
        ("reverse", cpu_pipe.unets["reverse"]), ("forward", cpu_pipe.unets["forward"]),
        ("text", cpu_pipe.text_encoder), ("vae", cpu_pipe.vae))}
    gpu_pipe = InvertibleCD.sd15(params=params, device="cuda", dtype=torch.bfloat16,
                                 tokenizer=cpu_pipe.tokenizer, **cfgs)
    tiny_controller = make_controller(pair, cpu_pipe.tokenizer, n_hops, **EDIT_CONTROLLER)
    tiny_image = np.random.default_rng(23).integers(0, 256, (32, 32, 3), dtype=np.uint8)
    tiny_noise = torch.randn((1, 16, 16, 4), generator=torch.Generator().manual_seed(24))
    want_inv, want_clean = cpu_pipe.invert(tiny_image, EDIT_SOURCE, noise=tiny_noise)
    got_inv, got_clean = gpu_pipe.invert(tiny_image, EDIT_SOURCE, noise=tiny_noise)
    clean_err = (got_clean.cpu() - want_clean).abs().max().item()
    errs, want_img = forced_edit_errors(cpu_pipe, gpu_pipe, tiny_image, tiny_noise, tiny_controller)
    got_img, _ = gpu_pipe.edit(tiny_image, EDIT_SOURCE, EDIT_TARGET, tiny_controller, noise=tiny_noise)
    check(bool(torch.isfinite(got_img).all()), "tiny bundle edit on the card is not finite")
    def fmt(name, spec="1e"):
        return " ".join(f"{e:.{spec}}" for e in errs[name])

    print(f"  tiny bundle, card bf16 vs CPU fp32: VAE encode max abs error {clean_err:.3e} "
          f"(tol {TINY_TOL}); teacher-forced, relative L2 (tol {UNET_REL_TOL}): the "
          f"{len(errs['unet'])} UNet calls' epsilon {fmt('unet')}, the {len(errs['blend'])} "
          f"LocalBlend steps' accumulated maps {fmt('maps')} and blended latents {fmt('blend')} "
          f"(each CPU blend moved its latent by {fmt('moved', '2e')}); not gated, end to end: "
          f"inverted latent max abs error {(got_inv.cpu() - want_inv).abs().max().item():.3e}, "
          f"edited images {(got_img.cpu() - want_img).abs().max().item():.3e}")
    check(clean_err <= TINY_TOL, f"tiny bundle VAE encode off by {clean_err}")
    check(len(errs["unet"]) == 2 * n_hops and max(errs["unet"]) <= UNET_REL_TOL,
          f"tiny bundle UNet calls off by {errs['unet']}")
    check(len(errs["blend"]) == n_hops and max(errs["blend"] + errs["maps"]) <= UNET_REL_TOL,
          f"tiny bundle LocalBlend off: maps {errs['maps']}, latents {errs['blend']}")

    print(f"  invert (batch 1): {invert_s * 1e3:.1f} ms; controlled generate of the pair: "
          f"{pair_s * 1e3:.1f} ms; edit (invert + controlled pair): {edit_s * 1e3:.1f} ms; "
          f"peak memory {peak_gb:.2f} GiB ({card})")
    trace_run("edit, invert + controlled pair", edit)
    return {1: invert_launches, 2: pair_launches}


# the serving phase (4e): the executor's batch sizes and coalescing window, a
# lone request, and a burst of eight distinct requests, one a thread (seeds at
# both ends of int64 among them); the generate CLI's two prompts
SERVE_BATCH_SIZES = (1, 4)
SERVE_MAX_DELAY = 0.01
LONE = ("a photo of a corgi on the beach", 7)
BURST = [
    ("an astronaut riding a horse on the moon, detailed", 101),
    ("a watercolor painting of a lighthouse at dawn", -(2**63)),
    ("a bowl of ramen, studio lighting", 2**63 - 1),
    ("a red fox in the snow", 3),
    ("a city street at night, neon lights", 2**40 + 5),
    ("a sailing boat on a calm lake", -12345),
    ("a portrait of an old man, oil painting", 77),
    ("a cup of coffee on a wooden table", 2**31),
]
SERVE_LATENCY_RUNS = 5  # lone requests timed one after another (median)
SERVE_BURST_RUNS = 3    # bursts timed (the first one counted)
# the edit CLI's baselines in phase 4e: DDIM steps (the reference's 50 cut
# to 10, so that the script fits its time limit with phase 5e) and NTI's
# inner iterations an outer step
EDIT_CLI_DDIM_STEPS = 10
EDIT_CLI_NTI_INNER = 2
GENERATE_CLI_PROMPTS = ["a photo of a corgi on the beach", "a red fox"]


def burst_requests(ex, requests):
    """Submit `requests` from one thread each, released together. Returns
    (the images by request, the order in which they were queued, seconds
    from the release to the last image)."""
    import threading

    lock, order, futs = threading.Lock(), [], [None] * len(requests)
    release = threading.Barrier(len(requests) + 1)

    def client(i):
        release.wait()
        with lock:  # the queue's order, recorded
            futs[i] = ex.submit(*requests[i])
            order.append(i)
    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(requests))]
    for t in threads:
        t.start()
    release.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(60)
    images = [f.result(timeout=600) for f in futs]
    return images, order, time.perf_counter() - t0


def check_images(images, shape, label):
    import numpy as np

    for img in images:
        check(img.shape == shape and img.dtype == np.float32 and bool(np.isfinite(img).all())
              and 0.0 <= img.min() and img.max() <= 1.0,
              f"{label}: image {img.shape} {img.dtype} not finite or outside [0, 1]")


def phase_serve(card: str, pipe):
    """The serving paths on the generate path's bundle: the executor (a lone
    request, a burst from eight threads, a cancelled request), the HTTP
    server over a real socket, the generate CLI in a subprocess as users
    start it (its own seeded bundle), and the edit CLI's cons, NPI and NTI
    modes (NTI twice, the second run from its cache). Launch counts are reset
    just before each counted run and read just after. Returns the launches per
    (kernel, Sq, Sk, d) by the batch each kernel ran at."""
    import dataclasses
    import io
    import tempfile
    import threading
    import urllib.error
    import urllib.request

    import numpy as np
    import torch
    from PIL import Image

    import invertible_cd_tpu_torch
    from invertible_cd_tpu_torch.cli import edit as edit_cli
    from invertible_cd_tpu_torch.cli import serve as serve_cli
    from invertible_cd_tpu_torch.edit import make_controller
    from invertible_cd_tpu_torch.ops import flash_attention as fa
    from invertible_cd_tpu_torch.pipelines.pipeline import to_uint8
    from invertible_cd_tpu_torch.serving import BatchingExecutor
    from invertible_cd_tpu_torch.utils.images import encode_png

    cfg, side = pipe.unets["reverse"].cfg, pipe.latent_size[0]
    n_hops, n = pipe.grid.num_reverse_steps, pipe.grid.n_steps
    pix = side * 2 ** (len(pipe.vae.cfg.block_out_channels) - 1)
    shape = (pix, pix, 3)
    per_call = unet_launches_per_call(cfg, side)
    vae_key = ("flash_fwd_streamed", side * side, side * side, pipe.vae.cfg.block_out_channels[-1])
    vae = collections.Counter({vae_key: 1})
    per_batch = collections.Counter({k: n_hops * c for k, c in per_call.items()}) + vae

    def times(counter, k):
        return collections.Counter({key: k * c for key, c in counter.items()})

    def totals(counter):
        return {name: sum(c for key, c in counter.items() if key[0] == name)
                for name in fa.KERNELS if any(key[0] == name for key in counter)}
    by_batch = collections.defaultdict(collections.Counter)
    report = {"phase": "4e serve", "card": card}

    def direct(ex, requests):
        """`pipe.generate` on the requests at their batch's size, on the
        executor's latents: the rows the executor must have served."""
        images, _ = pipe.generate([p for p, _ in requests], latent=ex._latents([s for _, s in requests]),
                                  guidance=ex.guidance)
        return images.cpu().numpy()

    # ---- 1. the executor ----
    print(f"serve: BatchingExecutor(batch_sizes={SERVE_BATCH_SIZES}, max_delay={SERVE_MAX_DELAY}) on "
          f"the generate path's bundle; {per_batch.total()} launches a batch "
          f"({totals(per_batch)}) ({card})")
    ex = BatchingExecutor(pipe, batch_sizes=SERVE_BATCH_SIZES, max_delay=SERVE_MAX_DELAY)
    try:
        # ---- the lone request and the burst: counts reset just before each, read just after ----
        fa.reset_launch_counts()
        lone = ex.submit(*LONE).result(timeout=600)
        lone_launches = collections.Counter(fa.LAUNCH_SHAPES)
        fa.reset_launch_counts()
        burst, order, burst_s = burst_requests(ex, BURST)
        burst_launches = collections.Counter(fa.LAUNCH_SHAPES)
        # ------------------------------------------------------------------------------------
        stats = ex.stats()
        print(f"  stats after the lone request and the burst of {len(BURST)}: {stats}; queue order "
              f"{order}")
        check(stats == {"requests": 1 + len(BURST), "batches": 3, "padded_slots": 0, "expired": 0,
                        "batches_b1": 1, "batches_b4": 2},
              f"the lone request at batch 1 and the burst as two batches of 4: {stats}")
        check(lone_launches == per_batch, f"lone request launches {dict(lone_launches)}")
        check(burst_launches == times(per_batch, 2), f"burst launches {dict(burst_launches)}")
        by_batch[1] += lone_launches
        by_batch[4] += burst_launches
        check_images([lone] + burst, shape, "served")

        # each served image is, bit for bit, its row of a direct generate of its
        # batch (the same requests in the same rows); not gated: the same rows
        # in reverse order
        check(np.array_equal(lone, direct(ex, [LONE])[0]), "the lone request differs from generate")
        moved = []
        for j in range(2):
            idx = order[4 * j:4 * j + 4]
            rows = direct(ex, [BURST[i] for i in idx])
            check(all(np.array_equal(burst[i], row) for i, row in zip(idx, rows)),
                  f"burst batch {j} differs from generate at batch 4")
            flipped = direct(ex, [BURST[i] for i in idx[::-1]])
            moved += [float(np.abs(burst[i] - row).max()) for i, row in zip(idx[::-1], flipped)]
        report["rows_reversed_max_abs_diff"] = max(moved)
        print(f"  served images = rows of generate at the same batch size on the same latents in the "
              f"same rows, bit for bit (lone at 1, both burst batches at 4); the batches' rows "
              f"reversed: max abs difference {max(moved):.3e}, {sum(m > 0 for m in moved)} of "
              f"{len(moved)} rows differ (not gated)")

        # a cancelled request does not poison its batch (cancelled within the
        # coalescing window, so the batch is the other two, padded); the lone
        # request again, inside a batch of 4 (not gated against batch 1)
        keep = ex.submit(*LONE)
        cancelled = ex.submit("a request its client gave up on", seed=5)
        check(cancelled.cancel(), "a queued request could not be cancelled")
        other = ex.submit(*BURST[0])
        served = [keep.result(timeout=600), other.result(timeout=600)]
        rows = direct(ex, [LONE] + [BURST[0]] * 3)
        check(all(np.array_equal(a, b) for a, b in zip(served, rows)),
              "the requests beside a cancelled one differ from generate of their batch")
        after = ex.stats()
        check(after["batches_b4"] == 3 and after["requests"] == stats["requests"] + 3
              and after["padded_slots"] == 2, f"the batch with the cancelled request: {after}")
        report["cross_size_max_abs_diff"] = float(np.abs(served[0] - lone).max())
        print(f"  cancelled request: its batch served the other two, bit for bit; the lone request "
              f"served at batch 4 vs at batch 1: max abs difference "
              f"{report['cross_size_max_abs_diff']:.3e} (not gated)")

        # times (host clock, each ending in the futures' results)
        latency = []
        for _ in range(SERVE_LATENCY_RUNS):
            t0 = time.perf_counter()
            ex.submit(*LONE).result(timeout=600)
            latency.append(time.perf_counter() - t0)
        rates = [len(BURST) / burst_s]
        for _ in range(SERVE_BURST_RUNS - 1):
            rates.append(len(BURST) / burst_requests(ex, BURST)[2])
        stats = ex.stats()
    finally:
        ex.shutdown(timeout=60)
    check(not ex._worker.is_alive() and not ex._completer.is_alive(), "the executor's threads live on")
    report["lone_latency_ms"] = {"median": statistics.median(latency) * 1e3,
                                 "runs": [t * 1e3 for t in latency]}
    report["burst_requests_per_s"] = {"median": statistics.median(rates), "runs": rates}
    report["stats"] = stats
    print(f"  lone request latency (batch 1): median {report['lone_latency_ms']['median']:.1f} ms of "
          f"{SERVE_LATENCY_RUNS}; burst of {len(BURST)} (two batches of 4): "
          + " / ".join(f"{r:.2f}" for r in rates) + f" requests/s ({card})")

    # ---- 2. HTTP over a real socket: the four requests coalesce into one batch ----
    # (one size, 4, and a window long enough for all four to arrive: the batch
    # is full, and dispatched, as the fourth one is queued)
    args = serve_cli.parse_args(["--port", "0", "--batch_size", "4", "--max_delay_ms", "2000"])
    server, sex = serve_cli.make_server(args, pipe=pipe)
    queued, submit, queue_lock = [], sex.submit, threading.Lock()

    def recording_submit(*a, **kw):  # the queue's order, recorded
        with queue_lock:
            fut = submit(*a, **kw)
            queued.append((a[0], kw.get("seed")))
        return fut
    sex.submit = recording_submit
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    requests = BURST[:4]
    replies, rtt = [None] * len(requests), [None] * len(requests)

    def post(i):
        body = json.dumps({"prompt": requests[i][0], "seed": requests[i][1]}).encode()
        t0 = time.perf_counter()
        with urllib.request.urlopen(urllib.request.Request(url + "/generate", data=body, method="POST"),
                                    timeout=600) as r:
            replies[i] = (r.status, r.headers["Content-Type"], r.read())
        rtt[i] = time.perf_counter() - t0
    try:
        # ---- the HTTP requests: counts reset just before, read just after ----
        fa.reset_launch_counts()
        clients = [threading.Thread(target=post, args=(i,)) for i in range(len(requests))]
        for t in clients:
            t.start()
        for t in clients:
            t.join(600)
        http_launches = collections.Counter(fa.LAUNCH_SHAPES)
        # -----------------------------------------------------------------------
        http_stats = sex.stats()
        check(all(r is not None and r[0] == 200 and r[1] == "image/png" for r in replies),
              f"HTTP replies {[r and r[:2] for r in replies]}")
        check(http_stats == {"requests": 4, "batches": 1, "padded_slots": 0, "expired": 0,
                             "batches_b4": 1} and http_launches == per_batch,
              f"HTTP launches {dict(http_launches)} for {http_stats}")
        by_batch[4] += http_launches
        decoded = [np.asarray(Image.open(io.BytesIO(r[2]))) for r in replies]
        rows = direct(sex, queued)  # the executor's images: its batch, in its rows
        check(sorted(queued) == sorted(requests) and all(
            d.shape == shape and np.array_equal(d, to_uint8(rows[queued.index(req)]))
            for d, req in zip(decoded, requests)),
            "an HTTP reply differs from the executor's image for its seed")
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        check(health["status"] == "ok" and health["requests"] == len(requests), f"healthz {health}")
        # the server's host work on a reply: to_uint8 and the PNG encode of one image
        png_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            encode_png(to_uint8(rows[0]))
            png_s.append(time.perf_counter() - t0)
        try:
            urllib.request.urlopen(urllib.request.Request(url + "/generate", data=b"{not json",
                                                          method="POST"), timeout=60)
            bad = 200
        except urllib.error.HTTPError as e:
            bad = e.code
        check(bad == 400, f"a malformed body got {bad}")
    finally:
        server.shutdown()
        sex.shutdown(timeout=60)
        server.server_close()
        thread.join(60)
    check(not thread.is_alive() and not sex._worker.is_alive(), "the server's threads live on")
    report["http_round_trip_ms"] = {"median": statistics.median(rtt) * 1e3, "runs": [t * 1e3 for t in rtt]}
    report["png_encode_ms"] = statistics.median(png_s) * 1e3
    report["http_stats"] = http_stats
    print(f"  HTTP: {len(requests)} concurrent POST /generate in one batch of 4, each PNG = the "
          f"executor's image for its seed; /healthz {health['status']}; malformed body "
          f"-> 400; round trip median {report['http_round_trip_ms']['median']:.1f} ms; to_uint8 + "
          f"PNG encode of one reply {report['png_encode_ms']:.1f} ms (host) ({card})")

    root = os.path.dirname(os.path.dirname(os.path.abspath(invertible_cd_tpu_torch.__file__)))
    with tempfile.TemporaryDirectory() as tmp:
        # ---- 3. the generate CLI as users start it: its own process and seeded bundle ----
        out = os.path.join(tmp, "generate")
        cmd = [sys.executable, "-m", "invertible_cd_tpu_torch.cli.generate", "--model", "sd15"]
        for prompt in GENERATE_CLI_PROMPTS:
            cmd += ["--prompt", prompt]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd + ["--out", out], cwd=root, capture_output=True, text=True,
                              timeout=600)
        cli_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"the generate CLI exited {proc.returncode}: {proc.stderr[-3000:]}")
        with open(os.path.join(out, "manifest.json")) as f:
            manifest = json.load(f)
        check(manifest["prompts"] == GENERATE_CLI_PROMPTS and len(manifest["files"]) == 2,
              f"manifest {manifest}")
        files = [np.asarray(Image.open(path)) for path in manifest["files"]]
        check(all(f.shape == shape and f.dtype == np.uint8 for f in files), "generate CLI images")
        generate_ms = float(proc.stdout.split(" generated 2 in ")[1].split(" ms")[0])
        # not gated: the same seeded weights and generator in this process
        g = pipe.default_guidance(guidance_scale=19.0, dynamic_guidance=True, tau1=0.8, tau2=0.8)
        here, _ = pipe.generate(GENERATE_CLI_PROMPTS, guidance=g,
                                generator=torch.Generator(device="cuda").manual_seed(150))
        def jpeg(img):  # as PIL writes it to a .jpg file
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="JPEG")
            return buf.getvalue()
        same = True
        for path, img in zip(manifest["files"], to_uint8(here)):
            with open(path, "rb") as f:
                same = same and f.read() == jpeg(img)
        report["generate_cli"] = {"wall_s": cli_s, "generate_ms": generate_ms,
                                  "same_as_this_process": same}
        print(f"  generate CLI (python -m invertible_cd_tpu_torch.cli.generate --model sd15, 2 "
              f"prompts): exit 0, {len(files)} images of {shape[:2]}, manifest; process {cli_s:.1f} s, "
              f"its generate {generate_ms:.1f} ms; its JPEGs decode as this process's generate with "
              f"the same seed and weights: {same} (not gated) ({card})")

        # ---- 4. the edit CLI on one seeded image file, through main(_pipe=the bundle) ----
        image_path = os.path.join(tmp, "in.jpg")
        Image.fromarray(np.random.default_rng(51).integers(0, 256, shape, dtype=np.uint8)).save(image_path)
        cache = os.path.join(tmp, "uncond.pkl")
        nti_flags = ["--baseline", "nti", "--nti_inner_steps", str(EDIT_CLI_NTI_INNER),
                     "--uncond_cache", cache]
        runs = [("cons", []), ("npi", ["--baseline", "npi"]), ("nti", nti_flags),
                ("nti from its cache", nti_flags)]
        spec4 = make_controller([EDIT_SOURCE, EDIT_TARGET], pipe.tokenizer, n_hops, cross_replace_steps=0.6,
                                self_replace_steps=0.4, blend_words=[["corgi"], ["cat"]])[0]
        ddim_pipe = dataclasses.replace(pipe, grid=ddim_grid(EDIT_CLI_DDIM_STEPS))  # the baselines' runs
        n = ddim_pipe.grid.n_steps
        spec_ddim = make_controller([EDIT_SOURCE, EDIT_TARGET], pipe.tokenizer, n, cross_replace_steps=0.6,
                                 self_replace_steps=0.4, blend_words=[["corgi"], ["cat"]])[0]
        invert, pair = edit_path_launches(spec4, n_hops, per_call, vae_key)
        ddim_invert = {2: times(per_call, n), 1: vae}  # CFG batch 2; the VAE encode at batch 1
        ddim_pair = {4: edit_path_launches(spec_ddim, n, per_call, vae_key)[1] - vae, 2: vae}
        grad_layers = per_call - collections.Counter({first_self_layer(cfg, side): 1})
        edit_s, edited, edit_launches = {}, {}, {}
        for label, extra in runs:
            out = os.path.join(tmp, label.replace(" ", "_"))
            argv = ["--model", "sd15", "--image", image_path, "--source", EDIT_SOURCE,
                    "--target", EDIT_TARGET, "--out", out] + extra
            # ---- one edit CLI run: counts reset just before, read just after ----
            fa.reset_launch_counts()
            t0 = time.perf_counter()
            edit_cli.main(argv, _pipe=pipe if label == "cons" else ddim_pipe)
            torch.cuda.synchronize()
            edit_s[label] = time.perf_counter() - t0
            edit_launches[label] = collections.Counter(fa.LAUNCH_SHAPES)
            # ---------------------------------------------------------------------
            with open(os.path.join(out, "results.json")) as f:
                results = json.load(f)["results"]
            check(len(results) == 1 and results[0]["source"] == EDIT_SOURCE
                  and results[0]["target"] == EDIT_TARGET, f"{label}: results.json {results}")
            with open(results[0]["file"], "rb") as f:
                edited[label] = f.read()
            for path in (results[0]["file"], results[0]["file"].replace("_edited", "_rec")):
                check(np.asarray(Image.open(path)).shape == shape, f"{label}: {path}")
        k = totals(edit_launches["nti"]).get("flash_bwd_dq", 0) // sum(grad_layers.values())
        check(n <= k <= EDIT_CLI_NTI_INNER * n,
              f"NTI ran {k} inner iterations in {n} steps of at most {EDIT_CLI_NTI_INNER}")
        want = {"cons": {1: invert, 2: pair},
                "npi": {b: ddim_invert.get(b, collections.Counter()) + ddim_pair.get(b, collections.Counter())
                        for b in (1, 2, 4)}}
        want["nti from its cache"] = want["npi"]
        want["nti"] = dict(want["npi"])
        want["nti"][1] = want["npi"][1] + nti_path_launches(per_call, grad_layers, 2 * n + k, k)
        for label, by in want.items():
            expected = sum(by.values(), collections.Counter())
            check(edit_launches[label] == expected,
                  f"edit CLI {label}: launches {dict(edit_launches[label])} != {dict(expected)}")
            for b, counter in by.items():
                by_batch[b] += counter
        check(totals(edit_launches["nti from its cache"]).get("flash_bwd_dq", 0) == 0
              and totals(edit_launches["nti from its cache"]).get("flash_bwd_dkdv", 0) == 0,
              "the cached NTI run launched a backward kernel")
        check(edited["nti from its cache"] == edited["nti"], "the cached NTI run edited differently")
        with open(cache, "rb") as f:
            stored = pickle.load(f)
        check(list(stored) == [EDIT_SOURCE] and stored[EDIT_SOURCE].shape == (n, 1, 77, cfg.cross_attention_dim)
              and stored[EDIT_SOURCE].dtype == np.float32, "the NTI cache file")
    report["edit_cli_s"] = edit_s
    report["nti_inner_iterations"] = k
    report["launches"] = {label: totals(c) for label, c in edit_launches.items()}
    report["launches"].update(lone=totals(lone_launches), burst=totals(burst_launches),
                              http=totals(http_launches))
    print("  edit CLI (main, the generate path's bundle): " + "; ".join(
        f"{label} {edit_s[label]:.2f} s, launches {totals(edit_launches[label])}" for label, _ in runs)
        + f"; NTI ran {k} inner iterations, its rerun read the cache: no B3/B4, the same edited "
          f"JPEG; launches derived from the spec, the grid and k: exact ({card})")
    print(json.dumps(report))
    return by_batch


# the DDIM baselines (phase 4d): NTI at the reference's epsilon and 1 of
# its 10 inner iterations an outer step, which keeps the script inside its
# time limit with phase 5e
DDIM_CFG = 7.5
NTI_INNER_STEPS = 1
NTI_EPSILON = 1e-5
# the tiny bundle on the card against the CPU: a 10-step grid for its
# teacher-forced DDIM paths (each call is held on the CPU's inputs, so more
# steps add calls, not drift) and its NTI, 3 inner iterations an outer step
TINY_GRID = 10
TINY_NTI_INNER = 3


def ddim_grid(n_steps: int):
    """The bundle's solver grid (`InvertibleCD.sd15`'s consistency
    endpoints) at `n_steps` DDIM steps."""
    from invertible_cd_tpu_torch.diffusion.solver import make_solver_grid

    return make_solver_grid(n_steps=n_steps, reverse_timesteps=[259, 519, 779, 999],
                            forward_timesteps=[19, 259, 519, 779])


def forced_ddim_errors(cpu_pipe, gpu_pipe, run, controller=None):
    """`run()` on the CPU pipe (fp32), a DDIM path, with every UNet call
    repeated by the card pipe on the same inputs (teacher forcing); with a
    controller, the card's own runtime gives each call's hook (wrapped for
    the CFG batch's cond half, as the sampler wraps the CPU's) and runs each
    step callback (LocalBlend) on the same pre-blend latent. Returns the
    relative L2, card against CPU, of each call's epsilon (`unet`), of the
    16^2 cross maps each blend accumulated (`maps`, the worst layer) and of
    each blended latent (`blend`), and run()'s result."""
    from invertible_cd_tpu_torch.edit import ControllerRuntime
    from invertible_cd_tpu_torch.pipelines import sampler
    from invertible_cd_tpu_torch.pipelines.pipeline import InvertibleCD

    dev = gpu_pipe.device
    card_rt = ControllerRuntime(controller[0], controller[1].to(dev)) if controller else None
    step, errs = [0], {"unet": [], "maps": [], "blend": []}

    def rel(got, want):
        return ((got.float().cpu() - want).norm() / want.norm()).item()

    def forced(unet, added=None):  # stands in for the CPU pipe's `_noise_model`
        name = next(k for k, u in cpu_pipe.unets.items() if u is unet)
        cpu_nm = InvertibleCD._noise_model(cpu_pipe, unet)
        card_nm = InvertibleCD._noise_model(gpu_pipe, gpu_pipe.unets[name])

        def nm(latent, t, context, w_emb, hook=None):
            eps = cpu_nm(latent, t, context, w_emb, hook)
            card_hook = None
            if hook is not None:  # one hook a step, in step order
                card_hook = sampler._wrap_cond_half(card_rt.hook_factory(step[0]))
                step[0] += 1
            got = card_nm(latent.to(dev), t, context.to(dev), None, card_hook)
            errs["unet"].append(rel(got, eps))
            return eps
        return nm

    ddim_loop = sampler.ddim_loop

    def forced_loop(*args, step_callback=None, **kwargs):
        def blend(latent, i):
            want = step_callback(latent, i)
            errs["blend"].append(rel(card_rt.step_callback(latent.to(dev), i), want))
            cpu_maps = step_callback.__self__._accum_maps  # the CPU's runtime
            errs["maps"].append(max(rel(g, w) for g, w in zip(card_rt._accum_maps, cpu_maps)))
            return want
        return ddim_loop(*args, step_callback=blend if step_callback else None, **kwargs)

    cpu_pipe._noise_model = forced
    sampler.ddim_loop = forced_loop
    try:
        result = run()
    finally:
        del cpu_pipe._noise_model
        sampler.ddim_loop = ddim_loop
    return errs, result


def forced_nti_errors(cpu_pipe, gpu_pipe, image):
    """NTI on both pipes, teacher-forced per outer step: the CPU pipe's DDIM
    inversion of `image` on its grid, then each outer step run by both
    pipes on the CPU's inputs (embedding, current and target latent), with
    the threshold at -inf so that every inner iteration runs on both; the CPU
    step's outputs go on. Returns the relative L2, card against CPU, of each
    step's optimised embedding, of the embedding's change and of the next
    latent."""
    import math

    import torch

    from invertible_cd_tpu_torch.pipelines import nti

    dev = gpu_pipe.device
    n = cpu_pipe.grid.n_steps
    traj, _ = cpu_pipe.ddim_invert(image, EDIT_SOURCE)
    x = traj.permute(0, 1, 4, 2, 3)
    ctx_u, ctx_c = (c.clone() for c in cpu_pipe.encode_prompt([EDIT_SOURCE]))
    steps = [nti.make_nti_step(p, TINY_NTI_INNER, DDIM_CFG) for p in (cpu_pipe, gpu_pipe)]
    errs = {"gradient": [], "embedding": [], "change": [], "latent": []}

    def rel(got, want):
        return ((got.float().cpu() - want).norm() / want.norm()).item()

    def first_gradient(pipe, u, cur, prev, ctx, t):
        nm = pipe._noise_model(pipe.unets["teacher"])
        with torch.no_grad():
            cond_noise = nm(cur, t, ctx, None)
        u = u.to(torch.float32, copy=True).requires_grad_(True)
        loss = nti.nti_loss(nm, u, cond_noise, cur, prev, t, pipe.schedule,
                            pipe.schedule.num_train_timesteps // n, DDIM_CFG)
        return torch.autograd.grad(loss, u)[0]
    u, cur = ctx_u, x[-1]
    for i, t in enumerate(cpu_pipe.grid.ddim_timesteps[::-1].tolist()):
        inputs = (u, cur, x[n - i - 1], ctx_c)
        errs["gradient"].append(rel(first_gradient(gpu_pipe, *(a.to(dev) for a in inputs), t),
                                    first_gradient(cpu_pipe, *inputs, t)))
        u_c, next_c, _, k_c = steps[0](*inputs, t, 1e-2 * (1 - i / 100), -math.inf)
        u_g, next_g, _, k_g = steps[1](*(a.to(dev) for a in inputs), t, 1e-2 * (1 - i / 100), -math.inf)
        check(k_c == k_g == TINY_NTI_INNER, f"tiny NTI step {i}: {k_c} and {k_g} inner iterations")
        errs["embedding"].append(rel(u_g, u_c))
        errs["change"].append(rel(u_g.cpu() - u, u_c - u))
        errs["latent"].append(rel(next_g, next_c))
        u, cur = u_c, next_c
    return errs


def phase_baselines(card: str, pipe):
    """The DDIM baselines on the generate path's bundle (its seeded teacher):
    `ddim_invert` of a seeded 512^2 image, `ddim_generate` from its
    inversion, the controlled pair, NPI's reconstruction and NTI with its
    reconstruction, each with the launch counters reset just before and
    read just after; checks, NTI's gradient through the kernels against the
    materialised path, the tiny bundle on the card against the CPU, times
    and one traced `ddim_generate`. Returns the launches per (kernel, Sq,
    Sk, d) by the batch each kernel ran at."""
    import math

    import numpy as np
    import torch

    from invertible_cd_tpu_torch.edit import make_controller
    from invertible_cd_tpu_torch.models.attention import AttnMeta
    from invertible_cd_tpu_torch.models.unet2d import count_attention_layers
    from invertible_cd_tpu_torch.ops import flash_attention as fa
    from invertible_cd_tpu_torch.pipelines import nti
    from invertible_cd_tpu_torch.pipelines.pipeline import InvertibleCD
    from invertible_cd_tpu_torch.testing import tiny_configs
    from invertible_cd_tpu_torch.utils.tokenizer import HashTokenizer

    teacher = pipe.unets["teacher"]
    cfg, n, side = teacher.cfg, pipe.grid.n_steps, pipe.latent_size[0]
    pair = [EDIT_SOURCE, EDIT_TARGET]
    image = np.random.default_rng(41).integers(0, 256, (8 * side, 8 * side, 3), dtype=np.uint8)
    controller = make_controller(pair, pipe.tokenizer, n, **EDIT_CONTROLLER)

    # launches per run, derived from the config, the grid and the spec
    per_call = unet_launches_per_call(cfg, side)
    check(sum(per_call.values()) == count_attention_layers(cfg) == 32,
          f"{sum(per_call.values())} attention layers a call")
    # under NTI's gradient every layer after the first cross layer runs backward
    grad_layers = per_call - collections.Counter({first_self_layer(cfg, side): 1})

    def nti_launches(forwards: int, backwards: int):
        return nti_path_launches(per_call, grad_layers, forwards, backwards)
    vae = collections.Counter({("flash_fwd_streamed", side * side, side * side,
                                pipe.vae.cfg.block_out_channels[-1]): 1})
    cfg_steps = collections.Counter({k: n * c for k, c in per_call.items()})
    plain_run = {2: cfg_steps, 1: vae}  # CFG batch 2; the VAE at batch 1
    pair_b1 = edit_path_launches(controller[0], n, per_call, next(iter(vae)))[1] - vae
    want = {"ddim_invert": plain_run, "ddim_generate": plain_run, "pair": {4: pair_b1, 2: vae},
            "npi": plain_run, "nti_recon": plain_run}
    print(f"baselines: {n} DDIM steps of the teacher, CFG {DDIM_CFG} (invert 1.0); "
          f"{sum(grad_layers.values())} of {sum(per_call.values())} layers under NTI's gradient")

    ctx_u, ctx_c = (c.clone() for c in pipe.encode_prompt([EDIT_SOURCE]))
    nm = pipe._noise_model(teacher)
    step_ratio = pipe.schedule.num_train_timesteps // n
    # warm-up: plans and handles at batch 1, 2 and 4, and the backward's at batch 1
    warm, _ = pipe.ddim_invert(image, EDIT_SOURCE)
    pipe.ddim_generate(pair, latent=warm[-1].expand(2, -1, -1, -1), controller=controller)
    warm = warm.permute(0, 1, 4, 2, 3)
    nti.make_nti_step(pipe, 2, DDIM_CFG)(ctx_u, warm[-1], warm[-2], ctx_c, 999, 1e-2, -math.inf)
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # ---- the baselines: counts reset just before each, read just after ----
    times, launches, out = {}, {}, {}

    def counted(label, fn):
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        out[label] = fn()
        torch.cuda.synchronize()
        times[label] = time.perf_counter() - t0
        launches[label] = collections.Counter(fa.LAUNCH_SHAPES)
    counted("ddim_invert", lambda: pipe.ddim_invert(image, EDIT_SOURCE))
    traj, clean = out["ddim_invert"]
    inv, x = traj[-1], traj.permute(0, 1, 4, 2, 3)  # x: the trajectory NCHW
    counted("ddim_generate", lambda: pipe.ddim_generate([EDIT_SOURCE], latent=inv))
    counted("pair", lambda: pipe.ddim_generate(pair, latent=inv.expand(2, -1, -1, -1),
                                               controller=controller))
    npi = nti.negative_prompt_inversion(pipe, EDIT_SOURCE)
    counted("npi", lambda: pipe.ddim_generate([EDIT_SOURCE], latent=inv, nti_uncond=npi))
    counted("nti", lambda: nti.null_text_inversion(
        pipe, None, EDIT_SOURCE, num_inner_steps=NTI_INNER_STEPS, epsilon=NTI_EPSILON,
        guidance_scale=DDIM_CFG, trajectory=traj, return_inner_steps=True))
    per_step, nti_latent, inner = out["nti"]
    counted("nti_recon", lambda: pipe.ddim_generate([EDIT_SOURCE], latent=nti_latent,
                                                    nti_uncond=per_step))
    # --------------------------------------------------------------------
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    # NTI: (2 + k) UNet calls an outer step of k inner iterations, k of them
    # differentiated (B1 writing lse on the layers that need it, then B3, B4)
    check(len(inner) == n and all(1 <= k <= NTI_INNER_STEPS for k in inner),
          f"NTI inner iterations {inner}")
    total_inner = sum(inner)
    want["nti"] = {1: nti_launches(2 * n + total_inner, total_inner)}
    for label, by_batch in want.items():
        expected = sum(by_batch.values(), collections.Counter())
        totals = {name: sum(c for k, c in launches[label].items() if k[0] == name)
                  for name in fa.KERNELS if any(k[0] == name for k in launches[label])}
        print(f"  {label}: launches {totals}")
        check(launches[label] == expected,
              f"{label} launches {dict(launches[label])} != {dict(expected)}")
    print(f"  launches derived from UNetConfig.sd15(), the {n}-step grid, the controller spec and "
          f"NTI's inner iterations ({total_inner} in all, {min(inner)}-{max(inner)} a step; one "
          f"host sync each) and launched: exact")

    check(tuple(traj.shape) == (n + 1, 1, side, side, 4) and torch.equal(traj[0], clean),
          f"DDIM trajectory {tuple(traj.shape)}, row 0 the clean latent")
    for label, b in (("ddim_generate", 1), ("pair", 2), ("npi", 1), ("nti_recon", 1)):
        images, lat = out[label]
        check(tuple(images.shape) == (b, 8 * side, 8 * side, 3) and tuple(lat.shape) == (b, side, side, 4),
              f"{label}: images {tuple(images.shape)}, latents {tuple(lat.shape)}")
        check(bool(torch.isfinite(images).all()) and bool(torch.isfinite(lat).all()),
              f"{label}: not finite")
        check(0.0 <= images.min().item() and images.max().item() <= 1.0, f"{label}: images outside [0, 1]")
    check(tuple(per_step.shape) == (n, 1, 77, cfg.cross_attention_dim)
          and bool(torch.isfinite(per_step).all()), f"NTI embeddings {tuple(per_step.shape)}")
    check(torch.equal(pipe.ddim_generate([EDIT_SOURCE], latent=inv)[0], out["ddim_generate"][0]),
          "the same latent gave a different DDIM generate")
    recon = {label: ((out[label][1] - clean).norm() / clean.norm()).item()
             for label in ("ddim_generate", "npi", "nti_recon")}
    print(f"  same latent -> identical DDIM generate: ok; reconstruction of the clean latent, "
          f"relative L2 (not gated): DDIM at CFG {DDIM_CFG} {recon['ddim_generate']:.3e}, NPI "
          f"{recon['npi']:.3e}, NTI {recon['nti_recon']:.3e}")

    # NTI's gradient through the kernels (B1 with lse, B3, B4) against the
    # same gradient through materialised attention, at the first outer step
    def identity_hook(probs, meta: AttnMeta):
        return probs

    def nti_step_at(i):
        """Outer step i's timestep and cond prediction, on the inversion's
        latents."""
        t = int(pipe.grid.ddim_timesteps[::-1][i])
        with torch.no_grad():
            return t, nm(x[n - i], t, ctx_c, None)

    def nti_grad(i, t, cond_noise, hook=None):
        u = ctx_u.to(torch.float32, copy=True).requires_grad_(True)
        loss = nti.nti_loss(nm, u, cond_noise, x[n - i], x[n - i - 1], t, pipe.schedule, step_ratio,
                            DDIM_CFG, hook=hook)
        return torch.autograd.grad(loss, u)[0]

    def rel_l2(a, b):
        return ((a - b).norm() / b.norm()).item()
    first, mid = nti_step_at(0), nti_step_at(n // 2)
    fa.reset_launch_counts()
    grad_k = nti_grad(0, *first)
    torch.cuda.synchronize()
    grad_launches = collections.Counter(fa.LAUNCH_SHAPES)
    grad_p = nti_grad(0, *first, hook=identity_hook)
    torch.cuda.synchronize()
    check(grad_launches == nti_launches(1, 1), f"NTI gradient launches {dict(grad_launches)}")
    check(collections.Counter(fa.LAUNCH_SHAPES) == grad_launches,
          "the materialised path launched a kernel")
    rel = rel_l2(grad_k, grad_p)
    rel_mid = rel_l2(nti_grad(n // 2, *mid), nti_grad(n // 2, *mid, hook=identity_hook))
    print(f"  NTI gradient d loss / d uncond ({grad_k.numel()} entries) at t=999, kernel path "
          f"(B1 + lse, B3, B4) vs materialised path: relative L2 {rel:.3e} (tol {UNET_REL_TOL}); "
          f"|grad| {grad_p.norm().item():.3e}; at t={mid[0]} (not gated) {rel_mid:.3e}")
    check(math.isfinite(rel) and rel <= UNET_REL_TOL and grad_p.norm().item() > 0,
          f"NTI gradient off by {rel}")

    # times: one teacher call at the CFG batch, one NTI inner iteration
    x2 = x[-1].expand(2, -1, -1, -1)
    ctx2 = torch.cat([ctx_u, ctx_c])
    with torch.inference_mode():
        unet_ms = cuda_ms(lambda: teacher(x2, 999, ctx2), per_loop=1)
    iteration_ms = cuda_ms(lambda: nti_grad(0, *first), per_loop=1, loops=3, warmup=1)

    # a tiny bundle on the card (bf16, kernels) against the same weights in
    # fp32 on the CPU: every UNet call of ddim_invert, ddim_generate and the
    # controlled pair teacher-forced, the pair's LocalBlend steps too; NTI
    # teacher-forced per outer step (`forced_nti_errors`)
    unet_cfg, clip_cfg, vae_cfg = tiny_configs()
    cfgs = dict(unet_cfg=unet_cfg, clip_cfg=clip_cfg, vae_cfg=vae_cfg, latent_size=(16, 16),
                grid=ddim_grid(TINY_GRID))
    cpu_pipe = InvertibleCD.sd15(device="cpu", dtype=torch.float32, seed=7, lora_rank=64,
                                 tokenizer=HashTokenizer(clip_cfg.vocab_size), **cfgs)
    params = {name: m.state_dict() for name, m in (
        ("teacher", cpu_pipe.unets["teacher"]), ("text", cpu_pipe.text_encoder), ("vae", cpu_pipe.vae))}
    gpu_pipe = InvertibleCD.sd15(params=params, device="cuda", dtype=torch.bfloat16,
                                 tokenizer=cpu_pipe.tokenizer, **cfgs)
    tiny_image = np.random.default_rng(43).integers(0, 256, (32, 32, 3), dtype=np.uint8)
    tiny_controller = make_controller(pair, cpu_pipe.tokenizer, TINY_GRID, **EDIT_CONTROLLER)
    errs = {}
    errs["ddim_invert"], (tiny_traj, _) = forced_ddim_errors(
        cpu_pipe, gpu_pipe, lambda: cpu_pipe.ddim_invert(tiny_image, EDIT_SOURCE))
    tiny_inv = tiny_traj[-1]
    errs["ddim_generate"], _ = forced_ddim_errors(
        cpu_pipe, gpu_pipe, lambda: cpu_pipe.ddim_generate([EDIT_SOURCE], latent=tiny_inv))
    errs["pair"], _ = forced_ddim_errors(
        cpu_pipe, gpu_pipe, lambda: cpu_pipe.ddim_generate(
            pair, latent=tiny_inv.expand(2, -1, -1, -1), controller=tiny_controller), tiny_controller)
    nti_errs = forced_nti_errors(cpu_pipe, gpu_pipe, tiny_image)  # on their TINY_GRID steps
    got = gpu_pipe.ddim_generate(pair, latent=tiny_inv.expand(2, -1, -1, -1), controller=tiny_controller)
    check(all(bool(torch.isfinite(t).all()) for t in got), "tiny DDIM pair on the card not finite")

    def worst(values):
        return f"{max(values):.1e} (of {len(values)})"
    print(f"  tiny bundle, card bf16 vs CPU fp32, teacher-forced, relative L2 (tol {UNET_REL_TOL}): "
          f"UNet calls' epsilon: ddim_invert {worst(errs['ddim_invert']['unet'])}, ddim_generate "
          f"{worst(errs['ddim_generate']['unet'])}, pair {worst(errs['pair']['unet'])}; the pair's "
          f"LocalBlend maps {worst(errs['pair']['maps'])}; NTI ({TINY_GRID} steps, "
          f"{TINY_NTI_INNER} inner iterations each) first gradients {worst(nti_errs['gradient'])}, "
          f"embeddings {worst(nti_errs['embedding'])}; not gated: blended latents "
          f"{worst(errs['pair']['blend'])} ({sum(e > UNET_REL_TOL for e in errs['pair']['blend'])} "
          f"steps above tol), NTI's next latents {worst(nti_errs['latent'])} (CFG {DDIM_CFG} "
          f"scales the two predictions' rounding), the embeddings' change "
          f"{worst(nti_errs['change'])} (Adam's first update is the gradient's sign)")
    for label in ("ddim_invert", "ddim_generate", "pair"):
        check(len(errs[label]["unet"]) == TINY_GRID and max(errs[label]["unet"]) <= UNET_REL_TOL,
              f"tiny {label} UNet calls off: {errs[label]['unet']}")
    check(len(errs["pair"]["maps"]) == TINY_GRID and max(errs["pair"]["maps"]) <= UNET_REL_TOL,
          f"tiny pair LocalBlend maps off: {errs['pair']['maps']}")
    check(len(nti_errs["embedding"]) == TINY_GRID
          and max(nti_errs["gradient"] + nti_errs["embedding"]) <= UNET_REL_TOL,
          f"tiny NTI off: {nti_errs}")

    print(f"  ddim_invert (batch 1, {n} steps, CFG batch 2): {times['ddim_invert'] * 1e3:.1f} ms; "
          f"ddim_generate: {times['ddim_generate'] * 1e3:.1f} ms; controlled pair (CFG batch 4): "
          f"{times['pair'] * 1e3:.1f} ms; NPI reconstruction {times['npi'] * 1e3:.1f} ms; NTI "
          f"({NTI_INNER_STEPS} inner iterations at most): {times['nti'] * 1e3:.1f} ms "
          f"({times['nti'] * 1e3 / total_inner:.1f} ms an inner iteration on average, everything "
          f"included), its reconstruction {times['nti_recon'] * 1e3:.1f} ms; peak memory "
          f"{peak_gb:.2f} GiB ({card})")
    print(f"  teacher UNet call at batch 2: {unet_ms:.2f} ms; one NTI inner iteration (batch-1 "
          f"forward + backward to the embedding): {iteration_ms:.2f} ms ({card})")
    trace_run(f"ddim_generate, {n} steps", lambda: pipe.ddim_generate([EDIT_SOURCE], latent=inv))
    by_batch = collections.defaultdict(collections.Counter)
    for runs in want.values():
        for b, counter in runs.items():
            by_batch[b] += counter
    return by_batch


def nti_path_launches(per_call, grad_layers, forwards: int, backwards: int):
    """B1 on every layer of `forwards` UNet calls (`per_call`, see
    `unet_launches_per_call`); B3 and B4 on the gradient's layers
    (`grad_layers`) of `backwards` of them."""
    return (collections.Counter({k: forwards * c for k, c in per_call.items()})
            + collections.Counter({(kernel,) + key[1:]: backwards * c
                                   for key, c in grad_layers.items()
                                   for kernel in ("flash_bwd_dq", "flash_bwd_dkdv")}))


def unet_launches_per_call(cfg, latent: int):
    """Kernel launches per (kernel, Sq, Sk, d) of one UNet call at a latent
    side of `latent`, derived from the config: at each level with
    cross-attention, (layers_per_block down + layers_per_block + 1 up)
    transformers of depth transformer_depth[level], and the mid block's
    transformer of depth transformer_depth[-1] at the last level; each block
    one self layer (Sk = Sq) and one cross layer (Sk = 77) at (latent /
    2^level)^2 tokens, head dim channels / heads."""
    per_call = collections.Counter()
    last = len(cfg.block_out_channels) - 1
    for level, channels in enumerate(cfg.block_out_channels):
        blocks = (2 * cfg.layers_per_block + 1) * cfg.transformer_depth[level] \
            if cfg.cross_attn_blocks[level] else 0
        if level == last:
            blocks += cfg.transformer_depth[-1]
        tokens = (latent // 2 ** level) ** 2
        for sk in (tokens, 77):
            if blocks:
                per_call[("flash_fwd", tokens, sk, channels // cfg.num_heads[level])] += blocks
    return per_call


def first_self_layer(cfg, latent: int):
    """The (kernel, Sq, Sk, d) of the UNet's first attention layer: the self
    layer of the first transformer block at the first level with
    cross-attention, which runs before any cross layer."""
    level = list(cfg.cross_attn_blocks).index(True)
    tokens = (latent // 2 ** level) ** 2
    return ("flash_fwd", tokens, tokens, cfg.block_out_channels[level] // cfg.num_heads[level])


def forced_unet_errors(cpu_pipe, gpu_pipe, run):
    """`run()` on the CPU pipe (fp32) with every UNet call repeated by the
    card pipe on the same inputs, added conditioning included (teacher
    forcing). Returns the relative L2, card against CPU, of each call's
    epsilon, and run()'s result."""
    from invertible_cd_tpu_torch.pipelines.pipeline import InvertibleCD

    dev, errs = gpu_pipe.device, []

    def forced(unet, added=None):  # stands in for the CPU pipe's `_noise_model`
        name = next(k for k, u in cpu_pipe.unets.items() if u is unet)
        cpu_nm = InvertibleCD._noise_model(cpu_pipe, unet, added)
        card_nm = InvertibleCD._noise_model(gpu_pipe, gpu_pipe.unets[name], None if added is None else {
            k: v.to(dev) for k, v in added.items()})

        def nm(latent, t, context, w_emb, hook=None):
            eps = cpu_nm(latent, t, context, w_emb, hook)
            got = card_nm(latent.to(dev), t, context.to(dev),
                          None if w_emb is None else w_emb.to(dev)).float().cpu()
            errs.append(((got - eps).norm() / eps.norm()).item())
            return eps
        return nm

    cpu_pipe._noise_model = forced
    try:
        result = run()
    finally:
        del cpu_pipe._noise_model
    return errs, result


# ---------------------------------------------------------------------------
# int8 W8A8 inference (kernel Q1)
# ---------------------------------------------------------------------------
PEAK_INT8_OPS = 1979e12  # dense int8 tensor-core operations a second, at 700 W
QUANT_MODES = ("off", "int8", "int8_vae", "int8_static")
Q1_SOURCE = "invertible_cd_tpu_torch/ops/csrc/int8_gemm.cu"
# Q1 replaces no TPU kernel: the JAX package's int8 products are XLA's
Q1_REPLACES = {"dense": "invertible_cd_tpu/ops/quant.py:245", "conv": "invertible_cd_tpu/ops/quant.py:327"}
INT8_SERVE_DELAY = 0.05  # the burst of 3 must coalesce into one padded batch of 4
INT8_BURST = [("a photo of a corgi on the beach", 21), ("a red fox in the snow", 22),
              ("a lighthouse at dawn, watercolor", 23)]
Q1_TOP = 5  # rows for the costliest shapes of the batch-4 int8 generate
Q2_SOURCE = "invertible_cd_tpu_torch/ops/csrc/int8_quantize.cu"
# Q2 replaces no TPU kernel: the JAX package's quantiser is XLA's (`quantize_int8`)
Q2_REPLACES = "invertible_cd_tpu/ops/quant.py:176"
Q2_TOP = 3  # rows for Q2's costliest shapes of the batch-4 int8 generate
# Q1's launch keys timed by --kernels-only, for a comparison of two checkouts
# in one call: the int8 paths' costliest shapes (the SD1.5 VAE decode and
# dense layer at batch 4, the SDXL fp32 VAE decode at batch 1) and the
# UNet's 64^2 and 8^2 convolutions at batch 4
Q1_COMPARE = [("int8_gemm", 4, 128, 128, 512, 512, 3, 3, 1, 1, "bfloat16"),
              ("int8_gemm", 4, 256, 256, 256, 256, 3, 3, 1, 1, "bfloat16"),
              ("int8_gemm", 4, 512, 512, 128, 128, 3, 3, 1, 1, "bfloat16"),
              ("int8_gemm", 4, 256, 256, 512, 512, 3, 3, 1, 1, "bfloat16"),
              ("int8_gemm", 4, 512, 512, 256, 256, 3, 3, 1, 1, "bfloat16"),
              ("int8_gemm", 16384, 1, 1, 320, 2560, 1, 1, 1, 0, "bfloat16"),
              ("int8_gemm", 1, 256, 256, 512, 512, 3, 3, 1, 1, "float32"),
              ("int8_gemm", 4, 64, 64, 320, 320, 3, 3, 1, 1, "bfloat16"),
              ("int8_gemm", 4, 8, 8, 1280, 1280, 3, 3, 1, 1, "bfloat16")]


def q1_unet_launches(cfg, with_w: bool = True) -> int:
    """Q1 launches of one UNet call, derived from the config: conv_in and
    conv_out; the time embedding's two dense layers (+ cond_proj with a
    w-embedding) and SDXL's add_embedding's two; each ResNet block's conv1,
    time_emb_proj and conv2 (+ a 1x1 shortcut where its channels change);
    each transformer's proj_in and proj_out and, per block, q, k, v, out of
    both attentions and the GEGLU and output projections (10); each down-
    and upsampler's conv."""
    n = 2 + 2 + int(bool(cfg.time_cond_proj_dim) and with_w)
    n += 2 if cfg.addition_embed_dim is not None else 0

    def resnet(cin, cout):
        return 3 + int(cin != cout)

    def transformer(depth):
        return 2 + 10 * depth
    levels = len(cfg.block_out_channels)
    ch = cfg.block_out_channels[0]
    skips = [ch]
    for level, out in enumerate(cfg.block_out_channels):
        for _ in range(cfg.layers_per_block):
            n += resnet(ch, out) + (transformer(cfg.transformer_depth[level])
                                    if cfg.cross_attn_blocks[level] else 0)
            ch = out
            skips.append(ch)
        if level < levels - 1:
            n += 1
            skips.append(ch)
    n += 2 * resnet(ch, ch) + transformer(cfg.transformer_depth[-1])
    for i, level in enumerate(reversed(range(levels))):
        out = cfg.block_out_channels[level]
        for _ in range(cfg.layers_per_block + 1):
            n += resnet(ch + skips.pop(), out) + (transformer(cfg.transformer_depth[level])
                                                  if cfg.cross_attn_blocks[level] else 0)
            ch = out
        n += int(i < levels - 1)
    return n


def q1_vae_launches(cfg, decode: bool) -> int:
    """Q1 launches of one VAE decode (post_quant_conv, the decoder) or
    encode (the encoder, quant_conv), derived from the config: each ResNet
    block's two convs (+ a 1x1 shortcut where its channels change), the mid
    block's two ResNet blocks and its attention's four projections, each
    down- or upsampler's conv, conv_in, conv_out and the 1x1 conv."""
    chs = tuple(reversed(cfg.block_out_channels)) if decode else tuple(cfg.block_out_channels)
    per_level = cfg.layers_per_block + (1 if decode else 0)
    n = 1 + 1 + 1 + (2 * 2 + 4)  # conv_in, conv_out, the 1x1 conv, the mid block
    for i, ch in enumerate(chs):
        n += sum(2 + int((chs[max(i - 1, 0)] if j == 0 else ch) != ch) for j in range(per_level))
        n += int(i < len(chs) - 1)
    return n


def q1_inputs(key, gen):
    """Seeded int8 codes and fp32 scales for a Q1 launch key (`quant.launch_key`)
    on the generator's device: (a, b, s_row, s_col, stride, padding, out
    dtype, dense)."""
    import torch

    _, bsz, h, w, c, n, kh, kw, stride, pad, dtype = key
    dev = gen.device
    a = torch.randint(-127, 128, (bsz, h, w, c), generator=gen, device=dev, dtype=torch.int8)
    b = torch.randint(-127, 128, (n, kh, kw, c), generator=gen, device=dev, dtype=torch.int8)
    dense = h == w == kh == kw == 1
    ho, wo = (h + 2 * pad - kh) // stride + 1, (w + 2 * pad - kw) // stride + 1
    s_row = 0.05 * (torch.rand(bsz * ho * wo if dense else 1, generator=gen, device=dev) + 0.01)
    s_col = 0.01 * (torch.rand(n, generator=gen, device=dev) + 0.01)
    return a, b, s_row, s_col, (stride, stride), (pad, pad), getattr(torch, dtype), dense


def q1_check_shapes(keys, label: str, device="cuda") -> dict:
    """Q1 against its plain version at every launch key in `keys`, on seeded
    codes: the int32 accumulators must be equal, the outputs bit for bit
    with and without a fused bias (the eager `dequantize` and bias add)."""
    import torch

    from invertible_cd_tpu_torch.ops import quant

    gen = torch.Generator(device=device).manual_seed(4321)
    failures = []
    for key in sorted(keys):
        a, b, s_row, s_col, stride, pad, dtype, _ = q1_inputs(key, gen)
        bias = torch.randn(b.shape[0], generator=gen, device=device).to(dtype)
        acc = quant.int8_gemm_acc(a, b, stride, pad)
        out = quant.int8_gemm(a, b, s_row, s_col, stride, pad, dtype)
        out_b = quant.int8_gemm(a, b, s_row, s_col, stride, pad, dtype, bias)
        want = quant.int8_gemm_acc_plain(a, b, stride, pad)
        torch.cuda.synchronize()
        if not torch.equal(acc, want):
            failures.append(f"{key}: accumulators differ at {(acc != want).sum().item()} places")
            continue
        ref = quant.dequantize(want, s_row, s_col, dtype)
        if not torch.equal(out, ref):
            failures.append(f"{key}: output differs at {(out != ref).sum().item()} places")
        if not torch.equal(out_b, ref + bias):
            failures.append(f"{key}: biased output differs at {(out_b != ref + bias).sum().item()} places")
        del a, b, acc, out, out_b, want, ref
    check(not failures, f"Q1 vs plain ({label}): " + "; ".join(failures))
    print(f"  Q1 vs plain at {len(keys)} launch shapes of {label}: int32 accumulators equal; outputs "
          f"bit for bit, with and without the fused bias")
    return {"shapes": len(keys), "bit_for_bit": True}


def q2_inputs(key, gen):
    """Seeded activations for a Q2 launch key (`quant.quantize_key`) on the
    generator's device, N(0, 1) with a few entries at 11 sigma: (x,
    per_row, amax); a static key gets an amax below max |x|, so codes clip."""
    import torch

    form, shape, dtype = key[1], key[2:-1], getattr(torch, key[-1])
    x = torch.randn(shape, generator=gen, device=gen.device)
    x.view(-1)[::997] *= 11.0
    amax = (0.75 * x.abs().amax()).reshape(1) if form == "static" else None
    return x.to(dtype), form == "rows", amax


def q2_check_shapes(keys, label: str, device="cuda") -> dict:
    """Q2 against its plain version at every launch key in `keys` on seeded
    activations (a convolution's NCHW and channels-last): codes and scales
    bit for bit."""
    import torch

    from invertible_cd_tpu_torch.ops import quant

    gen = torch.Generator(device=device).manual_seed(8765)
    failures, checked = [], 0
    for key in sorted(keys):
        x, per_row, amax = q2_inputs(key, gen)
        for xx in ([x] if per_row else [x, x.contiguous(memory_format=torch.channels_last)]):
            q, s = quant.quantize_activation(xx, per_row, amax)
            qp, sp = quant.quantize_activation_plain(xx, per_row, amax)
            torch.cuda.synchronize()
            checked += 1
            if not (torch.equal(q, qp) and torch.equal(s, sp)):
                failures.append(f"{key}: codes differ at {(q != qp).sum().item()}, scales at "
                                f"{(s != sp).sum().item()}")
        del x
    check(not failures, f"Q2 vs plain ({label}): " + "; ".join(failures))
    print(f"  Q2 vs plain at {len(keys)} launch shapes of {label} ({checked} layouts): codes and "
          f"scales bit for bit")
    return {"shapes": len(keys), "layouts": checked, "bit_for_bit": True}


def q2_row(key, launches: int, device="cuda") -> dict:
    """A kernels-line row for Q2 at launch key `key`: the kernel against its
    plain version (the eager quantiser) on seeded activations, per-launch
    times, the byte bound; no single PyTorch call computes the pass."""
    import torch

    from invertible_cd_tpu_torch.ops import quant

    gen = torch.Generator(device=device).manual_seed(98)
    x, per_row, amax = q2_inputs(key, gen)
    q, s = quant.quantize_activation(x, per_row, amax)
    qp, sp = quant.quantize_activation_plain(x, per_row, amax)
    err = max((q.int() - qp.int()).abs().max().item(), (s - sp).abs().max().item())
    ms = graph_ms(lambda: quant.quantize_activation(x, per_row, amax))
    plain_ms = cuda_ms(lambda: quant.quantize_activation_plain(x, per_row, amax), per_loop=5, loops=3,
                       warmup=1)
    nbytes = x.numel() * x.element_size() + q.numel() + 4.0 * s.numel()
    bound = nbytes / PEAK_BYTES * 1e3
    name = f"int8_quantize[{key[1]},{'x'.join(map(str, key[2:-1]))},{key[-1]}]"
    row = {
        "name": name, "kernel": "int8_quantize", "batch": key[2], "shape": list(key[1:]), "route": "cuda",
        "source": Q2_SOURCE, "replaces": Q2_REPLACES, "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes", "bound_limit": "bytes",
        "library_ms": None, "library": None,
    }
    print(f"  {name:<58} err {err:.1e} kernel {ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s)  plain "
          f"{plain_ms:.3f} ms  bound {bound:.4f} ms (bytes)  launches {launches}")
    return row


def q2_costliest(counter, top: int):
    """The `top` Q2 launch keys of `counter` with the most bytes times
    launches, plus the costliest dense (rows) key if none of those is."""
    def cost(key):
        return math.prod(key[2:-1]) * counter[key]
    keys = sorted(counter, key=cost, reverse=True)
    chosen = keys[:top]
    rows = [k for k in keys if k[1] == "rows"]
    if rows and not any(k in chosen for k in rows):
        chosen.append(rows[0])
    return chosen


def q1_row(key, launches: int, device="cuda") -> dict:
    """A kernels-line row for Q1 at launch key `key`: the kernel against its
    plain version on seeded codes, per-launch times (the kernel in a CUDA
    graph, the plain float64 version in loops), the bound, and the library
    yardstick: `torch._int_mm` plus its dequantising pass for a dense shape
    (rows padded to 17: it takes more than 16), cuDNN's bf16 convolution for
    a conv shape (the port calls neither)."""
    import torch
    import torch.nn.functional as F

    from invertible_cd_tpu_torch.ops import quant

    gen = torch.Generator(device=device).manual_seed(99)
    a, b, s_row, s_col, stride, pad, dtype, dense = q1_inputs(key, gen)
    _, bsz, h, w, c, n, kh, kw, _, _, _ = key
    out = quant.int8_gemm(a, b, s_row, s_col, stride, pad, dtype)
    ref = quant.int8_gemm_plain(a, b, s_row, s_col, stride, pad, dtype)
    err = (out.float() - ref.float()).abs().max().item()
    ms = graph_ms(lambda: quant.int8_gemm(a, b, s_row, s_col, stride, pad, dtype))
    plain_ms = cuda_ms(lambda: quant.int8_gemm_plain(a, b, s_row, s_col, stride, pad, dtype),
                       per_loop=3, loops=3, warmup=1)
    m = out.shape[0] * out.shape[1] * out.shape[2]
    k = kh * kw * c
    if dense:
        a2, b2 = a.reshape(m, k), b.reshape(n, k)
        if m <= 16:
            a2 = F.pad(a2, (0, 0, 0, 17 - m))
        sr = s_row if m > 16 else F.pad(s_row, (0, 17 - m))

        def library():
            acc = torch._int_mm(a2, b2.t())
            return (acc.float() * (sr[:, None] * s_col)).to(dtype)
    else:
        x = torch.randn((bsz, c, h, w), generator=gen, device=device).to(torch.bfloat16)
        x = x.contiguous(memory_format=torch.channels_last)
        wt = torch.randn((n, c, kh, kw), generator=gen, device=device).to(torch.bfloat16)
        wt = wt.contiguous(memory_format=torch.channels_last)

        def library():
            return F.conv2d(x, wt, None, stride, pad)
    library_ms = graph_ms(library)
    flops = 2.0 * m * n * k
    nbytes = a.numel() + b.numel() + m * n * out.element_size() + 4.0 * (s_row.numel() + n)
    t_ops, t_bytes = flops / PEAK_INT8_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    kind = "dense" if dense else "conv"
    name = (f"int8_gemm[{kind},b={bsz},{h}x{w}x{c}->{n},k={kh},s={stride[0]},{key[-1]}]")
    row = {
        "name": name, "kernel": "int8_gemm", "batch": bsz, "shape": list(key[1:]), "route": "cuda",
        "source": Q1_SOURCE, "replaces": Q1_REPLACES[kind], "launches": launches,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "bound_limit": "int8 operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
        "library": "torch._int_mm + dequantise" if dense else "cuDNN bf16 conv2d",
    }
    print(f"  {name:<58} err {err:.1e} kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TOP/s)  plain "
          f"{plain_ms:.3f} ms  {row['library']} {library_ms:.4f} ms  bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']})  launches {launches}")
    return row


def q1_costliest(counter, top: int):
    """The `top` launch keys of `counter` with the most operations (2 M N K
    times launches), plus the costliest dense key if none of those is."""
    def ops(key):
        _, bsz, h, w, c, n, kh, kw, s, p, _ = key
        ho, wo = (h + 2 * p - kh) // s + 1, (w + 2 * p - kw) // s + 1
        return 2.0 * bsz * ho * wo * n * kh * kw * c * counter[key]
    keys = sorted(counter, key=ops, reverse=True)
    chosen = keys[:top]
    dense = [k for k in keys if k[2] == k[3] == k[6] == k[7] == 1]
    if dense and not any(k in chosen for k in dense):
        chosen.append(dense[0])
    return chosen


def q1_counts(counter, name="int8_gemm"):
    """Q1's (or `name`'s) launch keys and count in a `LAUNCH_SHAPES` snapshot."""
    return collections.Counter({k: n for k, n in counter.items() if k[0] == name})


def q2_counts(counter):
    return q1_counts(counter, "int8_quantize")


def codes_gib(*modules) -> float:
    """GiB of the weight codes and scales cached on the int8 layers."""
    total = 0
    for mod in modules:
        for m in mod.modules():
            cached = m.__dict__.get("_int8_weight_codes")
            if cached is not None:
                total += sum(t.numel() * t.element_size() for t in cached[2])
    return total / 2**30


def phase_q1_compare():
    """Q1 at `Q1_COMPARE`, timed by the package imported (this checkout, or
    another one under --package-root): one JSON line of the rows."""
    print("Q1 at the int8 paths' costliest shapes (launches: not counted in this mode):")
    rows = [q1_row(key, 0) for key in Q1_COMPARE]
    print(json.dumps({"q1_compare": [{k: r[k] for k in ("name", "ms", "bound_ms", "library_ms")}
                                     for r in rows]}))


# B2's fp32 build at SDXL's VAE mid-block at 1024^2 (batch 1: encode and
# decode; batch 2: the edited pair's decode), timed by --b2f32-compare
B2F32_COMPARE = [(1, 16384, 16384, 1, 512), (2, 16384, 16384, 1, 512)]


def phase_b2f32_compare():
    """B2's fp32 build at `B2F32_COMPARE`, timed by the package imported
    (this checkout, or another one under --package-root), each against the
    plain version on the same seeded inputs; SDPA on the same fp32 inputs as
    the yardstick; then the layer it serves, SDXL's fp32 VAE at 1024^2
    (decode at batch 1 and 2, encode at 1; seeded weights, CUDA events, the
    median of 5). One JSON line of the rows (launches: not counted)."""
    import torch
    import torch.nn.functional as F

    from invertible_cd_tpu_torch.ops import flash_attention as fa

    lib = fa._lib("flash_fwd_streamed_f32")
    if hasattr(lib, "icd_flash_fwd_streamed_f32_clusters"):
        print(f"B2 fp32: {lib.icd_flash_fwd_streamed_f32_clusters()} clusters of 4 resident at once")
    gen = torch.Generator(device="cuda").manual_seed(4321)
    rows = []
    for b, sq, sk, h, d in B2F32_COMPARE:
        q = QK_SCALE * torch.randn((b, sq, h, d), generator=gen, device="cuda")
        k = QK_SCALE * torch.randn((b, sk, h, d), generator=gen, device="cuda")
        v = V_SCALE * torch.randn((b, sk, h, d), generator=gen, device="cuda")
        out = fa.flash_attention_streamed(q, k, v)
        ref = fa.attention_plain(q, k, v)
        err = (out - ref).abs().max().item()
        limit = KERNEL_TOL * min(1.0, ref.abs().max().item())
        check(err <= limit and torch.equal(out, fa.flash_attention_streamed(q, k, v)),
              f"B2 fp32 b={b}: max abs err {err} > {limit}, or a repeat gave other bits")
        del ref
        ms = graph_ms(lambda: fa.flash_attention_streamed(q, k, v))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), per_loop=5, loops=3)
        nbytes = 4.0 * b * h * d * (2 * sq + 2 * sk)
        row = {"name": f"flash_fwd_streamed_f32[b={b},sq={sq},sk={sk},h={h},d={d}]", "ms": ms,
               **bound(4.0 * b * h * sq * sk * d, b * h * sq * sk, nbytes, flop_rate=PEAK_TF32_FLOPS),
               "library_ms": library_ms, "max_abs_err": err}
        rows.append(row)
        print(f"  {row['name']:<52} {ms:.3f} ms  bound {row['bound_ms']:.4f} ms "
              f"({row['bound_ms'] / ms:.3f} of it)  sdpa {library_ms:.3f} ms  err {err:.2e}")
        del q, k, v, out, qt, kt, vt
        torch.cuda.empty_cache()
    # the layer it serves: SDXL's fp32 VAE at 1024^2 (seeded weights), decode
    # at batch 1 and 2 and encode at batch 1, one B2 fp32 launch each
    from invertible_cd_tpu_torch.models.layers import fan_in_init_
    from invertible_cd_tpu_torch.models.vae import AutoencoderKL, VAEConfig

    with torch.device("cuda"):
        vae = AutoencoderKL(VAEConfig.sdxl())
    fan_in_init_(vae, torch.Generator(device="cuda").manual_seed(0))
    with torch.inference_mode():
        for b in (1, 2):
            lat = torch.randn((b, 4, 128, 128), generator=gen, device="cuda")
            rows.append({"name": f"sdxl_fp32_vae_decode[b={b},1024^2]",
                         "ms": cuda_ms(lambda: vae.decode(lat), per_loop=1, loops=5, warmup=1)})
        pixels = torch.rand((1, 3, 1024, 1024), generator=gen, device="cuda") * 2 - 1
        rows.append({"name": "sdxl_fp32_vae_encode[b=1,1024^2]",
                     "ms": cuda_ms(lambda: vae.encode_mean(pixels), per_loop=1, loops=5, warmup=1)})
    for row in rows[-3:]:
        print(f"  {row['name']:<52} {row['ms']:.2f} ms")
    del vae
    torch.cuda.empty_cache()
    print(json.dumps({"b2f32_compare": [
        {k: r[k] for k in ("name", "ms", "bound_ms", "library_ms", "max_abs_err") if k in r}
        for r in rows]}))


def phase_bwd160_compare():
    """B3 and B4 at every shape of `BACKWARD_SHAPES`, timed by the package
    imported (this checkout, or another one under --package-root). At the
    eight d = 160 shapes (the train step's at batch 4, NTI's at 1) each is
    held to the plain backward on the same inputs (2e-2 * max|ref|, a repeat
    bit for bit), with the backward of torch SDPA timed beside it as the
    yardstick; the other shapes' rows carry the kernels' times alone, to show
    that their routes kept them. One JSON line of the rows (launches: not
    counted)."""
    import torch
    import torch.nn.functional as F

    from invertible_cd_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(4321)
    rows = []
    print("B3 and B4 at BACKWARD_SHAPES (d = 160 checked against the plain backward):")
    for batch, sq, sk, h, d in BACKWARD_SHAPES:
        def rnd(s, scale=1.0):
            return (scale * torch.randn((batch, s, h, d), generator=gen, device="cuda")).to(
                torch.bfloat16)
        q, k, v, do = rnd(sq, QK_SCALE), rnd(sk, QK_SCALE), rnd(sk, V_SCALE), rnd(sq)
        o, lse = fa.flash_forward_lse(q, k, v)
        calls = {"flash_bwd_dq": lambda: (fa.flash_backward_dq(q, k, v, o, lse, do),),
                 "flash_bwd_dkdv": lambda: fa.flash_backward_dkdv(q, k, v, o, lse, do)}
        checked = d == 160
        if checked:
            plain = fa.attention_backward_plain(
                q.float(), k.float(), v.float(), o.float(), lse, do.float())
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
            sdpa_out = F.scaled_dot_product_attention(qt, kt, vt)
            dot = do.transpose(1, 2)
            library_ms = cuda_ms(
                lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dot, retain_graph=True))
        for kernel, refs in (("flash_bwd_dq", (0,)), ("flash_bwd_dkdv", (1, 2))):
            row = {"name": f"{kernel}[b={batch},sq={sq},sk={sk},h={h},d={d}]",
                   "ms": graph_ms(calls[kernel]), **backward_bound(kernel, batch, sq, sk, h, d)}
            if checked:
                got = calls[kernel]()
                torch.cuda.synchronize()
                rel = max((x.float() - plain[i]).abs().max().item() / plain[i].abs().max().item()
                          for x, i in zip(got, refs))
                same = all(torch.equal(a, b) for a, b in zip(got, calls[kernel]()))
                check(rel <= GRAD_TOL and same,
                      f"{row['name']}: err / max|ref| {rel} > {GRAD_TOL}, or a repeat gave other bits")
                row.update(rel_err=rel, library_ms=library_ms)
            rows.append(row)
            print(f"  {row['name']:<52} {row['ms']:.4f} ms  bound {row['bound_ms']:.4f} ms"
                  + (f"  sdpa bwd {library_ms:.3f} ms  err/max|ref| {row['rel_err']:.2e}"
                     if checked else ""))
        del q, k, v, do, o, lse, calls
        if checked:
            del plain, qt, kt, vt, sdpa_out, dot
        torch.cuda.empty_cache()
    print(json.dumps({"bwd160_compare": [
        {k: r[k] for k in ("name", "ms", "bound_ms", "library_ms", "rel_err") if k in r}
        for r in rows]}))


def phase_int8(card: str, pipe):
    """int8 W8A8 inference on the generate path's SD1.5 bundle: every mode at
    batch 4 then 1, calibration, invert and edit under int8, exact launches
    of Q1 and Q2, both against their plain versions at every shape those
    runs gave them, the weight codes quantised once, the entry points (the
    generate CLI with int8_static, the edit CLI with int8, the executor on an
    int8 bundle, the quant_quality CLI), times. Returns Q1's and Q2's kernel
    rows."""
    import tempfile

    import numpy as np
    import torch

    from invertible_cd_tpu_torch.cli import edit as edit_cli
    from invertible_cd_tpu_torch.cli import generate as generate_cli
    from invertible_cd_tpu_torch.cli import quant_quality
    from invertible_cd_tpu_torch.edit import make_controller
    from invertible_cd_tpu_torch.models.layers import QConv2d, QLinear
    from invertible_cd_tpu_torch.ops import flash_attention as fa
    from invertible_cd_tpu_torch.ops import quant
    from invertible_cd_tpu_torch.pipelines.sampler import w_embedding_for
    from invertible_cd_tpu_torch.serving import BatchingExecutor

    t_phase = time.perf_counter()
    pipe.quant_stats.clear()
    dev = pipe.device
    cfg, vcfg = pipe.unets["reverse"].cfg, pipe.vae.cfg
    side, n_hops = pipe.latent_size[0], pipe.grid.num_reverse_steps
    pix = side * 2 ** (len(vcfg.block_out_channels) - 1)
    per_unet, per_dec, per_enc = (q1_unet_launches(cfg), q1_vae_launches(vcfg, True),
                                  q1_vae_launches(vcfg, False))
    n_unet = sum(isinstance(m, (QLinear, QConv2d)) for m in pipe.unets["reverse"].modules())
    n_dec = sum(isinstance(m, (QLinear, QConv2d)) for m in (*pipe.vae.decoder.modules(),
                                                            pipe.vae.post_quant_conv))
    n_enc = sum(isinstance(m, (QLinear, QConv2d)) for m in (*pipe.vae.encoder.modules(),
                                                            pipe.vae.quant_conv))
    check((per_unet, per_dec, per_enc) == (n_unet, n_dec, n_enc),
          f"Q1 launches derived from the configs {(per_unet, per_dec, per_enc)} != int8 layers "
          f"{(n_unet, n_dec, n_enc)}")
    b1 = n_hops * sum(unet_launches_per_call(cfg, side).values())
    vae_b2 = vcfg.block_out_channels[-1] > 256  # the VAE's single head: B2 above d = 256, else B1
    want_gen = {"int8_gemm": n_hops * per_unet + per_dec, "int8_quantize": n_hops * per_unet + per_dec,
                "flash_fwd": b1 + (not vae_b2), "flash_fwd_streamed": int(vae_b2)}
    print(f"int8: SD1.5 bundle, {per_unet} Q1 and Q2 launches a UNet call, {per_dec} a VAE decode, "
          f"{per_enc} an encode (derived from the configs, = the int8 layers); a {n_hops}-hop generate "
          f"{want_gen} ({card})")
    report = {"phase": "int8", "card": card}
    gen = torch.Generator(device=dev).manual_seed(150)
    latents = {4: pipe.init_latent(gen, BATCH), 1: torch.randn((1, side, side, 4), generator=gen,
                                                               device=dev)}
    prompts = {4: PROMPTS, 1: PROMPTS[:1]}

    def run(mode, b):
        pipe.quantize = mode
        try:
            fa.reset_launch_counts()
            t0 = time.perf_counter()
            out = pipe.generate(prompts[b], latent=latents[b])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            return out, secs, collections.Counter(fa.LAUNCH_SHAPES)
        finally:
            pipe.quantize = "off"

    for mode in ("int8", "int8_vae"):  # warm-up: plans and handles at both batches
        for b in (4, 1):
            run(mode, b)
    torch.cuda.reset_peak_memory_stats()

    # ---- 1. every mode at batch 4, then 1: counts reset just before each run, read just after ----
    results, gen_s, shapes = {}, {m: {} for m in QUANT_MODES}, collections.Counter()
    q2_shapes = collections.Counter()
    int8_gen, int8_gen_q2 = {}, {}  # the int8 generates' Q1 and Q2 launches by batch
    for b in (4, 1):
        for mode in ("off", "int8", "int8_vae", "int8_static"):  # int8_static: no stats yet
            (images, lat), secs, launched = run(mode, b)
            results[(mode, b)] = (images, lat)
            gen_s[mode][b] = secs
            totals = {name: sum(c for k, c in launched.items() if k[0] == name) for name in want_gen}
            n_q = {"off": 0, "int8_vae": per_dec}.get(mode, want_gen["int8_gemm"])
            want = dict(want_gen, int8_gemm=n_q, int8_quantize=n_q)
            check(totals == want, f"{mode} generate at batch {b}: launches {totals} != {want}")
            check(bool(torch.isfinite(images).all()) and bool(torch.isfinite(lat).all()),
                  f"{mode} generate at batch {b} not finite")
            shapes += q1_counts(launched)
            q2_shapes += q2_counts(launched)
            if mode == "int8":
                int8_gen[b], int8_gen_q2[b] = q1_counts(launched), q2_counts(launched)
        off_img, off_lat = results[("off", b)]
        img8, lat8 = results[("int8", b)]
        d = (img8 - off_img).abs()
        report[f"int8_vs_off_b{b}"] = {"mean_abs": d.mean().item(), "max_abs": d.max().item()}
        check(d.max().item() > 0, f"int8 at batch {b} equals off")
        check(torch.equal(results[("int8_vae", b)][1], off_lat),
              f"int8_vae latents at batch {b} differ from off's")
        check(torch.equal(results[("int8_static", b)][0], img8),
              f"int8_static without stats at batch {b} differs from int8")
        print(f"  batch {b}: int8 vs off images mean |diff| {d.mean().item():.4e}, max "
              f"{d.max().item():.4e}; int8_vae latents = off's bit for bit; int8_static without "
              f"stats = int8 bit for bit; launches as derived")

    # ---- 2. calibration, then int8_static ----
    t0 = time.perf_counter()
    pipe.collect_quant_stats()
    torch.cuda.synchronize()
    report["collect_quant_stats_s"] = time.perf_counter() - t0
    n_stats = {k: len(v) for k, v in pipe.quant_stats.items()}
    n_convs = {name: sum(isinstance(m, QConv2d) for m in mod.modules()) for name, mod in (
        ("reverse", pipe.unets["reverse"]), ("forward", pipe.unets["forward"]), ("vae", pipe.vae))}
    check(n_stats == n_convs, f"calibrated convs {n_stats} != the convs {n_convs}")
    n_convs_dec = sum(isinstance(m, QConv2d) for m in (*pipe.vae.decoder.modules(), pipe.vae.post_quant_conv))
    for b in (4, 1):
        (st_img, _), secs, launched = run("int8_static", b)
        gen_s["int8_static"][b] = secs
        check(bool(torch.isfinite(st_img).all()), f"int8_static at batch {b} not finite")
        n_static = sum(c for k, c in launched.items() if k[:2] == ("int8_quantize", "static"))
        check(sum(c for k, c in launched.items() if k[0] == "int8_gemm") == want_gen["int8_gemm"]
              and sum(q2_counts(launched).values()) == want_gen["int8_quantize"]
              and n_static == n_hops * n_convs["reverse"] + n_convs_dec,
              f"calibrated int8_static launches at batch {b} ({n_static} static Q2)")
        shapes += q1_counts(launched)
        q2_shapes += q2_counts(launched)
        d = (st_img - results[("off", b)][0]).abs()
        report[f"int8_static_vs_off_b{b}"] = {"mean_abs": d.mean().item(), "max_abs": d.max().item()}
        (off_again, _), _, _ = run("off", b)
        check(torch.equal(off_again, results[("off", b)][0]), f"off after calibration differs at batch {b}")
        print(f"  calibrated int8_static, batch {b}: vs off mean |diff| {d.mean().item():.4e}, max "
              f"{d.max().item():.4e}; off after calibration = off before, bit for bit")
    print(f"  collect_quant_stats: {report['collect_quant_stats_s']:.2f} s, {n_stats} conv amaxes")

    # ---- 3. invert and the controlled edit under int8 ----
    image = np.random.default_rng(41).integers(0, 256, (pix, pix, 3), dtype=np.uint8)
    noise = torch.randn((1, side, side, 4), generator=torch.Generator(device=dev).manual_seed(42),
                        device=dev)
    controller = make_controller([EDIT_SOURCE, EDIT_TARGET], pipe.tokenizer, n_hops, **EDIT_CONTROLLER)
    pipe.quantize = "int8"
    try:
        fa.reset_launch_counts()
        inv, clean = pipe.invert(image, EDIT_SOURCE, noise=noise)
        torch.cuda.synchronize()
        inv_launches = collections.Counter(fa.LAUNCH_SHAPES)
        fa.reset_launch_counts()
        edited, _ = pipe.edit(image, EDIT_SOURCE, EDIT_TARGET, controller, noise=noise)
        torch.cuda.synchronize()
        edit_launches = collections.Counter(fa.LAUNCH_SHAPES)
    finally:
        pipe.quantize = "off"
    n_inv = sum(q1_counts(inv_launches).values())
    n_edit = sum(q1_counts(edit_launches).values())
    check(n_inv == per_enc + n_hops * per_unet == sum(q2_counts(inv_launches).values()),
          f"int8 invert: {n_inv} Q1 launches")
    check(n_edit == n_inv + n_hops * per_unet + per_dec == sum(q2_counts(edit_launches).values()),
          f"int8 edit: {n_edit} Q1 launches")
    for label, t in (("invert", inv), ("edit", edited)):
        check(bool(torch.isfinite(t).all()), f"int8 {label} not finite")
    shapes += q1_counts(inv_launches) + q1_counts(edit_launches)
    q2_shapes += q2_counts(inv_launches) + q2_counts(edit_launches)
    print(f"  int8 invert ({n_inv} Q1 and Q2 launches) and controlled edit ({n_edit}): finite, "
          f"launches as derived")

    # ---- 4. Q1 and Q2 against their plain versions at every shape of those runs ----
    report["q1_vs_plain"] = q1_check_shapes(set(shapes), "the SD1.5 int8 runs", dev)
    report["q2_vs_plain"] = q2_check_shapes(set(q2_shapes), "the SD1.5 int8 runs", dev)

    # ---- 5. the entry points ----
    with tempfile.TemporaryDirectory() as tmp:
        pipe.quant_stats.clear()
        out = os.path.join(tmp, "gen")
        fa.reset_launch_counts()
        generate_cli.main(["--model", "sd15", "--quantize", "int8_static", "--prompt", PROMPTS[0],
                           "--prompt", PROMPTS[1], "--out", out], _pipe=pipe)
        cli_q1, cli_q2 = fa.launches("int8_gemm"), fa.launches("int8_quantize")
        with open(os.path.join(out, "manifest.json")) as f:
            files = json.load(f)["files"]
        check(len(files) == 2 and all(os.path.exists(p) for p in files), f"generate CLI files {files}")
        check(set(pipe.quant_stats) == {"reverse", "forward", "vae"} and pipe.quantize == "off",
              f"the generate CLI's int8_static: stats {sorted(pipe.quant_stats)}, mode {pipe.quantize}")
        check(cli_q1 == cli_q2 == want_gen["int8_gemm"], f"generate CLI: {cli_q1} Q1, {cli_q2} Q2 launches")
        src = os.path.join(tmp, "in.jpg")
        generate_cli.save_image(image, src)
        out = os.path.join(tmp, "edit")
        edit_cli.main(["--model", "sd15", "--quantize", "int8", "--image", src, "--source", EDIT_SOURCE,
                       "--target", EDIT_TARGET, "--out", out], _pipe=pipe)
        with open(os.path.join(out, "results.json")) as f:
            edited_file = json.load(f)["results"][0]["file"]
        check(os.path.exists(edited_file) and pipe.quantize == "off", "edit CLI --quantize int8")
        print(f"  generate CLI --quantize int8_static (calibrated once, {cli_q1} Q1 launches) and edit "
              f"CLI --quantize int8: files written, the bundle's mode restored")
    pipe.quantize = "int8"
    ex = BatchingExecutor(pipe, batch_sizes=SERVE_BATCH_SIZES, max_delay=INT8_SERVE_DELAY)
    try:
        lone = ex.submit(*LONE).result(timeout=600)
        burst, order, _ = burst_requests(ex, INT8_BURST)
        stats = ex.stats()
        check(stats["batches_b1"] == 1 and stats["batches_b4"] == 1 and stats["padded_slots"] == 1,
              f"int8 executor: the lone request at 1, the burst of 3 as one padded batch of 4: {stats}")
        want_lone, _ = pipe.generate([LONE[0]], latent=ex._latents([LONE[1]]), guidance=ex.guidance)
        reqs = [INT8_BURST[i] for i in order] + [INT8_BURST[order[-1]]]  # the executor's padding
        want_burst, _ = pipe.generate([p for p, _ in reqs], latent=ex._latents([s for _, s in reqs]),
                                      guidance=ex.guidance)
        check(np.array_equal(lone, want_lone[0].cpu().numpy()), "int8 lone request differs")
        check(all(np.array_equal(burst[i], want_burst[j].cpu().numpy()) for j, i in enumerate(order)),
              "int8 served rows differ from the direct generate of their padded batch")
    finally:
        ex.shutdown()
        pipe.quantize = "off"
    print(f"  BatchingExecutor{SERVE_BATCH_SIZES} on the int8 bundle: {stats}; served rows = rows of "
          f"direct int8 generates of the same padded batches, bit for bit")
    qq = quant_quality.main(["--model", "sd15", "--n", "2", "--batch_size", "2", "--quantize", "int8"],
                            _pipe=pipe)
    check(all(math.isfinite(qq[k]) for k in ("psnr_generate", "psnr_roundtrip")), f"quant_quality {qq}")
    report["quant_quality"] = qq

    # ---- 6. times ----
    unet = pipe.unets["reverse"]
    ctx = pipe._encode_all(PROMPTS, need_uncond=False)[1]
    z = results[("off", 4)][1].permute(0, 3, 1, 2).contiguous()
    w = w_embedding_for(pipe.default_guidance(), 999, BATCH, device=dev)
    t = torch.full((BATCH,), 999, device=dev)
    unet_ms, vae_ms = {}, {}
    with torch.inference_mode():
        quant.forget_weight_codes(unet)  # the first int8 call quantises every weight, the next none
        n_q = [quant.weight_quantizations()]
        for _ in range(2):
            with quant.quant_scope("int8"):
                unet(z, t, ctx, w)
            n_q.append(quant.weight_quantizations())
        check(n_q[1] - n_q[0] == n_unet and n_q[2] == n_q[1],
              f"weight quantisations of two int8 UNet calls: {n_q[1] - n_q[0]}, {n_q[2] - n_q[1]}")
        print(f"  weight codes: a UNet call after `forget_weight_codes` quantised {n_q[1] - n_q[0]} "
              f"weights (= its int8 layers), the next call {n_q[2] - n_q[1]}")
        for mode in ("off", "int8"):
            with quant.quant_scope(mode):
                unet_ms[mode] = cuda_ms(lambda: unet(z, t, ctx, w), per_loop=1)
            pipe.quantize = mode
            vae_ms[mode] = cuda_ms(lambda: pipe._decode_latents(z), per_loop=1, loops=3, warmup=1)
            pipe.quantize = "off"
    report.update(unet_call_ms_b4=unet_ms, vae_decode_ms_b4=vae_ms, generate_s=gen_s,
                  peak_gb=torch.cuda.max_memory_allocated() / 2**30,
                  weight_codes_gib=codes_gib(*pipe.unets.values(), pipe.vae),
                  weight_quantizations_second_call=n_q[2] - n_q[1])
    print(f"  batch {BATCH}: UNet call off {unet_ms['off']:.2f} ms, int8 {unet_ms['int8']:.2f} ms; VAE "
          f"decode off {vae_ms['off']:.2f} ms, int8 {vae_ms['int8']:.2f} ms ({card})")
    print("  generate s by mode (batch 4, 1): " + "; ".join(
        f"{m} {gen_s[m][4]:.3f}, {gen_s[m][1]:.3f}" for m in QUANT_MODES)
          + f"; peak {report['peak_gb']:.2f} GiB, cached weight codes {report['weight_codes_gib']:.3f} GiB")

    # ---- 7. Q1's and Q2's rows: the costliest shapes of the batch-4 int8 generate ----
    launches_all = int8_gen[4] + int8_gen[1] + q1_counts(inv_launches) + q1_counts(edit_launches)
    rows = [q1_row(key, launches_all[key], dev) for key in q1_costliest(int8_gen[BATCH], Q1_TOP)]
    launches_q2 = (int8_gen_q2[4] + int8_gen_q2[1] + q2_counts(inv_launches)
                   + q2_counts(edit_launches))
    rows += [q2_row(key, launches_q2[key], dev) for key in q2_costliest(int8_gen_q2[BATCH], Q2_TOP)]
    report["q1_rows"] = [{k: r[k] for k in ("name", "ms", "bound_ms", "bound_by", "plain_ms",
                                              "library_ms", "library", "launches")} for r in rows]
    pipe.quant_stats.clear()
    report["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps(report))
    return rows


def phase_int8_sdxl(card: str, pipe, latent):
    """One int8 generate of the SDXL bundle at 1024^2, batch 1 (after a
    warm-up one): finite, exact Q1 and Q2 launches (the fp32 VAE's layers
    writing fp32), B1 and B2's fp32 build at their "off" counts; Q1 and Q2
    against their plain versions at every shape of the fp32 VAE decode.
    Returns their rows at the decode's costliest shape."""
    import torch

    from invertible_cd_tpu_torch.ops import flash_attention as fa

    cfg, vcfg = pipe.unets["reverse"].cfg, pipe.vae.cfg
    side, n_hops = pipe.latent_size[0], pipe.grid.num_reverse_steps
    per_unet, per_dec = q1_unet_launches(cfg), q1_vae_launches(vcfg, True)
    off, _ = pipe.generate([EDIT_SOURCE], latent=latent)
    pipe.quantize = "int8"
    try:
        pipe.generate([EDIT_SOURCE], latent=latent)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # ---- counts reset just before, read just after ----
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        images, lat = pipe.generate([EDIT_SOURCE], latent=latent)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = collections.Counter(fa.LAUNCH_SHAPES)
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        pipe.quantize = "off"
    q1 = q1_counts(launched)
    vae = collections.Counter({k: c for k, c in q1.items() if k[-1] == "float32"})
    vae_q2 = collections.Counter({k: c for k, c in q2_counts(launched).items() if k[-1] == "float32"})
    totals = {name: sum(c for k, c in launched.items() if k[0] == name)
              for name in ("int8_gemm", "int8_quantize", "flash_fwd", "flash_fwd_streamed_f32")}
    vae_b2 = vcfg.block_out_channels[-1] > 256  # the fp32 VAE's single head: B2's fp32 build, else B1
    want = {"int8_gemm": n_hops * per_unet + per_dec, "int8_quantize": n_hops * per_unet + per_dec,
            "flash_fwd": n_hops * sum(unet_launches_per_call(cfg, side).values()) + (not vae_b2),
            "flash_fwd_streamed_f32": int(vae_b2)}
    check(totals == want, f"SDXL int8 generate launches {totals} != {want}")
    check(sum(vae.values()) == sum(vae_q2.values()) == per_dec,
          f"fp32 VAE: {sum(vae.values())} fp32 Q1 launches, {sum(vae_q2.values())} Q2, not {per_dec}")
    check(bool(torch.isfinite(images).all()) and bool(torch.isfinite(lat).all()), "SDXL int8 not finite")
    d = (images - off).abs()
    print(f"sdxl int8: generate at 1024^2, batch 1: {secs * 1e3:.1f} ms, launches {totals} (derived: "
          f"{per_unet} Q1 and Q2 a UNet call, {per_dec} a decode, all {per_dec} of the fp32 VAE's in and "
          f"writing fp32); vs off mean |diff| {d.mean().item():.4e}, max {d.max().item():.4e}; peak "
          f"{peak:.2f} GiB, cached weight codes {codes_gib(pipe.unets['reverse'], pipe.vae):.3f} GiB ({card})")
    checked = q1_check_shapes(set(vae), "SDXL's fp32 VAE decode at 1024^2", pipe.device)
    checked_q2 = q2_check_shapes(set(vae_q2), "SDXL's fp32 VAE decode at 1024^2", pipe.device)
    top, top_q2 = q1_costliest(vae, 1)[0], q2_costliest(vae_q2, 1)[0]
    rows = [q1_row(top, vae[top], pipe.device), q2_row(top_q2, vae_q2[top_q2], pipe.device)]
    print(json.dumps({"phase": "int8 sdxl", "card": card, "generate_ms": secs * 1e3, "launches": totals,
                      "vs_off": {"mean_abs": d.mean().item(), "max_abs": d.max().item()},
                      "peak_gb": peak, "weight_codes_gib": codes_gib(pipe.unets["reverse"], pipe.vae),
                      "q1_vs_plain": checked, "q2_vs_plain": checked_q2}))
    return rows


def phase_sdxl(card: str):
    """The SDXL paths (BASELINE configs 3 and 4) at 1024^2: `generate` of one
    prompt, `invert` of a seeded image and the amplify `edit`, on
    `InvertibleCDXL.sdxl` at full width with seeded weights and LoRAs and the
    fp32 VAE, launch counts reset just before each and read just after; then
    the bf16-VAE opt-in's decodes, checks, times and one traced generate.
    Returns the launches per (kernel, Sq, Sk, d) at batch 1 (generate,
    invert, the opt-in decode) and batch 2 (the edited pair, its opt-in
    decode)."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from invertible_cd_tpu_torch.models.attention import AttnMeta
    from invertible_cd_tpu_torch.models.layers import cast_compute_weights
    from invertible_cd_tpu_torch.models.unet2d import count_attention_layers
    from invertible_cd_tpu_torch.ops import flash_attention as fa
    from invertible_cd_tpu_torch.pipelines.sampler import w_embedding_for
    from invertible_cd_tpu_torch.pipelines.sdxl import InvertibleCDXL
    from invertible_cd_tpu_torch.testing import tiny_configs_xl
    from invertible_cd_tpu_torch.utils.tokenizer import HashTokenizer

    t0 = time.perf_counter()
    pipe = InvertibleCDXL.sdxl(device="cuda", dtype=torch.bfloat16, vae_dtype=torch.float32, seed=0)
    torch.cuda.synchronize()
    n_params = {name: sum(p.numel() for p in m.parameters()) for name, m in (
        ("unet", pipe.unets["reverse"]), ("clip", pipe.text_encoder),
        ("clip_big_g", pipe.text_encoder_2), ("vae", pipe.vae))}
    print(f"sdxl: InvertibleCDXL.sdxl built in {time.perf_counter() - t0:.1f} s, params {n_params}, "
          f"VAE {pipe.vae.dtype}")
    cfg = pipe.unets["reverse"].cfg
    n_hops = pipe.grid.num_reverse_steps
    side = pipe.latent_size[0]
    per_call = unet_launches_per_call(cfg, side)
    check(sum(per_call.values()) == count_attention_layers(cfg) == 140,
          f"{sum(per_call.values())} attention layers per call")
    vae_key = ("flash_fwd_streamed_f32", side * side, side * side, pipe.vae.cfg.block_out_channels[-1])
    want_hops = collections.Counter({k: n_hops * n for k, n in per_call.items()})
    want_generate = want_hops + collections.Counter({vae_key: 1})  # the decode
    want_invert = want_hops + collections.Counter({vae_key: 1})    # the encode
    want_pair = want_hops + collections.Counter({vae_key: 1})      # batch 2, the decode

    image = np.random.default_rng(31).integers(0, 256, (8 * side, 8 * side, 3), dtype=np.uint8)
    noise = torch.randn((1, side, side, 4), generator=torch.Generator(device="cuda").manual_seed(32),
                        device="cuda")
    latent = torch.randn((1, side, side, 4), generator=torch.Generator(device="cuda").manual_seed(33),
                         device="cuda")

    def generate():
        return pipe.generate([EDIT_SOURCE], latent=latent)

    def edit():
        return pipe.edit(image, EDIT_SOURCE, EDIT_TARGET, noise=noise)

    generate()  # warm-up: plans and handles at batch 1 and 2
    edit()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # ---- the SDXL paths: counts reset just before, read just after ----
    counted = {}
    times = {}
    outputs = {}
    for label, fn in (("generate", generate),
                      ("invert", lambda: pipe.invert(image, EDIT_SOURCE, noise=noise)),
                      ("edit", edit)):
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        outputs[label] = fn()
        torch.cuda.synchronize()
        times[label] = time.perf_counter() - t0
        counted[label] = collections.Counter(fa.LAUNCH_SHAPES)
    # --------------------------------------------------------------------
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    pair_launches = counted["edit"] - counted["invert"]
    print(f"  launches per (kernel, Sq, Sk, d): generate {dict(counted['generate'])}; edit's pair "
          f"{dict(pair_launches)}")
    check(counted["generate"] == want_generate,
          f"generate launches {dict(counted['generate'])} != {dict(want_generate)}")
    check(counted["invert"] == want_invert,
          f"invert launches {dict(counted['invert'])} != {dict(want_invert)}")
    check(counted["edit"] == want_invert + want_pair,
          f"edit launches {dict(counted['edit'])} != {dict(want_invert + want_pair)}")
    print(f"  derived from UNetConfig.sdxl() and {n_hops} hops and launched: generate "
          f"{sum(want_generate.values())}, invert {sum(want_invert.values())}, edit "
          f"{sum((want_invert + want_pair).values())} (B2 fp32 at {vae_key[1]} tokens once each "
          f"in generate and invert, twice in edit)")

    images, lat = outputs["generate"]
    inv, clean = outputs["invert"]
    edit_images, edit_lat = outputs["edit"]
    for name, t, shape in (("generate images", images, (1, 8 * side, 8 * side, 3)),
                           ("generate latents", lat, (1, side, side, 4)),
                           ("inverted latent", inv, (1, side, side, 4)),
                           ("clean latent", clean, (1, side, side, 4)),
                           ("edit images", edit_images, (2, 8 * side, 8 * side, 3)),
                           ("edit latents", edit_lat, (2, side, side, 4))):
        check(tuple(t.shape) == shape and bool(torch.isfinite(t).all()),
              f"{name} {tuple(t.shape)} != {shape} or not finite")
    for imgs in (images, edit_images):
        check(imgs.dtype == torch.float32 and 0.0 <= imgs.min().item() and imgs.max().item() <= 1.0,
              "images outside [0, 1]")
    check(torch.equal(generate()[0], images), "the same latent gave a different image")
    check(torch.equal(edit()[0], edit_images), "the same image and noise gave a different edit")
    moved = ((edit_lat[1:] - edit_lat[:1]).norm() / edit_lat[:1].norm()).item()
    print(f"  same latent, same image and noise -> identical generate and edit: ok; images: "
          f"generate mean {images.mean().item():.4f} std {images.std().item():.4f}; the edit's "
          f"row 1 differs from row 0 by {moved:.3f} (relative L2)")

    # one request through the executor at batch 1: the image equals generate's
    # on the same latent, bit for bit
    from invertible_cd_tpu_torch.serving import BatchingExecutor

    with BatchingExecutor(pipe, batch_size=1, max_delay=0.0) as ex:
        ex.submit(EDIT_TARGET, seed=4).result(timeout=600)  # warm-up: the worker thread's handles
        # ---- the served request: counts reset just before, read just after ----
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        served = ex.submit(EDIT_SOURCE, seed=5).result(timeout=600)
        times["served"] = time.perf_counter() - t0
        counted["served"] = collections.Counter(fa.LAUNCH_SHAPES)
        # -------------------------------------------------------------------
        direct = pipe.generate([EDIT_SOURCE], latent=ex._latents([5]), guidance=ex.guidance)[0]
    check(counted["served"] == want_generate, f"served launches {dict(counted['served'])}")
    check(served.shape == (8 * side, 8 * side, 3) and np.array_equal(served, direct[0].cpu().numpy()),
          f"the served SDXL image {served.shape} differs from generate at batch 1")
    print(f"  BatchingExecutor(batch_size=1): one request, {8 * side}^2, = generate on its latent bit "
          f"for bit; {times['served'] * 1e3:.1f} ms submit to image ({card})")

    # the bf16-VAE opt-in (`vae_dtype=torch.bfloat16`): the same VAE weights in
    # bf16 decode the generate's latent (batch 1) and the edited pair (batch 2)
    # through B2's bf16 build
    vae16 = dataclasses.replace(pipe, vae=cast_compute_weights(copy.deepcopy(pipe.vae), torch.bfloat16))
    bf16_key = ("flash_fwd_streamed",) + vae_key[1:]
    opt_in = {}
    for b, lat_b in ((1, lat), (2, edit_lat)):
        fa.reset_launch_counts()
        dec16 = vae16.decode(lat_b)
        torch.cuda.synchronize()
        opt_in[b] = collections.Counter(fa.LAUNCH_SHAPES)
        check(opt_in[b] == collections.Counter({bf16_key: 1}), f"bf16 decode launches {dict(opt_in[b])}")
        err = float(np.abs(dec16 - (images if b == 1 else edit_images).cpu().numpy()).max())
        print(f"  bf16-VAE opt-in, batch {b}: decode max abs difference from the fp32 VAE's "
              f"images {err:.3e} (not gated)")
    del vae16

    # one full-width UNet call: kernel path against the materialised path
    unet = pipe.unets["reverse"]
    ctx_u, ctx, added = pipe._encode_all([EDIT_SOURCE])
    x = lat.permute(0, 3, 1, 2).contiguous()
    w = w_embedding_for(pipe.default_guidance(), 999, 1, device="cuda")
    t = torch.full((1,), 999, device="cuda")

    def identity_hook(probs, meta: AttnMeta):
        return probs
    with torch.inference_mode():
        eps_kernel = unet(x, t, ctx, w, added_cond=added)
        eps_plain = unet(x, t, ctx, w, added_cond=added, attn_hook=identity_hook)
        rel = ((eps_kernel - eps_plain).norm() / eps_plain.norm()).item()
        unet_ms = cuda_ms(lambda: unet(x, t, ctx, w, added_cond=added), per_loop=1, loops=3)
        decode_ms = cuda_ms(lambda: pipe._decode_latents(x), per_loop=1, loops=3, warmup=1)
        pixels = torch.as_tensor(image, device="cuda")[None].float() / 127.5 - 1.0
        encode_ms = cuda_ms(lambda: pipe._encode_image(pixels), per_loop=1, loops=3, warmup=1)
        tokens = torch.as_tensor(pipe.tokenizer([EDIT_SOURCE]), dtype=torch.long, device="cuda")
        tokens2 = torch.as_tensor(pipe.tokenizer_2([EDIT_SOURCE]), dtype=torch.long, device="cuda")
        clip_ms = cuda_ms(lambda: pipe.text_encoder(tokens), per_loop=1)
        clip2_ms = cuda_ms(lambda: pipe.text_encoder_2(tokens2), per_loop=1)
    print(f"  UNet kernel path vs materialised path (batch 1, t=999): relative L2 {rel:.3e} "
          f"(tol {UNET_REL_TOL})")
    check(rel <= UNET_REL_TOL, f"SDXL UNet kernel path off by {rel}")

    # the tiny XL bundle on the card against the same weights in fp32 on the
    # CPU, every UNet call teacher-forced. The card's VAE takes the bf16
    # opt-in: the tiny VAE's d = 32 head goes to B1, which takes bf16 only
    unet_cfg, clip_cfg, clip2_cfg, vae_cfg = tiny_configs_xl()
    tok = HashTokenizer(clip_cfg.vocab_size)
    cfgs = dict(unet_cfg=unet_cfg, clip_cfg=clip_cfg, clip2_cfg=clip2_cfg, vae_cfg=vae_cfg,
                latent_size=(16, 16), tokenizer=tok, tokenizer_2=tok, default_resolution=32)
    cpu_pipe = InvertibleCDXL.sdxl(device="cpu", dtype=torch.float32, vae_dtype=torch.float32,
                                   seed=7, lora_rank=64, **cfgs)
    params = {name: m.state_dict() for name, m in (
        ("reverse", cpu_pipe.unets["reverse"]), ("forward", cpu_pipe.unets["forward"]),
        ("text", cpu_pipe.text_encoder), ("text_2", cpu_pipe.text_encoder_2), ("vae", cpu_pipe.vae))}
    gpu_pipe = InvertibleCDXL.sdxl(params=params, device="cuda", dtype=torch.bfloat16,
                                   vae_dtype=torch.bfloat16, **cfgs)
    tiny_image = np.random.default_rng(34).integers(0, 256, (32, 32, 3), dtype=np.uint8)
    tiny_noise = torch.randn((1, 16, 16, 4), generator=torch.Generator().manual_seed(35))
    tiny_latent = torch.randn((1, 16, 16, 4), generator=torch.Generator().manual_seed(36))
    errs = {}
    for label, run in (
            ("generate", lambda p: p.generate([EDIT_SOURCE], latent=tiny_latent)),
            ("invert", lambda p: p.invert(tiny_image, EDIT_SOURCE, noise=tiny_noise)),
            ("edit", lambda p: p.edit(tiny_image, EDIT_SOURCE, EDIT_TARGET, noise=tiny_noise))):
        errs[label], want = forced_unet_errors(cpu_pipe, gpu_pipe, lambda: run(cpu_pipe))
        got = run(gpu_pipe)
        errs[label + " end to end"] = (got[1].float().cpu() - want[1]).abs().max().item()
        check(all(bool(torch.isfinite(g).all()) for g in got), f"tiny XL {label} on the card not finite")
    clean_err = (gpu_pipe.invert(tiny_image, EDIT_SOURCE, noise=tiny_noise)[1].cpu()
                 - cpu_pipe.invert(tiny_image, EDIT_SOURCE, noise=tiny_noise)[1]).abs().max().item()
    print(f"  tiny XL bundle, card bf16 vs CPU fp32, teacher-forced epsilon relative L2 (tol "
          f"{UNET_REL_TOL}): " + "; ".join(
              f"{k} {' '.join(f'{e:.1e}' for e in v)}" for k, v in errs.items() if isinstance(v, list))
          + f"; VAE encode max abs error {clean_err:.3e} (tol {TINY_TOL}); not gated, end to end "
          f"(second output, max abs): " + "; ".join(
              f"{k} {v:.3e}" for k, v in errs.items() if not isinstance(v, list)))
    check(len(errs["generate"]) == n_hops and len(errs["invert"]) == n_hops
          and len(errs["edit"]) == 2 * n_hops, f"tiny XL UNet calls {errs}")
    check(max(errs["generate"] + errs["invert"] + errs["edit"]) <= UNET_REL_TOL,
          f"tiny XL UNet calls off: {errs}")
    check(clean_err <= TINY_TOL, f"tiny XL VAE encode off by {clean_err}")

    print(f"  generate (1 prompt, {n_hops} hops, 1024^2): {times['generate'] * 1e3:.1f} ms; invert: "
          f"{times['invert'] * 1e3:.1f} ms; edit (invert + the amplify pair): {times['edit'] * 1e3:.1f} ms; "
          f"peak memory {peak_gb:.2f} GiB ({card})")
    print(f"  UNet call {unet_ms:.2f} ms; fp32 VAE decode {decode_ms:.2f} ms, encode {encode_ms:.2f} ms; "
          f"text encoders ViT-L {clip_ms:.2f} ms, bigG {clip2_ms:.2f} ms ({card})")
    q1_rows = phase_int8_sdxl(card, pipe, latent)
    trace_run("SDXL generate, 1024^2", generate)
    return {1: counted["generate"] + counted["invert"] + counted["served"] + opt_in[1],
            2: pair_launches + opt_in[2]}, q1_rows


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


def sd15_step_launches(steps: int) -> collections.Counter:
    """B1, B3 and B4 launches per (kernel, Sq, Sk, d) of `steps` SD1.5
    train steps (derived in `phase_training`): 11 UNet forwards and 4
    differentiated student calls a step."""
    want = collections.Counter()
    for tokens, layers in LAYERS_PER_CALL.items():
        d = HEAD_DIM[tokens]
        for sk in (tokens, 77):
            want[("flash_fwd", tokens, sk, d)] = 11 * layers * steps
            want[("flash_bwd_dq", tokens, sk, d)] = 4 * layers * steps
            want[("flash_bwd_dkdv", tokens, sk, d)] = 4 * layers * steps
    return want


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
    want = sd15_step_launches(TRAIN_STEPS)
    totals = {name: sum(n for key, n in shape_launches.items() if key[0] == name) // TRAIN_STEPS
              for name in fa.KERNELS}
    print(f"  launches per train step: {totals}")
    check(shape_launches == want, f"launches {dict(shape_launches)} != {dict(want)}")
    check(totals == {"flash_fwd": 352, "flash_fwd_streamed": 0, "flash_fwd_streamed_f32": 0,
                     "flash_bwd_dq": 128, "flash_bwd_dkdv": 128, "flash_variant": 0},
          f"launches per step {totals}")

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


# ---- phase 5d: distribution ----
# Two ranks' step (one row each, gradients averaged) against the one-process
# step at batch 2, bf16 on the card, where a row's bits depend on its batch.
# The first Adam step moves each entry by about lr * sign(g), so an entry
# whose gradient sign differs between the two computations moves 2 lr apart:
# 0.9% of them gave 0.1415 relative L2 of the update on an H100 80GB HBM3 at
# 700 W (gradients 1.04e-2, logged metrics at most 2.3e-3 relative). The
# same run with the gradient reduction taken out of the trainer (each rank
# updating from its own row) read 0.864 on the update, 0.217 on the
# gradients and 5.4e-2 on a grad norm, and the ranks' adapters differed;
# with a sum in place of the mean it read 0.150 on the update (Adam's first
# step is scale-invariant, so the update gate cannot see it), 0.158 on the
# gradients (the global-norm clip undoes the doubling where a norm exceeds
# its limit) and 1.0 on the grad norms. The update gate catches a wrong
# sign or a lost reduction; the gradient and metric gates a wrong scale.
DIST_STEP_TOL = 0.3   # relative L2 of the adapter update
DIST_GRAD_TOL = 5e-2  # relative L2 of the gradients (Adam's first moment)
DIST_METRIC_TOL = 1e-2  # relative difference of each logged loss and grad norm
DIST_SERVE = [("a photo of a corgi on the beach", 7), ("a red fox", 2**40 + 3),
              ("a bowl of ramen", -5), ("a lighthouse at dusk", 0)]
DIST_WORKER_TIMEOUT = 420


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def serve_launches_per_batch() -> collections.Counter:
    """B1 and B2 launches of one served SD1.5 batch (a 4-hop generate)."""
    want = collections.Counter()
    for tokens, layers in LAYERS_PER_CALL.items():
        for sk in (tokens, 77):
            want[("flash_fwd", tokens, sk, HEAD_DIM[tokens])] = 4 * layers
    want[("flash_fwd_streamed", 4096, 4096, 512)] = 1
    return want


def dist_train_setup(pipe):
    """The train step's inputs of phase 5d, the same in every process that
    builds the seeded SD1.5 bundle: the reverse UNet's weights as teacher
    and as an fp32 base, seeded non-zero r = 64 adapters for both students
    (so both factors get gradients), a seeded global batch of TRAIN_BATCH."""
    import torch

    from invertible_cd_tpu_torch.diffusion.solver import make_train_solver
    from invertible_cd_tpu_torch.models.lora import seeded_lora
    from invertible_cd_tpu_torch.training import ICDTrainState, LossConfig, TrainConfig
    from invertible_cd_tpu_torch.training.trainer import init_optimizer

    unet = pipe.unets["reverse"]
    teacher = unet.state_dict()
    base = {k: v.float() for k, v in teacher.items()}
    solver = make_train_solver(
        pipe.schedule.alphas_cumprod, num_endpoints=4, num_forward_endpoints=4,
        endpoints="0,259,519,779", forward_endpoints="259,519,779,999", device="cuda")
    tcfg = TrainConfig(loss=LossConfig(w_embed_dim=unet.cfg.time_cond_proj_dim))
    gen = torch.Generator(device="cuda").manual_seed(21)
    lora_r, lora_f = seeded_lora(base, gen, tcfg.lora_rank), seeded_lora(base, gen, tcfg.lora_rank)
    for ab in (*lora_r.values(), *lora_f.values()):
        ab["up"].mul_(0.1)
    state = ICDTrainState(0, lora_r, lora_f, init_optimizer(lora_r, tcfg), init_optimizer(lora_f, tcfg))
    g = torch.Generator(device="cuda").manual_seed(2000)
    batch = {"latents": torch.randn((TRAIN_BATCH, 64, 64, 4), generator=g, device="cuda"),
             "context": 0.1 * torch.randn((TRAIN_BATCH, 77, 768), generator=g, device="cuda")}
    return unet, base, teacher, solver, tcfg, state, batch


def dist_step_generator():
    import torch

    return torch.Generator(device="cuda").manual_seed(5)


def adapters_flat(state, part=None):
    """Both students' adapters (or their optimizer's `part`, e.g. "mu") as
    one flat fp32 vector."""
    import torch

    trees = ((state.lora_reverse, state.lora_forward) if part is None
             else (state.opt_reverse[part], state.opt_forward[part]))
    return torch.cat([t.float().flatten() for tree in trees for ab in tree.values()
                      for t in ab.values()])


def plant_reduction_fault(fault: str):
    """Replace the trainer's gradient reduction for this process: "none"
    leaves each rank's gradients its own, "sum" sums them without dividing.
    The logged losses are still averaged."""
    from invertible_cd_tpu_torch.training import trainer

    real, calls = trainer.all_reduce_mean, []

    def faulty(tensors, mesh):
        calls.append(None)
        if len(calls) > 2:  # the third call of a step averages the losses
            return real(tensors, mesh)
        if fault == "none":
            return list(tensors)
        return [t * mesh.rows for t in real(tensors, mesh)]
    trainer.all_reduce_mean = faulty


def dist_worker(rank: int, port: int, out_dir: str, fault=None) -> int:
    """One of phase 5d's two ranks on the one card, over gloo: the seeded
    SD1.5 bundle, one train step on this rank's row of the global batch
    (with `fault`, under `plant_reduction_fault`), then its rows of a dp = 2
    served burst (rank 0 runs the executor, rank 1 the follower loop).
    Writes `rank<r>.json`."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from invertible_cd_tpu_torch.ops import flash_attention as fa
    from invertible_cd_tpu_torch.parallel import (
        all_gather_objects, all_reduce_mean, initialize_distributed, make_mesh,
        process_local_batch_slice, shard_batch)
    from invertible_cd_tpu_torch.pipelines.pipeline import InvertibleCD
    from invertible_cd_tpu_torch.serving import BatchingExecutor, request_latents, serve_follower
    from invertible_cd_tpu_torch.training import make_train_step

    t_start = time.perf_counter()
    if fault:
        plant_reduction_fault(fault)
    torch.cuda.set_device(0)
    initialize_distributed(f"localhost:{port}", 2, rank, backend="gloo", device="cuda:0")
    mesh = make_mesh(device="cuda")
    pipe = InvertibleCD.sd15(device="cuda", dtype=torch.bfloat16, seed=0)
    unet, base, teacher, solver, tcfg, state, batch = dist_train_setup(pipe)
    out = {"rank": rank, "rows": mesh.rows}

    # ---- this rank's step: counts reset just before, read just after ----
    step_fn = make_train_step(unet, base, teacher, solver, pipe.schedule, tcfg, mesh)
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    new, metrics = step_fn(state, shard_batch(batch, mesh), dist_step_generator())
    torch.cuda.synchronize()
    out["step_s"] = time.perf_counter() - t0
    out["step_launches"] = [[list(k), n] for k, n in fa.LAUNCH_SHAPES.items()]
    # ---------------------------------------------------------------------
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    mine = adapters_flat(new)
    theirs = mine.clone()
    dist.broadcast(theirs, src=0)  # gloo broadcasts CUDA tensors
    out["adapters_equal_rank0"] = bool(torch.equal(mine, theirs))
    # what one student's gradient reduction costs over gloo (through the host)
    grads = torch.zeros(mine.numel() // 2, device="cuda")
    dist.barrier()
    t0 = time.perf_counter()
    all_reduce_mean([grads], mesh)
    torch.cuda.synchronize()
    out["allreduce_one_student_s"] = time.perf_counter() - t0
    del grads
    if rank == 0:  # the one-process step on the global batch, from the same draws
        ref, ref_metrics = make_train_step(unet, base, teacher, solver, pipe.schedule, tcfg)(
            state, batch, dist_step_generator())
        old = adapters_flat(state)
        d_got, d_ref = mine - old, adapters_flat(ref) - old
        out["update_rel_l2"] = ((d_got - d_ref).norm() / d_ref.norm()).item()
        out["same_sign_moves"] = (torch.sign(d_got) == torch.sign(d_ref)).float().mean().item()
        mu, mu_ref = adapters_flat(new, "mu"), adapters_flat(ref, "mu")
        out["mu_rel_l2"] = ((mu - mu_ref).norm() / mu_ref.norm()).item()
        out["metric_rel"] = {k: abs(out["metrics"][k] - float(v)) / max(abs(float(v)), 1e-12)
                             for k, v in ref_metrics.items()}
        del ref, d_got, d_ref, mu, mu_ref
    del new, mine, theirs, step_fn
    torch.cuda.empty_cache()

    # ---- the served burst: counts reset just before, read just after ----
    prompts = [p for p, _ in DIST_SERVE]
    seeds = [s for _, s in DIST_SERVE]
    dist.barrier()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    if rank == 0:
        with BatchingExecutor(pipe, batch_size=len(DIST_SERVE), max_delay=1.0, mesh=mesh) as ex:
            futs = [ex.submit(p, seed=s) for p, s in DIST_SERVE]
            served = np.stack([f.result(timeout=600) for f in futs])
            out["serve_stats"] = ex.stats()
    else:
        out["served_batches"] = serve_follower(pipe, mesh)
    torch.cuda.synchronize()
    out["serve_s"] = time.perf_counter() - t0
    out["serve_launches"] = [[list(k), n] for k, n in fa.LAUNCH_SHAPES.items()]
    # ---------------------------------------------------------------------
    lo, n = process_local_batch_slice(len(DIST_SERVE), mesh)
    direct, _ = pipe.generate(prompts[lo:lo + n], latent=request_latents(pipe, seeds[lo:lo + n]),
                              guidance=pipe.default_guidance())
    parts = all_gather_objects(direct.cpu().numpy(), mesh)
    if rank == 0:
        want = np.concatenate(parts)
        out["served_bit_for_bit"] = bool(np.array_equal(served, want))
        out["served_max_abs_diff"] = float(np.abs(served - want).max())
        out["served_finite_01"] = bool(np.isfinite(served).all() and served.min() >= 0
                                       and served.max() <= 1)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["wall_s"] = time.perf_counter() - t_start
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def counter_of(pairs) -> collections.Counter:
    return collections.Counter({tuple(k): n for k, n in pairs})


def run_dist_workers(fault=None, job: str = "dp") -> list:
    """Phase 5d(b)'s two ranks (`dist_worker`), or with job "sptp" phase
    5e's (`sptp_worker`): two processes of this script over gloo on the one
    card, `fault` passed on; each rank's JSON, in rank order."""
    import tempfile

    extra = ["--dist-job", job]
    if fault:
        extra += ["--dist-fault" if job == "dp" or fault == "to_tp" else "--sp-fault", fault]
    with tempfile.TemporaryDirectory() as tmp:
        port = free_port()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dist-worker",
                                   str(r), str(port), tmp] + extra, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT) for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=DIST_WORKER_TIMEOUT)[0].decode(errors="replace"))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            check(p.returncode == 0, f"(b) rank {r} exited {p.returncode}:\n{log[-4000:]}")
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"{'sptp_' if job == 'sptp' else ''}rank{r}.json")) as f:
                ranks.append(json.load(f))
    return ranks


def phase_dist_fault(fault: str):
    """`--dist-fault`: phase 5d(b)'s two ranks with the trainer's gradient
    reduction faulted (`plant_reduction_fault`), or with "to_tp" phase 5e's
    tp = 2 train step with `to_tp`'s backward sum taken out
    (`plant_tp_fault`), to show what the step's gates read under the
    fault; prints rank 0's readings, checks nothing."""
    if fault == "to_tp":
        r0, r1 = (rk["train"]["tp"] for rk in run_dist_workers(fault, job="sptp"))
        print(json.dumps({"dist_fault": fault, "tolerances": {
            "update": DIST_STEP_TOL, "gradients": DIST_GRAD_TOL, "metrics": DIST_METRIC_TOL},
            **{k: r0[k] for k in ("update_rel_l2", "same_sign_moves", "mu_rel_l2", "metric_rel")},
            "adapters_equal_on_both_ranks": r1["equal_rank0"],
            "metrics_equal_on_both_ranks": r0["metrics"] == r1["metrics"]}))
        return
    r0, r1 = run_dist_workers(fault)
    print(json.dumps({"dist_fault": fault, "tolerances": {
        "update": DIST_STEP_TOL, "gradients": DIST_GRAD_TOL, "metrics": DIST_METRIC_TOL},
        **{k: r0[k] for k in ("update_rel_l2", "same_sign_moves", "mu_rel_l2", "metric_rel")},
        "adapters_equal_on_both_ranks": r1["adapters_equal_rank0"],
        "metrics_equal_on_both_ranks": r0["metrics"] == r1["metrics"]}))


def phase_distributed(card: str, pipe):
    """Phase 5d: the distribution layer (`invertible_cd_tpu_torch.parallel`)
    on the one card. (a) world size 1 over NCCL in this process; (b) two
    ranks sharing the card over gloo, as two processes; (c) the train CLI
    under torchrun; (d) the phase's time and peak memory. Returns the
    counted launches by batch: (a)'s step under BATCH (as phase 5's steps)
    and its burst at 4, (b)'s steps at 1 and its served rows at 2."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from invertible_cd_tpu_torch.ops import flash_attention as fa
    from invertible_cd_tpu_torch.parallel import make_mesh
    from invertible_cd_tpu_torch.serving import BatchingExecutor
    from invertible_cd_tpu_torch.training import make_train_step

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    report = {"phase": "5d distribution", "card": card}
    launches = collections.defaultdict(collections.Counter)

    # ---- (a) world size 1 over NCCL, in this process ----
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(device="cuda")
        check(mesh.device_mesh is not None and mesh.shape == {"dp": 1, "fsdp": 1, "sp": 1, "tp": 1},
              f"world-1 mesh {mesh}")
        unet, base, teacher, solver, tcfg, state, batch = dist_train_setup(pipe)
        plain_fn = make_train_step(unet, base, teacher, solver, pipe.schedule, tcfg)
        mesh_fn = make_train_step(unet, base, teacher, solver, pipe.schedule, tcfg, mesh)
        runs, ms = {}, {"plain": [], "mesh": []}
        for name, fn in (("plain", plain_fn), ("mesh", mesh_fn), ("plain", plain_fn),
                         ("mesh", mesh_fn)):  # the first of each compared, the mesh one counted
            torch.cuda.synchronize()
            first = name not in runs
            if first and name == "mesh":
                fa.reset_launch_counts()
            t0 = time.perf_counter()
            out = fn(state, batch, dist_step_generator())
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
            if first:
                runs[name] = out
                if name == "mesh":
                    step_launches = collections.Counter(fa.LAUNCH_SHAPES)
            del out
        check(step_launches == sd15_step_launches(1), f"(a) mesh step launches {dict(step_launches)}")
        launches[BATCH] += step_launches
        (plain, m_plain), (meshed, m_mesh) = runs["plain"], runs["mesh"]
        same = all(states_equal(getattr(plain, f), getattr(meshed, f))
                   for f in ("lora_reverse", "lora_forward", "opt_reverse", "opt_forward"))
        check(same, "(a) the world-1 NCCL step differs from the plain step")
        check({k: float(v) for k, v in m_plain.items()} == {k: float(v) for k, v in m_mesh.items()},
              "(a) the world-1 NCCL step's metrics differ")
        report["a_step_ms"] = ms
        print(f"distribution (a): world size 1 over NCCL, batch {TRAIN_BATCH}: the mesh step equals "
              f"the plain step bit for bit (adapters, optimizer states, metrics); step ms plain "
              f"{ms['plain']}, mesh {ms['mesh']} ({card})")
        del plain, meshed, runs, plain_fn, mesh_fn, base, teacher, state
        torch.cuda.empty_cache()

        served = {}
        for name, m in (("plain", None), ("mesh", make_mesh(dp=1, device="cuda"))):
            with BatchingExecutor(pipe, batch_size=len(DIST_SERVE), max_delay=1.0, mesh=m) as ex:
                fa.reset_launch_counts()
                futs = [ex.submit(p, seed=s) for p, s in DIST_SERVE]
                served[name] = np.stack([f.result(timeout=600) for f in futs])
                stats = ex.stats()
            check(stats["batches"] == 1, f"(a) {name} burst stats {stats}")
            if name == "mesh":
                burst_launches = collections.Counter(fa.LAUNCH_SHAPES)
        check(burst_launches == serve_launches_per_batch(), f"(a) served launches {dict(burst_launches)}")
        launches[len(DIST_SERVE)] += burst_launches
        check(np.array_equal(served["mesh"], served["plain"]),
              "(a) the dp = 1 mesh executor's images differ from the executor's")
        check_images(list(served["mesh"]), (512, 512, 3), "(a) served")
        print(f"  (a) BatchingExecutor(mesh=make_mesh(dp=1)): a burst of {len(DIST_SERVE)} bit for bit "
              f"the executor's without a mesh; launches exact")
    finally:
        dist.destroy_process_group()
    report["a_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()

    # ---- (b) two ranks on the one card over gloo ----
    t0 = time.perf_counter()
    r0, r1 = ranks = run_dist_workers()
    report["b_wall_s"] = time.perf_counter() - t0
    for rk in ranks:
        check(rk["rows"] == 2 and rk["adapters_equal_rank0"],
              f"(b) rank {rk['rank']}: adapters differ from rank 0's")
        check(counter_of(rk["step_launches"]) == sd15_step_launches(1),
              f"(b) rank {rk['rank']} step launches {rk['step_launches']}")
        check(counter_of(rk["serve_launches"]) == serve_launches_per_batch(),
              f"(b) rank {rk['rank']} served launches {rk['serve_launches']}")
        check(all(math.isfinite(v) for v in rk["metrics"].values()), f"(b) metrics {rk['metrics']}")
        launches[1] += counter_of(rk["step_launches"])
        launches[len(DIST_SERVE) // 2] += counter_of(rk["serve_launches"])
    check(r0["metrics"] == r1["metrics"], "(b) the ranks' logged metrics differ")
    check(r0["serve_stats"]["batches"] == 1 and r1["served_batches"] == 1,
          f"(b) served batches {r0['serve_stats']} / {r1['served_batches']}")
    check(r0["served_finite_01"] and r0["served_bit_for_bit"],
          f"(b) served rows differ from the ranks' direct generates by {r0['served_max_abs_diff']}")
    print(f"distribution (b): two ranks on one card over gloo: adapters bit for bit on both ranks; "
          f"update vs the one-process step at batch {TRAIN_BATCH}: relative L2 {r0['update_rel_l2']:.3e} "
          f"(tol {DIST_STEP_TOL}), same-sign moves {r0['same_sign_moves']:.4f}, gradients (Adam's mu) "
          f"relative L2 {r0['mu_rel_l2']:.3e} (tol {DIST_GRAD_TOL}); metric relative differences "
          + ", ".join(f"{k} {v:.2e}" for k, v in sorted(r0["metric_rel"].items()))
          + f" (tol {DIST_METRIC_TOL})")
    print(f"  (b) dp = 2 served burst of {len(DIST_SERVE)}: each row bit for bit its rank's direct "
          f"generate at batch {len(DIST_SERVE) // 2}; launches exact on both ranks; step s "
          f"{r0['step_s']:.2f} / {r1['step_s']:.2f} (one student's gradient all_reduce over gloo "
          f"alone {r0['allreduce_one_student_s']:.2f}), serve s {r0['serve_s']:.2f}, peak GiB "
          f"{r0['peak_gib']:.2f} / {r1['peak_gib']:.2f}, rank wall s {r0['wall_s']:.1f} / {r1['wall_s']:.1f}")
    check(r0["update_rel_l2"] <= DIST_STEP_TOL and r0["mu_rel_l2"] <= DIST_GRAD_TOL
          and max(r0["metric_rel"].values()) <= DIST_METRIC_TOL,
          f"(b) two-rank step off: update {r0['update_rel_l2']} (tol {DIST_STEP_TOL}), gradients "
          f"{r0['mu_rel_l2']} (tol {DIST_GRAD_TOL}), metrics {r0['metric_rel']} (tol {DIST_METRIC_TOL})")
    keys = ("step_s", "allreduce_one_student_s", "serve_s", "peak_gib", "wall_s")
    report["b"] = {k: r0[k] for k in ("update_rel_l2", "same_sign_moves", "mu_rel_l2", "metric_rel")
                   + keys}
    report["b"]["rank1"] = {k: r1[k] for k in keys}

    # ---- (c) the train CLI under torchrun, one process, NCCL ----
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "1",
             "--master_port", str(free_port()), "-m", "invertible_cd_tpu_torch.cli.train_icd",
             "--model", "sd15", "--synthetic_data", "--fsdp", "1", "--batch_size", str(TRAIN_BATCH),
             "--max_steps", "1", "--validation_steps", "0", "--output_dir", out_dir],
            cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
            timeout=DIST_WORKER_TIMEOUT)
        report["c_wall_s"] = time.perf_counter() - t0
        check(proc.returncode == 0, f"(c) torchrun train CLI exited {proc.returncode}:\n"
                                    f"{(proc.stdout + proc.stderr)[-4000:]}")
        check(os.path.exists(os.path.join(out_dir, "checkpoints", "1", "state.pt"))
              and sorted(os.listdir(os.path.join(out_dir, "checkpoints"))) == ["1"],
              "(c) the CLI wrote no single checkpoint")
        check(os.path.exists(os.path.join(out_dir, "export_1", "unet_lora", "lora_weights.safetensors"))
              and os.path.exists(os.path.join(out_dir, "export_1", "forward_unet_lora",
                                              "lora_weights.safetensors")),
              "(c) the CLI wrote no export")
        resident = [line for line in proc.stdout.splitlines() if line.startswith("resident base")]
        check(len(resident) == 1, f"(c) resident bytes not printed once: {proc.stdout[-2000:]}")
        report["c_resident_base_gib"] = int(resident[0].split()[3]) / 2**30
    print(f"  (c) torchrun --nproc_per_node 1 train CLI (--fsdp 1, NCCL), 1 step at batch "
          f"{TRAIN_BATCH}: exit 0, one checkpoint and one export, {resident[0]}; "
          f"{report['c_wall_s']:.1f} s")

    # ---- (d) the phase ----
    report["peak_gib_this_process"] = torch.cuda.max_memory_allocated() / 2**30
    report["phase_s"] = time.perf_counter() - t_phase
    report["launches"] = {str(b): {k[0]: 0 for k in c} for b, c in launches.items()}
    for b, c in launches.items():
        for k, n in c.items():
            report["launches"][str(b)][k[0]] += n
    print(json.dumps(report))
    return launches



# ---- phase 5e: sp and tp over two ranks sharing the card ----
# Gates, relative L2 against the one-process run of the same inputs on the
# same card (bf16): the served images at sp = 2 (halo convolutions, GroupNorm's
# sums over the pair, K and V gathered: other kernel shapes and summation
# orders, so other roundings), and at tp = 2 one UNet call's output and the
# images of a generate (each rank half the heads and FF features; the
# partial products, each rounded to bf16, summed in fp32 over the pair); and
# at sp = 2 one UNet call on a latent ramped 0.5x-3x top to bottom, whose
# halves differ (seeded weights make stationary features, under which a
# GroupNorm of half the rows, or attention to half the keys, stays close to
# the whole's). On an H100 80GB HBM3 at 700 W the clean runs read 1.42e-2
# (sp UNet call), 4.65e-3 (sp images, batch 1 and 2), 1.41e-2 (tp UNet call)
# and 4.66e-3 (tp images). With one exchange taken out (`--sp-fault`) the sp
# UNet call read 0.194 (halo), 0.365 (GroupNorm) and 0.211 (K/V gather), the
# sp images 7.0e-2, 8.6e-3 and 1.09e-2: the images gate catches a lost halo
# only. The UNet gates are UNET_REL_TOL, the gate of the same UNet's kernel
# path against its materialised path.
SP_IMAGE_TOL = 1e-2
SP_UNET_TOL = 5e-2
TP_UNET_TOL = 5e-2
TP_IMAGE_TOL = 1e-2
SP_SERVE = [("a photo of a corgi on the beach", 7), ("a red fox", 2**40 + 3)]
SPTP_BATCH = 2  # tp's UNet call and generate


def sp_generate_launches(sp: int = 2) -> collections.Counter:
    """B1 and B2 launches of one SD1.5 generate on one rank at sp: each
    self layer's queries of the rank's rows against the whole height's keys,
    each cross layer at the rank's rows, 4 hops; the decode's mid-block head
    once."""
    want = collections.Counter()
    for tokens, layers in LAYERS_PER_CALL.items():
        for sk in (tokens, 77):
            want[("flash_fwd", tokens // sp, sk, HEAD_DIM[tokens])] = 4 * layers
    want[("flash_fwd_streamed", 4096 // sp, 4096, 512)] = 1
    return want


def unet_call_launches() -> collections.Counter:
    """B1 launches of one SD1.5 UNet call (one process, or one tp rank:
    the same shapes at half the heads)."""
    return collections.Counter({k: n // 4 for k, n in serve_launches_per_batch().items()
                                if k[0] == "flash_fwd"})


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm()).item()


def plant_sp_fault(fault: str):
    """Take one of sp's exchanges out of this process: "halo" pads a
    rank's rows with zeros instead of its neighbours' rows, "gn" takes
    GroupNorm's statistics of the rank's rows alone, "kv" attends to the
    rank's own K and V."""
    from invertible_cd_tpu_torch.models import attention
    from invertible_cd_tpu_torch.parallel import spatial

    if fault == "halo":
        def no_halo(x, mesh, above=1, below=1):
            import torch

            zeros = lambda n: x.new_zeros(x.shape[:2] + (n, x.shape[3]))  # noqa: E731
            return torch.cat([zeros(above), x, zeros(below)], dim=2)
        spatial.halo = no_halo
    elif fault == "gn":
        def local_moments(grouped, mesh):
            mean = grouped.mean(-1)
            return mean, (grouped.square().mean(-1) - mean.square()).clamp_min(0.0)
        spatial.group_moments = local_moments
    elif fault == "kv":
        attention.gather_kv = lambda k, v, mesh: (k, v)
        import invertible_cd_tpu_torch.models.vae as vae

        vae.gather_kv = attention.gather_kv


def plant_tp_fault():
    """Take `to_tp`'s backward sum out of this process: each rank keeps its
    own heads' and features' part of a split block's input gradient."""
    from invertible_cd_tpu_torch.parallel import mesh

    mesh._ToTP.backward = staticmethod(lambda ctx, grad: (grad, None))


def sptp_train(pipe, tp, fsdp) -> dict:
    """Phase 5e's train steps on the seeded bundle's UNet (whole), from
    phase 5d's state, batch and draws (`dist_train_setup`): rank 0 first
    takes the one-process step at TRAIN_BATCH (the reference); then (i) the
    step over `tp` (both ranks the whole batch, each half of every split
    block) and (ii), unless `fsdp` is None, over `fsdp` (one row a rank,
    one UNet unit gathered at a time). Counts reset just before each step
    and read just after. Each step's record: its readings against the
    reference (rank 0), its launches, both ranks' adapters and first
    moments bit for bit, and its peak memory above what the rank held
    before it; under fsdp also the store's peak of gathered bytes and of
    units alive at once, its largest unit of one dict (base or teacher),
    the whole weights, and the peak of gathering them whole
    (`step_fn.gather()`, measured here)."""
    import torch
    import torch.distributed as dist

    from invertible_cd_tpu_torch.ops import flash_attention as fa
    from invertible_cd_tpu_torch.parallel import shard_batch
    from invertible_cd_tpu_torch.training import make_train_step

    unet, base, teacher, solver, tcfg, state, batch = dist_train_setup(pipe)
    out, ref = {}, None
    if dist.get_rank() == 0:
        ref_state, ref_metrics = make_train_step(unet, base, teacher, solver, pipe.schedule, tcfg)(
            state, batch, dist_step_generator())
        ref = (adapters_flat(ref_state), adapters_flat(ref_state, "mu"),
               {k: float(v) for k, v in ref_metrics.items()})
        del ref_state, ref_metrics
        torch.cuda.empty_cache()
    old = adapters_flat(state)
    for name, mesh in (("tp", tp), ("fsdp", fsdp)):
        if mesh is None:
            continue
        step_fn = make_train_step(unet, base, teacher, solver, pipe.schedule, tcfg, mesh)
        store = step_fn.weights
        rec = {"resident_gib": step_fn.resident_bytes() / 2**30, "rows": mesh.rows}
        dist.barrier()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        if store is not None:
            store.reset_peak()
        fa.reset_launch_counts()
        new, metrics = step_fn(state, shard_batch(batch, mesh), dist_step_generator())
        torch.cuda.synchronize()
        rec["launches"] = [[list(k), n] for k, n in fa.LAUNCH_SHAPES.items()]
        # ---------------------------------------------------------------------
        rec["peak_above_gib"] = (torch.cuda.max_memory_allocated() - before) / 2**30
        rec["metrics"] = {k: float(v) for k, v in metrics.items()}
        mine, mu = adapters_flat(new), adapters_flat(new, "mu")
        theirs, mu0 = mine.clone(), mu.clone()
        dist.broadcast(theirs, src=0)  # gloo broadcasts CUDA tensors
        dist.broadcast(mu0, src=0)
        rec["equal_rank0"] = bool(torch.equal(mine, theirs) and torch.equal(mu, mu0))
        if ref is not None:
            d_got, d_ref = mine - old, ref[0] - old
            rec["update_rel_l2"] = ((d_got - d_ref).norm() / d_ref.norm()).item()
            rec["same_sign_moves"] = (torch.sign(d_got) == torch.sign(d_ref)).float().mean().item()
            rec["mu_rel_l2"] = ((mu - ref[1]).norm() / ref[1].norm()).item()
            rec["metric_rel"] = {k: abs(rec["metrics"][k] - v) / max(abs(v), 1e-12)
                                 for k, v in ref[2].items()}
        if store is not None:
            rec.update(gathered_peak_gib=store.peak_bytes / 2**30, live_after=store.live_bytes,
                       units_peak=store.peak_units,
                       unit_max_gib=max(store.gathered_bytes(k, dicts=(i,))
                                        for k in step_fn.units.values() for i in (0, 1)) / 2**30,
                       whole_gib=sum(store.whole_bytes.values()) / 2**30)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            whole = step_fn.gather()
            torch.cuda.synchronize()
            rec["whole_gather_above_gib"] = (torch.cuda.max_memory_allocated() - before) / 2**30
            del whole
        out[name] = rec
        del new, metrics, step_fn, store, mine, mu, theirs, mu0
        torch.cuda.empty_cache()
    return out


def sptp_worker(rank: int, port: int, out_dir: str, fault=None, tp_fault=None) -> int:
    """One of phase 5e's two ranks on the one card, over gloo, on the
    seeded SD1.5 bundle (with `fault`, under `plant_sp_fault`): this rank's
    one-process generates of SP_SERVE's first 1 and 2 requests (the
    references, and its peak memory at sp = 1); one UNet call at batch 2 on
    a ramped latent, one process and at sp = 2; a served lone request, then
    a served burst of two, at dp = 1 x sp = 2 (rank 0 the executor, rank 1
    the follower; counts reset just before each and read just after, with
    the peak); the train steps at tp = 2 and fsdp = 2 (`sptp_train`); then
    the UNet split over tp = 2: the UNet call and one generate at batch 2
    against the one-process ones. With `tp_fault` (under `plant_tp_fault`)
    only the tp = 2 train step runs. Writes `sptp_rank<r>.json` (and the
    served images, rank 0)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from invertible_cd_tpu_torch.ops import flash_attention as fa
    from invertible_cd_tpu_torch.parallel import gather_rows, initialize_distributed, latent_rows, make_mesh
    from invertible_cd_tpu_torch.parallel.spatial import spatial
    from invertible_cd_tpu_torch.parallel.tp import tensor_parallel
    from invertible_cd_tpu_torch.pipelines.pipeline import InvertibleCD
    from invertible_cd_tpu_torch.serving import BatchingExecutor, request_latents, serve_follower

    t_start = time.perf_counter()
    if fault:
        plant_sp_fault(fault)
    if tp_fault:
        plant_tp_fault()
    torch.cuda.set_device(0)
    initialize_distributed(f"localhost:{port}", 2, rank, backend="gloo", device="cuda:0")
    sp = make_mesh(sp=2, device="cuda")
    tp = make_mesh(tp=2, device="cuda")
    fsdp = make_mesh(fsdp=2, device="cuda")
    pipe = InvertibleCD.sd15(device="cuda", dtype=torch.bfloat16, seed=0)
    out = {"rank": rank, "sp_coord": sp.coordinate("sp"), "tp_coord": tp.coordinate("tp")}
    if tp_fault:
        out["train"] = sptp_train(pipe, tp, None)
        with open(os.path.join(out_dir, f"sptp_rank{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.barrier()
        dist.destroy_process_group()
        return 0
    prompts = [p for p, _ in SP_SERVE]
    seeds = [s for _, s in SP_SERVE]

    # ---- the one-process references, and the peak at sp = 1 ----
    ref, out["peak_gib"] = {}, {"sp1": {}, "sp2": {}}
    for b in (1, 2):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ref[b] = pipe.generate(prompts[:b], latent=request_latents(pipe, seeds[:b]))[0]
        torch.cuda.synchronize()
        out["peak_gib"]["sp1"][str(b)] = (torch.cuda.max_memory_allocated() - base) / 2**30
    out["resident_gib"] = torch.cuda.memory_allocated() / 2**30

    # ---- one UNet call at batch 2, one process, then at sp = 2 ----
    # the latent's rows grow from 0.5 to 3 times N(0, 1) top to bottom, so the
    # two halves' statistics differ (seeded weights make stationary features,
    # under which a GroupNorm of half the rows or attention to half the keys
    # stays close to the whole's)
    gen = torch.Generator(device="cuda").manual_seed(31)
    unet = pipe.unets["reverse"]
    ramp = torch.linspace(0.5, 3.0, 64, device="cuda").view(1, 1, 64, 1)
    lat = torch.randn((SPTP_BATCH, 4, 64, 64), generator=gen, device="cuda") * ramp
    ctx = torch.randn((SPTP_BATCH, 77, 768), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((SPTP_BATCH, unet.cfg.time_cond_proj_dim), generator=gen, device="cuda")
    with torch.inference_mode():
        unet_ref = unet(lat, 519, ctx, w_cond=w)
        dist.barrier()
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        with spatial(sp):
            rows = unet(latent_rows(lat, sp), 519, ctx, w_cond=w)
        torch.cuda.synchronize()
        out["sp_unet_launches"] = [[list(k), n] for k, n in fa.LAUNCH_SHAPES.items()]
        # ---------------------------------------------------------------------
        out["sp_unet_rows"] = list(rows.shape)
        out["sp_unet_rel_l2"] = rel_l2(gather_rows(rows, sp), unet_ref)
    del rows

    # ---- served at sp = 2: a lone request, then a burst of two ----
    out["serve"] = {}
    for b in (1, 2):
        dist.barrier()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        if rank == 0:
            with BatchingExecutor(pipe, batch_size=b, max_delay=1.0, mesh=sp) as ex:
                futs = [ex.submit(p, seed=s) for p, s in SP_SERVE[:b]]
                served = np.stack([f.result(timeout=600) for f in futs])
                stats = ex.stats()
        else:
            stats = {"batches": serve_follower(pipe, sp)}
        torch.cuda.synchronize()
        rec = {"s": time.perf_counter() - t0, "stats": stats,
               "launches": [[list(k), n] for k, n in fa.LAUNCH_SHAPES.items()]}
        # -------------------------------------------------------------------
        out["peak_gib"]["sp2"][str(b)] = (torch.cuda.max_memory_allocated() - base) / 2**30
        if rank == 0:
            got = torch.from_numpy(served)
            want = ref[b].cpu()
            rec.update(rel_l2=rel_l2(got, want), max_abs=(got - want).abs().max().item(),
                       finite_01=bool(torch.isfinite(got).all() and got.min() >= 0 and got.max() <= 1),
                       shape=list(got.shape))
        out["serve"][str(b)] = rec

    # ---- the train steps at tp = 2 and fsdp = 2, on the whole UNet ----
    out["train"] = sptp_train(pipe, tp, fsdp)

    # ---- tp = 2: the UNet call and one generate at batch 2 ----
    tp_latent = request_latents(pipe, seeds[:SPTP_BATCH])
    tensor_parallel(unet, tp)
    dist.barrier()
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.inference_mode():
        unet_tp = unet(lat, 519, ctx, w_cond=w)
    torch.cuda.synchronize()
    out["tp_unet_s"] = time.perf_counter() - t0
    out["tp_unet_launches"] = [[list(k), n] for k, n in fa.LAUNCH_SHAPES.items()]
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    tp_images = pipe.generate(prompts[:SPTP_BATCH], latent=tp_latent)[0]
    torch.cuda.synchronize()
    out["tp_generate_s"] = time.perf_counter() - t0
    out["tp_generate_launches"] = [[list(k), n] for k, n in fa.LAUNCH_SHAPES.items()]
    # -----------------------------------------------------------------------
    out["tp_unet_rel_l2"] = rel_l2(unet_tp, unet_ref)
    out["tp_unet_finite"] = bool(torch.isfinite(unet_tp).all())
    out["tp_images_rel_l2"] = rel_l2(tp_images, ref[SPTP_BATCH])
    out["tp_images_finite_01"] = bool(torch.isfinite(tp_images).all() and tp_images.min() >= 0
                                      and tp_images.max() <= 1)
    out["tp_heads"] = sorted({m.heads for m in unet.modules()  # the split attention blocks'
                              if getattr(m, "tp_mesh", None) is not None and hasattr(m, "heads")})
    out["wall_s"] = time.perf_counter() - t_start
    with open(os.path.join(out_dir, f"sptp_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_sp_fault(fault: str):
    """`--sp-fault`: phase 5e's two ranks with one of sp's exchanges taken
    out (`plant_sp_fault`), to show what the gates read under the fault;
    prints rank 0's readings, checks nothing."""
    r0, r1 = run_dist_workers(job="sptp", fault=fault)
    print(json.dumps({"sp_fault": fault, "tolerances": {"sp_images": SP_IMAGE_TOL, "sp_unet": SP_UNET_TOL},
                      "sp_unet_rel_l2": [r0["sp_unet_rel_l2"], r1["sp_unet_rel_l2"]],
                      "sp_images_rel_l2": {b: r0["serve"][b]["rel_l2"] for b in r0["serve"]},
                      "sp_images_max_abs": {b: r0["serve"][b]["max_abs"] for b in r0["serve"]}}))


def phase_sp_tp(card: str):
    """Phase 5e: sp and tp (`parallel.spatial`, `parallel.tp`) over two
    ranks sharing the card over gloo (NCCL refuses two ranks on one device).
    Returns ({batch: launches} of both ranks' served sp runs, the tp
    phase's B2 and the fsdp train step's B1, B3 and B4 (batch 1), the tp
    phase's launches at half the heads, batch 2: its UNet call's and
    generate's B1 and its train step's B1, B3 and B4)."""
    t_phase = time.perf_counter()
    report = {"phase": "5e sp and tp", "card": card}
    r0, r1 = ranks = run_dist_workers(job="sptp")
    report["workers_wall_s"] = time.perf_counter() - t_phase
    launches = collections.defaultdict(collections.Counter)
    tp_split = collections.Counter()
    want_tp = unet_call_launches() + serve_launches_per_batch()
    for rk in ranks:
        r = rk["rank"]
        check((rk["sp_coord"], rk["tp_coord"]) == (r, r), f"rank {r}: mesh coordinates")
        for name, t in rk["train"].items():  # (i) tp = 2 and (ii) fsdp = 2
            got = counter_of(t["launches"])
            check(got == sd15_step_launches(1), f"rank {r}: {name} step launches {dict(got)}")
            if name == "tp":
                tp_split += got
            else:
                launches[TRAIN_BATCH // t["rows"]] += got
            check(t["equal_rank0"], f"rank {r}: {name} step's adapters differ from rank 0's")
            check(all(math.isfinite(v) for v in t["metrics"].values()), f"rank {r}: {name} metrics")
        f = rk["train"]["fsdp"]
        check(f["live_after"] == 0 and f["units_peak"] == 1
              and 0 < f["gathered_peak_gib"] <= f["unit_max_gib"]
              and f["resident_gib"] + f["gathered_peak_gib"] < f["whole_gib"],
              f"rank {r}: fsdp step's gathered weights {f}: more than one unit alive, above the whole "
              f"weights, or left alive")
        for b in ("1", "2"):
            got = counter_of(rk["serve"][b]["launches"])
            check(got == sp_generate_launches(), f"rank {r}: served batch {b} launches {dict(got)}")
            launches[int(b)] += got
        check(rk["peak_gib"]["sp2"]["2"] < rk["peak_gib"]["sp1"]["2"],
              f"rank {r}: peak above its resident bytes at sp = 2 {rk['peak_gib']} not below sp = 1's")
        got = counter_of(rk["tp_unet_launches"]) + counter_of(rk["tp_generate_launches"])
        check(got == want_tp, f"rank {r}: tp launches {dict(got)}")
        for k, n in got.items():
            (tp_split if k[0] == "flash_fwd" else launches[SPTP_BATCH])[k] += n
        got = counter_of(rk["sp_unet_launches"])
        check(got == collections.Counter({k: n // 4 for k, n in sp_generate_launches().items()
                                          if k[0] == "flash_fwd"}), f"rank {r}: sp UNet launches {dict(got)}")
        launches[SPTP_BATCH] += got
        check(rk["sp_unet_rows"] == [SPTP_BATCH, 4, 32, 64], f"rank {r}: sp rows {rk['sp_unet_rows']}")
        check(rk["sp_unet_rel_l2"] <= SP_UNET_TOL,
              f"rank {r}: sp = 2 UNet call relative L2 {rk['sp_unet_rel_l2']} (tol {SP_UNET_TOL})")
        check(rk["tp_heads"] == [4], f"rank {r}: tp heads {rk['tp_heads']}")
        check(rk["tp_unet_finite"] and rk["tp_images_finite_01"], f"rank {r}: tp output not finite")
        check(rk["tp_unet_rel_l2"] <= TP_UNET_TOL and rk["tp_images_rel_l2"] <= TP_IMAGE_TOL,
              f"rank {r}: tp off: UNet {rk['tp_unet_rel_l2']} (tol {TP_UNET_TOL}), images "
              f"{rk['tp_images_rel_l2']} (tol {TP_IMAGE_TOL})")
    for name in ("tp", "fsdp"):
        t = r0["train"][name]
        check(t["metrics"] == r1["train"][name]["metrics"], f"{name} step: the ranks' metrics differ")
        check(t["update_rel_l2"] <= DIST_STEP_TOL and t["mu_rel_l2"] <= DIST_GRAD_TOL
              and max(t["metric_rel"].values()) <= DIST_METRIC_TOL,
              f"{name} = 2 step off the one-process step: update {t['update_rel_l2']} (tol "
              f"{DIST_STEP_TOL}), gradients {t['mu_rel_l2']} (tol {DIST_GRAD_TOL}), metrics "
              f"{t['metric_rel']} (tol {DIST_METRIC_TOL})")
    for b in ("1", "2"):
        s = r0["serve"][b]
        check(s["stats"]["batches"] == 1 and r1["serve"][b]["stats"]["batches"] == 1,
              f"served batch {b}: stats {s['stats']} / {r1['serve'][b]['stats']}")
        check(s["finite_01"] and s["shape"] == [int(b), 512, 512, 3], f"served batch {b}: {s['shape']}")
        check(s["rel_l2"] <= SP_IMAGE_TOL,
              f"sp = 2 served batch {b}: relative L2 {s['rel_l2']} to the one-process generate "
              f"(tol {SP_IMAGE_TOL})")
    report["sp"] = {b: {k: r0["serve"][b][k] for k in ("rel_l2", "max_abs", "s")} for b in r0["serve"]}
    report["sp_unet_rel_l2"] = [rk["sp_unet_rel_l2"] for rk in ranks]
    report["peak_gib"] = {f"rank{rk['rank']}": rk["peak_gib"] for rk in ranks}
    report["resident_gib"] = [rk["resident_gib"] for rk in ranks]
    report["tp"] = {k: [rk[k] for rk in ranks] for k in ("tp_unet_rel_l2", "tp_images_rel_l2",
                                                          "tp_unet_s", "tp_generate_s")}
    report["rank_wall_s"] = [rk["wall_s"] for rk in ranks]
    report["train"] = {f"rank{rk['rank']}": rk["train"] for rk in ranks}
    for rk in report["train"].values():
        for t in rk.values():
            t.pop("launches")
    for name, what in (("tp", "(i) tp = 2, both ranks the whole batch"),
                       ("fsdp", "(ii) fsdp = 2, one row a rank, one unit gathered at a time")):
        t = r0["train"][name]
        print(f"train step {what}, batch {TRAIN_BATCH}, against the one-process step ({card}): update "
              f"relative L2 {t['update_rel_l2']:.3e} (tol {DIST_STEP_TOL}), same-sign moves "
              f"{t['same_sign_moves']:.4f}, gradients (Adam's mu) {t['mu_rel_l2']:.3e} (tol "
              f"{DIST_GRAD_TOL}), metrics " + ", ".join(f"{k} {v:.2e}" for k, v in
                                                          sorted(t["metric_rel"].items()))
              + f" (tol {DIST_METRIC_TOL}); adapters bit for bit on both ranks; launches exact")
    for rk in ranks:
        f = rk["train"]["fsdp"]
        print(f"  (ii) rank {rk['rank']}: resident base and teacher {f['resident_gib']:.3f} GiB, "
              f"gathered at most {f['gathered_peak_gib']:.3f} GiB of {f['units_peak']} unit at once "
              f"(largest unit of base or teacher {f['unit_max_gib']:.3f}; whole weights "
              f"{f['whole_gib']:.3f}); "
              f"max_memory_allocated above what the rank held: the step {f['peak_above_gib']:.3f} GiB, "
              f"gathering the weights whole {f['whole_gather_above_gib']:.3f} GiB ({card})")
    print(f"sp and tp (two ranks on one card over gloo, {card}): sp = 2 UNet call at batch "
          f"{SPTP_BATCH}, relative L2 to the one-process call {r0['sp_unet_rel_l2']:.3e} / "
          f"{r1['sp_unet_rel_l2']:.3e} (tol {SP_UNET_TOL}); served at dp 1 x sp 2, relative L2 to "
          f"the one-process generate: batch 1 {r0['serve']['1']['rel_l2']:.3e}, batch 2 "
          f"{r0['serve']['2']['rel_l2']:.3e} (tol {SP_IMAGE_TOL}); tp = 2: UNet call "
          f"{r0['tp_unet_rel_l2']:.3e} / {r1['tp_unet_rel_l2']:.3e} (tol {TP_UNET_TOL}), generate "
          f"{r0['tp_images_rel_l2']:.3e} / {r1['tp_images_rel_l2']:.3e} (tol {TP_IMAGE_TOL}); "
          f"peak GiB above resident, rank 0 sp 1 / sp 2: {r0['peak_gib']}; launches exact")
    report["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps(report))
    return launches, tp_split

# ---- phase 5c: eval and metrics ----
SCORER_SEED = 5
SCORER_TOL = 1e-3  # relative L2, each scorer's output on the card vs the CPU, fp32 both
EVAL_HOOKS = ("fid", "inversion", "validation", "inversion_panels")  # train_icd.Eval's
FID_TOL = 1e-2  # |FID| of a set against itself, and of the up = 0 student against the teacher
EVAL_IMAGES = 8  # the FID sets: seeded images, and the prompts of one FID sweep (its batch: 8)
EVAL_LATENTS = 4  # eval_inversion's seeded latents (one chunk)
FID_PROMPTS = "benchmarks/generation_coco_standin.csv"
EVAL_CLI_FLAGS = [  # the eval of the train CLI, all at its last step
    "--validation_steps", str(TRAIN_STEPS), "--validation_prompts_max", "1",
    "--validation_batch", "2", "--inversion_validation_samples", "2",
    "--inversion_eval_steps", str(TRAIN_STEPS), "--inversion_eval_samples", "4",
    "--evaluation_steps", str(TRAIN_STEPS), "--fid_num_samples", str(EVAL_IMAGES),
    "--fid_prompts", FID_PROMPTS]
SCORER_FLAGS = ("inception_weights", "clip_vision_weights", "clip_text_scorer_weights",
                "dino_weights", "vgg_weights", "lpips_heads_weights", "image_reward_weights",
                "bert_vocab")


def scorer_outputs(ev, fid, images01, images_u8, prompts):
    """Each scorer's output on the same inputs, as fp32 CPU tensors: the
    FID-Inception features, the unit CLIP image and text features, the unit
    DINOv2 features, LPIPS per pair (images vs their flip) and ImageReward
    per image."""
    import numpy as np
    import torch

    from invertible_cd_tpu_torch.metrics.resize import resize

    flipped = np.ascontiguousarray(images01[:, :, ::-1])
    with torch.inference_mode():
        dev = next(ev.lpips.parameters()).device
        a, b = (resize(torch.from_numpy(x).to(dev).permute(0, 3, 1, 2), (224, 224), "bilinear")
                for x in (images01, flipped))
        lpips = ev.lpips(a * 2 - 1, b * 2 - 1)
    out = {"inception": torch.from_numpy(fid.features(images_u8)),
           "clip_image": ev.clip_image_features(images01), "clip_text": ev.clip_text_features(prompts),
           "dino": ev.dino_features(images01), "lpips": lpips,
           "image_reward": torch.from_numpy(ev.image_reward_fn(images01, prompts))}
    return {k: v.float().cpu() for k, v in out.items()}


@contextlib.contextmanager
def timed_eval_hooks():
    """Sum the wall time of each call of `train_icd.Eval`'s hooks
    (EVAL_HOOKS; the device synchronised on both sides) into the dict
    yielded, by hook, while the block runs."""
    import torch

    from invertible_cd_tpu_torch.cli import train_icd

    times, saved = collections.Counter(), {name: getattr(train_icd.Eval, name) for name in EVAL_HOOKS}

    def timed(name, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                times[name] += time.perf_counter() - t0
        return call

    for name, fn in saved.items():
        setattr(train_icd.Eval, name, timed(name, fn))
    try:
        yield times
    finally:
        for name, fn in saved.items():
            setattr(train_icd.Eval, name, fn)


def tensorboard_sink() -> bool:
    """Whether `utils.logging.MetricLogger` sends its panels to TensorBoard
    here (it does whenever `torch.utils.tensorboard` imports) rather than
    to PNG files."""
    try:
        import torch.utils.tensorboard  # noqa: F401
    except ImportError:
        return False
    return True


def check_panels(log_dir: str, names, step: int) -> str:
    """The train CLI's eval panels under `log_dir`: PNG files named by tag
    and step, or, on the TensorBoard sink, an event file."""
    if tensorboard_sink():
        events = [f for f in os.listdir(log_dir) if f.startswith("events.out.tfevents")]
        check(events and all(os.path.getsize(os.path.join(log_dir, f)) for f in events),
              f"no TensorBoard events under {log_dir}")
        return f"TensorBoard events {events}"
    samples = sorted(os.listdir(os.path.join(log_dir, "samples")))
    check(len(samples) == len(names) and all(
        f.startswith(n) and f.endswith(f"_{step}.png") for f, n in zip(samples, sorted(names))),
        f"panels {samples}, expected {sorted(names)} at step {step}")
    return f"PNG panels {samples}"


def phase_eval(card: str, pipe):
    """Phase 5c: the metric suite and the training eval at full width, on the
    generate path's SD1.5 bundle. Launch counts are reset just before each
    counted run and read just after; returns the launches per (kernel, Sq,
    Sk, d) by the batch each kernel ran at, and the train CLI's step
    launches (batch TRAIN_BATCH) apart."""
    import tempfile

    import numpy as np
    import torch
    from PIL import Image

    from invertible_cd_tpu_torch import testing
    from invertible_cd_tpu_torch.cli import edit as edit_cli
    from invertible_cd_tpu_torch.cli import train_icd
    from invertible_cd_tpu_torch.data import load_benchmark
    from invertible_cd_tpu_torch.edit import make_controller
    from invertible_cd_tpu_torch.metrics import FIDScorer
    from invertible_cd_tpu_torch.metrics.scores import evaluators_from_weights
    from invertible_cd_tpu_torch.models.convert import convert_inception_weights, load_torch_file
    from invertible_cd_tpu_torch.models.lora import init_lora
    from invertible_cd_tpu_torch.ops import flash_attention as fa
    from invertible_cd_tpu_torch.training.eval import (
        eval_inversion, fid_of_student, forward_sample, reverse_sample, sample_for_fid)

    cfg, side = pipe.unets["reverse"].cfg, pipe.latent_size[0]
    n_hops = pipe.grid.num_reverse_steps
    pix = side * 2 ** (len(pipe.vae.cfg.block_out_channels) - 1)
    per_call = unet_launches_per_call(cfg, side)
    vae = collections.Counter({("flash_fwd_streamed", side * side, side * side,
                                pipe.vae.cfg.block_out_channels[-1]): 1})

    def calls(k, decodes=0):  # k UNet calls and `decodes` VAE decodes
        return collections.Counter({key: k * c for key, c in per_call.items()}) + collections.Counter(
            {key: decodes * c for key, c in vae.items()})

    def counted():
        return collections.Counter(fa.LAUNCH_SHAPES)

    def totals(counter):
        return {name: sum(c for key, c in counter.items() if key[0] == name)
                for name in fa.KERNELS if any(key[0] == name for key in counter)}

    def rel_l2(a, b):
        return ((a - b).norm() / b.norm()).item()

    by_batch = collections.defaultdict(collections.Counter)
    report = {"phase": "5c eval", "card": card}
    rng = np.random.default_rng(61)
    images_u8 = rng.integers(0, 256, (EVAL_IMAGES, pix, pix, 3), dtype=np.uint8)
    images01 = images_u8.astype(np.float32) / 255.0
    prompts = load_benchmark(FID_PROMPTS, kind="generation", max_count=EVAL_IMAGES)
    with tempfile.TemporaryDirectory() as tmp:
        # ---- 1. full-width scorers from seeded files in the published formats ----
        t0 = time.perf_counter()
        paths = testing.write_scorer_files(tmp, tiny=False, seed=SCORER_SEED, device="cuda")
        files_s = time.perf_counter() - t0
        flags = [f"--{flag}={paths[flag]}" for flag in SCORER_FLAGS]
        loaders = dict(clip_vision_path=paths["clip_vision_weights"],
                       clip_text_path=paths["clip_text_scorer_weights"],
                       dino_path=paths["dino_weights"], vgg_path=paths["vgg_weights"],
                       lpips_heads_path=paths["lpips_heads_weights"],
                       image_reward_path=paths["image_reward_weights"],
                       bert_vocab_path=paths["bert_vocab"])
        inception = convert_inception_weights(load_torch_file(paths["inception_weights"]))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ev = evaluators_from_weights(**loaders, device="cuda")
        fid = FIDScorer.from_state_dict(inception, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        ev_cpu = evaluators_from_weights(**loaders, device="cpu")
        fid_cpu = FIDScorer.from_state_dict(inception, device="cpu")
        n_params = {name: sum(p.numel() for p in m.parameters()) for name, m in (
            ("inception", fid.model), ("clip_vision", ev.clip_vision), ("clip_text", ev.clip_text),
            ("dino", ev.dino), ("lpips", ev.lpips))}
        print(f"eval: full-width scorers with seeded weights ({n_params}; ImageReward = BLIP "
              f"ViT-L/16 + BERT-base): published-format files written in {files_s:.1f} s, read "
              f"onto the card in {load_s:.1f} s ({card})")

        # ---- 2. each scorer on the card against the same weights on the CPU, 2 images ----
        # with TF32 allowed for convolutions (PyTorch's default, which the
        # CLIs keep) and matmuls: the scorers turn both off themselves
        # (`metrics.precision.fp32_products`)
        saved_tf32 = torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision()
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        try:
            gpu = scorer_outputs(ev, fid, images01[:2], images_u8[:2], prompts[:2])
        finally:
            torch.backends.cudnn.allow_tf32 = saved_tf32[0]
            torch.set_float32_matmul_precision(saved_tf32[1])
        cpu = scorer_outputs(ev_cpu, fid_cpu, images01[:2], images_u8[:2], prompts[:2])
        errs = {k: rel_l2(gpu[k], cpu[k]) for k in gpu}
        print("  card (TF32 allowed by the caller) vs CPU, fp32 both (relative L2, tol "
              + f"{SCORER_TOL}): " + ", ".join(
                  f"{k} {e:.2e} (|cpu| {cpu[k].norm().item():.3e})" for k, e in errs.items()))
        check(all(math.isfinite(e) and e <= SCORER_TOL for e in errs.values()),
              f"a scorer disagrees card vs CPU: {errs}")
        report["scorer_rel_l2"] = errs
        del ev_cpu, fid_cpu
        ms = {}
        with torch.inference_mode():
            ms["inception_features_8_images"] = cuda_ms(lambda: fid.features(images_u8), per_loop=1)
            x2 = images01[:2]
            for name, fn in (("clip_image", lambda: ev.clip_image_features(x2)),
                             ("clip_text", lambda: ev.clip_text_features(prompts[:2])),
                             ("dino", lambda: ev.dino_features(x2)),
                             ("lpips", lambda: ev.lpips_distance(x2, x2[:, ::-1])),
                             ("image_reward", lambda: ev.image_reward_fn(x2, prompts[:2]))):
                ms[f"{name}_per_image"] = cuda_ms(fn, per_loop=1) / 2

        # ---- 3. FID: a set against itself ----
        self_fid = fid.fid(list(images_u8), reference_images=list(images_u8))
        print(f"  FID of {EVAL_IMAGES} seeded images against themselves: {self_fid:.3e} "
              f"(tol {FID_TOL})")
        check(abs(self_fid) < FID_TOL, f"self-FID {self_fid}")

        # ---- 4. fid_of_student with up = 0 adapters against the teacher's images ----
        zero = init_lora(pipe.unets["teacher"].state_dict(),
                         torch.Generator(device="cuda").manual_seed(62), rank=64)
        check(all(not ab["up"].any() for ab in zero.values()), "an up of the zero adapters is not 0")
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        reference = sample_for_fid(
            lambda batch, g: pipe.generate(list(batch), generator=g, model="teacher")[0],
            prompts, EVAL_IMAGES, seed=0, device="cuda")
        ref_launches = counted()
        fa.reset_launch_counts()
        t1 = time.perf_counter()
        student_fid = fid_of_student(pipe, zero, fid, prompts, batch_size=EVAL_IMAGES,
                                     reference_images=reference)
        torch.cuda.synchronize()
        ms["fid_of_student_8_prompts"] = (time.perf_counter() - t1) * 1e3
        student_launches = counted()
        print(f"  fid_of_student (up = 0 adapters on the teacher, {EVAL_IMAGES} prompts at batch "
              f"{EVAL_IMAGES}) against the teacher's images: FID {student_fid:.3e} (tol {FID_TOL}); "
              f"the reference sweep {(t1 - t0) * 1e3:.0f} ms")
        check(abs(student_fid) < FID_TOL, f"fid_of_student(up=0) {student_fid}")
        check(pipe.unets["reverse"].__class__.__name__ == "UNet2DCondition",
              "fid_of_student did not restore the reverse UNet")
        for label, got in (("reference sweep", ref_launches), ("fid_of_student", student_launches)):
            check(got == calls(n_hops, 1), f"{label}: launches {dict(got)} != {dict(calls(n_hops, 1))}")
            by_batch[EVAL_IMAGES] += got

        # ---- 5. eval_inversion on seeded latents, the bundle's students ----
        g = torch.Generator(device="cuda").manual_seed(63)
        latents = torch.randn((EVAL_LATENTS, side, side, 4), generator=g, device="cuda")
        context = pipe.encode_prompt(prompts[:EVAL_LATENTS])[1]
        g0 = pipe.default_guidance(guidance_scale=0.0)

        def invert_fn(chunk, gen, ctx):
            noise = torch.randn(chunk.shape, generator=gen, device="cuda")
            return forward_sample(pipe._noise_model(pipe.unets["forward"]), chunk, noise, ctx, ctx,
                                  pipe.grid, pipe.schedule, pipe.w_embed_dim)

        def reconstruct_fn(noisy, gen, ctx):
            return reverse_sample(pipe._noise_model(pipe.unets["reverse"]), noisy, ctx, ctx,
                                  pipe.grid, pipe.schedule, g0)

        fa.reset_launch_counts()
        t0 = time.perf_counter()
        with torch.inference_mode():
            inv = eval_inversion(invert_fn, reconstruct_fn, latents, batch_size=EVAL_LATENTS,
                                 decode_fn=lambda z: pipe._decode_latents(z.permute(0, 3, 1, 2)),
                                 scorer=fid, reference_images=reference, val_context=context)
        ms["eval_inversion_4_latents"] = (time.perf_counter() - t0) * 1e3
        inv_launches = counted()
        print(f"  eval_inversion of {EVAL_LATENTS} seeded latents: {inv}")
        check(set(inv) == {"inversion_latent_mse", "inversion_fid"}
              and all(math.isfinite(v) for v in inv.values()), f"eval_inversion {inv}")
        want = calls(2 * n_hops, 1)
        check(inv_launches == want, f"eval_inversion launches {dict(inv_launches)} != {dict(want)}")
        by_batch[EVAL_LATENTS] += inv_launches

        # ---- 6. the scorers launch no kernel of the port ----
        edited01 = np.ascontiguousarray(images01[:1, ::-1])
        fa.reset_launch_counts()
        bundle = ev.calc_all(images01[:1], edited01, [EDIT_SOURCE], [EDIT_TARGET])
        inversion = ev.calc_inversion(images01[:1], edited01)
        scorer_launches = counted()
        print(f"  calc_all {bundle}; calc_inversion {inversion}; launches {dict(scorer_launches)}")
        check(not scorer_launches, f"the scorers launched {dict(scorer_launches)}")
        check(all(v is not None and math.isfinite(v) for v in (*bundle.values(), *inversion.values())),
              "a metric of calc_all / calc_inversion is missing or not finite")
        ms["calc_all_per_pair"] = cuda_ms(
            lambda: ev.calc_all(images01[:1], edited01, [EDIT_SOURCE], [EDIT_TARGET]), per_loop=1)
        report["peak_gib_scorers_resident"] = torch.cuda.max_memory_allocated() / 2**30
        del ev, fid
        torch.cuda.empty_cache()

        # ---- 7. the train CLI with every eval on, at full SD1.5 width, and bare ----
        feats = np.random.default_rng(64).normal(size=(64, 2048))
        stats = os.path.join(tmp, "fid_stats.npz")
        np.savez(stats, mu=feats.mean(0), sigma=np.cov(feats, rowvar=False))
        bare = ["--model", "sd15", "--synthetic_data", "--batch_size", str(TRAIN_BATCH),
                "--max_steps", str(TRAIN_STEPS), "--log_every", "1", "--validation_steps", "0"]
        step_launches = collections.Counter()
        for tokens, layers in LAYERS_PER_CALL.items():
            d = HEAD_DIM[tokens]
            for sk in (tokens, 77):
                step_launches[("flash_fwd", tokens, sk, d)] = 11 * layers * TRAIN_STEPS
                step_launches[("flash_bwd_dq", tokens, sk, d)] = 4 * layers * TRAIN_STEPS
                step_launches[("flash_bwd_dkdv", tokens, sk, d)] = 4 * layers * TRAIN_STEPS
        # the bare three steps in the same warm process, just before: the
        # eval's cost is the difference, and the hooks' own times
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        train_icd.main(bare + ["--output_dir", os.path.join(tmp, "bare")])
        torch.cuda.synchronize()
        bare_s = time.perf_counter() - t0
        bare_launches = counted()
        check(bare_launches == step_launches,
              f"bare train CLI launches {dict(bare_launches)} != {dict(step_launches)}")
        out_dir = os.path.join(tmp, "train")
        argv = bare[:-2] + ["--output_dir", out_dir, "--fid_stats", stats,
                            "--inception_weights", paths["inception_weights"], *EVAL_CLI_FLAGS]
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        with timed_eval_hooks() as hook_s:
            train_icd.main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        cli_launches = counted()
        with open(os.path.join(out_dir, "logs", "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        logged = {k: v for row in rows if row["step"] == TRAIN_STEPS for k, v in row.items()}
        names = ("eval/fid", "eval/inversion_latent_mse", "eval/inversion_fid",
                 "validation_image_std", "inversion_panel_latent_mse")
        print(f"  train CLI with the eval flags ({' '.join(EVAL_CLI_FLAGS)}): {cli_s:.1f} s against "
              f"{bare_s:.1f} s for its three bare steps just before; the eval hooks "
              + ", ".join(f"{k} {v:.2f} s" for k, v in hook_s.items())
              + f" (sum {sum(hook_s.values()):.2f} s); " + ", ".join(f"{k} {logged.get(k)}" for k in names))
        check(all(k in logged and math.isfinite(logged[k]) for k in names),
              f"metrics.jsonl at step {TRAIN_STEPS}: {logged}")
        print("  " + check_panels(os.path.join(out_dir, "logs"), (
            "inversion_sample_0", "inversion_sample_1", "validation_"), TRAIN_STEPS))
        # the eval after step 3: the FID sweep (one generate at batch 8), the
        # inversion eval (round trip + decode at batch 4), the validation panel
        # (a generate at batch 2) and the triptychs (round trip + 3 decodes, batch 2)
        eval_by_batch = {EVAL_IMAGES: calls(n_hops, 1), 4: calls(2 * n_hops, 1),
                         2: calls(n_hops, 1) + calls(2 * n_hops, 3)}
        want = step_launches + sum(eval_by_batch.values(), collections.Counter())
        check(cli_launches == want, f"train CLI launches {dict(cli_launches)} != {dict(want)}")
        for b, c in eval_by_batch.items():
            by_batch[b] += c
        step_launches += bare_launches
        report["train_cli"] = {"wall_s": cli_s, "bare_wall_s": bare_s,
                               "eval_hook_s": dict(hook_s),
                               "metrics": {k: logged[k] for k in names},
                               "launches": totals(cli_launches)}

        # ---- 8. the generate CLI (subprocess) and the edit CLI with --calc_metrics ----
        gen_out = os.path.join(tmp, "generate")
        cmd = [sys.executable, "-m", "invertible_cd_tpu_torch.cli.generate", "--model", "sd15",
               "--prompt", GENERATE_CLI_PROMPTS[0], "--prompt", GENERATE_CLI_PROMPTS[1],
               "--out", gen_out, "--calc_metrics", *flags, f"--fid_stats={stats}"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        gen_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"generate CLI exit {proc.returncode}: {proc.stderr[-3000:]}")
        with open(os.path.join(gen_out, "metrics.json")) as f:
            gen_metrics = json.load(f)
        print(f"  generate CLI --calc_metrics (subprocess, its own seeded bundle): {gen_s:.1f} s, "
              f"metrics.json {gen_metrics}")
        check(set(gen_metrics) == {"clip_score", "image_reward", "n_images", "fid"}
              and all(isinstance(v, (int, float)) and math.isfinite(v) for v in gen_metrics.values()),
              f"generate CLI metrics.json {gen_metrics}")
        image_path = os.path.join(tmp, "in.jpg")
        Image.fromarray(images_u8[0]).save(image_path)
        edit_out = os.path.join(tmp, "edit")
        spec = make_controller([EDIT_SOURCE, EDIT_TARGET], pipe.tokenizer, n_hops,
                               cross_replace_steps=0.6, self_replace_steps=0.4,
                               blend_words=[["corgi"], ["cat"]])[0]
        invert, pair = edit_path_launches(spec, n_hops, per_call, next(iter(vae)))
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        edit_cli.main(["--model", "sd15", "--image", image_path, "--source", EDIT_SOURCE,
                       "--target", EDIT_TARGET, "--out", edit_out, "--calc_metrics", *flags],
                      _pipe=pipe)
        torch.cuda.synchronize()
        edit_s = time.perf_counter() - t0
        edit_launches = counted()
        with open(os.path.join(edit_out, "results.json")) as f:
            edit_metrics = json.load(f)["metrics"]
        print(f"  edit CLI --calc_metrics (main, the bundle): {edit_s:.1f} s, metrics {edit_metrics}")
        check(set(edit_metrics) == {"preservation_clip_image_image", "preservation_dinov2",
                                    "editing_clip_image_text", "editing_image_reward"}
              and all(v is not None and math.isfinite(v) for v in edit_metrics.values()),
              f"edit CLI metrics {edit_metrics}")
        check(edit_launches == invert + pair,
              f"edit CLI launches {dict(edit_launches)} != {dict(invert + pair)}")
        by_batch[1] += invert
        by_batch[2] += pair
    report["generate_cli"] = {"wall_s": gen_s, "metrics": gen_metrics}
    report["edit_cli"] = {"wall_s": edit_s, "metrics": edit_metrics}
    report["ms"] = ms
    report["launches_by_batch"] = {b: totals(c) for b, c in by_batch.items()}
    print("  times (ms; per image where so named): " + ", ".join(f"{k} {v:.2f}" for k, v in ms.items())
          + f"; peak memory with the scorers resident {report['peak_gib_scorers_resident']:.2f} GiB "
            f"({card})")
    print(json.dumps(report))
    return by_batch, step_launches


def xl_step_launches(per_call, steps: int, remat: bool):
    """Kernel launches per (kernel, Sq, Sk, d) of `steps` train steps:
    B1 on every layer of 11 UNet forwards a step (reverse_cd 3: student,
    teacher, the student's no-grad target; reverse_preserve 2: the frozen
    forward hop and the one rollout call, which its own checkpoint computes
    again in backward; forward_cd 3; forward_preserve 2: one frozen reverse
    hop and the student), plus, with remat, the three differentiated student
    calls that the loss does not checkpoint itself computed again in
    backward (a checkpoint inside the rollout's adds no recompute); B3 and B4
    on every layer of the 4 differentiated student calls."""
    forwards, backwards = 11 + (3 if remat else 0), 4
    return nti_path_launches(per_call, per_call, steps * forwards, steps * backwards)


def seeded_image_folder(root: str, n: int, side: int) -> None:
    """`n` seeded side^2 JPEGs (smooth colour fields with noise) and a
    `train.csv` of captions under `root`."""
    import csv

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(41)
    rows = []
    for i in range(n):
        low = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
        field = np.asarray(Image.fromarray(low).resize((side, side), Image.BICUBIC), np.int16)
        pixels = np.clip(field + rng.integers(-12, 13, field.shape), 0, 255).astype(np.uint8)
        Image.fromarray(pixels).save(os.path.join(root, f"{i:03d}.jpg"), quality=90)
        rows.append({"file_name": f"{i:03d}.jpg", "caption": PROMPTS[i % len(PROMPTS)]})
    with open(os.path.join(root, "train.csv"), "w", newline="") as f:
        writer = csv.DictWriter(f, ["file_name", "caption"])
        writer.writeheader()
        writer.writerows(rows)


def phase_xl_training(card: str):
    """Full-depth SDXL training at 1024^2 (phase 5b): the CLI's --data_root
    path with --lazy_lora --remat for XL_TRAIN_STEPS steps; then the same
    step through `make_train_step` on synthetic batches with added
    conditioning (exact launches, base and teacher unchanged, times, peak
    memory, one traced step); one step of the merged path against the lazy
    one from the same state and draws, with both peaks; and the adapter
    gradient of `reverse_cd_loss` through B1 (lse), B3 and B4 at d = 64
    against the materialised path. Returns the launches per (kernel, Sq, Sk,
    d) of the counted CLI steps and direct steps, all at XL_TRAIN_BATCH."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    from invertible_cd_tpu_torch.cli import train_icd
    from invertible_cd_tpu_torch.diffusion.schedule import make_schedule
    from invertible_cd_tpu_torch.diffusion.solver import make_train_solver
    from invertible_cd_tpu_torch.models.attention import AttnMeta
    from invertible_cd_tpu_torch.models.lora import call_with_lora, lora_modules, seeded_lora
    from invertible_cd_tpu_torch.models.unet2d import count_attention_layers
    from invertible_cd_tpu_torch.ops import flash_attention as fa
    from invertible_cd_tpu_torch.training import (
        ICDTrainState, init_train_state, make_train_step, reverse_cd_loss)
    from invertible_cd_tpu_torch.training.checkpoint import load_inference_lora
    from invertible_cd_tpu_torch.training.trainer import init_optimizer

    resolution, b = XL_RESOLUTION, XL_TRAIN_BATCH
    side = resolution // 8
    common = ["--model", "sdxl", "--lazy_lora", "--remat", "--resolution", str(resolution),
              "--batch_size", str(b), "--log_every", "1", "--seed", "0"]
    cfg = train_icd.unet_config("sdxl")
    per_call = unet_launches_per_call(cfg, side)
    check(sum(per_call.values()) == count_attention_layers(cfg) == 140,
          f"{sum(per_call.values())} attention layers per SDXL call")
    want_steps = xl_step_launches(per_call, XL_DIRECT_STEPS, remat=True)
    vae_key = ("flash_fwd_streamed_f32", side * side, side * side, 512)

    # ---- the entry point a user calls: --data_root, the VAE and both encoders ----
    tmp = tempfile.mkdtemp(prefix="icd_xl_train_")
    try:
        free_gb = shutil.disk_usage(tmp).free / 2**30
        print(f"sdxl training: batch {b} (the reference's is 8, configs/train_sdxl_lora.json), "
              f"{XL_TRAIN_STEPS} steps; {free_gb:.1f} GiB free under {tmp}")
        check(free_gb > 12, f"{free_gb:.1f} GiB free: the checkpoint and exports need ~7")
        data = os.path.join(tmp, "data")
        out = os.path.join(tmp, "run")
        os.makedirs(data)
        seeded_image_folder(data, XL_TRAIN_STEPS * b, resolution)
        shutil.copy(os.path.join(data, "train.csv"), os.path.join(data, "val.csv"))
        torch.cuda.reset_peak_memory_stats()
        # ---- the CLI's steps: counts reset just before, read just after ----
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        with timed_eval_hooks() as hook_s:
            last = train_icd.main(common + [
                "--data_root", data, "--max_steps", str(XL_TRAIN_STEPS), "--checkpointing_steps",
                str(XL_TRAIN_STEPS), "--checkpoints_total_limit", "1", "--output_dir", out,
                *XL_EVAL_CLI_FLAGS])
        torch.cuda.synchronize()
        cli_launches = collections.Counter(fa.LAUNCH_SHAPES)
        # --------------------------------------------------------------------
        cli_s = time.perf_counter() - t0
        cli_peak = torch.cuda.max_memory_allocated() / 2**30
        # the eval after the last step, all at batch b: the val set's encode,
        # the inversion eval's round trip (no decode without the FID files),
        # the validation panel (a generate and its decode) and the triptychs
        # (a round trip and 3 decodes), on the training endpoints' grid
        n_hops = len(train_icd.parse_args(common + ["--output_dir", "x"]).endpoints.split(","))
        want_eval = collections.Counter({k: 5 * n_hops * c for k, c in per_call.items()})
        want_eval[vae_key] += 5
        want_cli = (xl_step_launches(per_call, XL_TRAIN_STEPS, remat=True) + want_eval
                    + collections.Counter({vae_key: XL_TRAIN_STEPS * -(-b // 4)}))
        print(f"  cli.train_icd.main --model sdxl --lazy_lora --remat --data_root "
              f"{' '.join(XL_EVAL_CLI_FLAGS)}: {XL_TRAIN_STEPS} steps at batch {b} in {cli_s:.1f} s "
              f"(weights, encoders, encodes, the eval, checkpoint and exports included; the eval "
              f"hooks " + ", ".join(f"{k} {v:.2f} s" for k, v in hook_s.items())
              + f"), peak {cli_peak:.2f} GiB ({card})")
        print(f"  launches: {dict(cli_launches)}")
        check(cli_launches == want_cli, f"CLI launches {dict(cli_launches)} != {dict(want_cli)}")
        check(all(name in last and math.isfinite(last[name]) for name in METRIC_NAMES),
              f"CLI metrics missing or not finite: {last}")
        with open(os.path.join(out, "logs", "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        logged = {k: v for row in rows if row["step"] == XL_TRAIN_STEPS for k, v in row.items()}
        names = ("eval/inversion_latent_mse", "validation_image_std", "inversion_panel_latent_mse")
        print("  the eval at step " + f"{XL_TRAIN_STEPS}: " + ", ".join(
            f"{k} {logged.get(k)}" for k in names) + "; " + check_panels(
            os.path.join(out, "logs"), ("inversion_sample_0", "inversion_sample_1", "validation_"),
            XL_TRAIN_STEPS))
        check(all(k in logged and math.isfinite(logged[k]) for k in names),
              f"metrics.jsonl at step {XL_TRAIN_STEPS}: {logged}")
        saved = torch.load(os.path.join(out, "checkpoints", str(XL_TRAIN_STEPS), "state.pt"),
                           map_location="cpu", weights_only=True)
        for name, student in (("unet_lora", "lora_reverse"), ("forward_unet_lora", "lora_forward")):
            path = os.path.join(out, f"export_{XL_TRAIN_STEPS}", name, "lora_weights.safetensors")
            adapters, alphas = load_inference_lora(path)
            check(adapters.keys() == saved[student].keys() and set(alphas.values()) == {8.0}
                  and all(torch.equal(adapters[k][n], saved[student][k][n])
                          for k in adapters for n in ("down", "up")),
                  f"{path} does not read back as the checkpoint's {student}")
        sizes = {n: round(os.path.getsize(os.path.join(dirpath, n)) / 2**30, 2)
                 for dirpath, _, names in os.walk(out) for n in names
                 if n.endswith(("pt", "safetensors"))}
        print(f"  metrics finite under all eight names; checkpoint and both exports written "
              f"({sizes} GiB) and the exports read back equal to the checkpoint's adapters")
        del saved, adapters
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- the same step through make_train_step, on synthetic batches with added_cond ----
    args = train_icd.parse_args(common + ["--synthetic_data", "--output_dir", "unused"])
    unet, cfg, base, _ = train_icd.build_models(args, torch.device("cuda"))
    schedule = make_schedule(device="cuda")
    solver = make_train_solver(schedule.alphas_cumprod, num_endpoints=4, num_forward_endpoints=4,
                               endpoints=args.endpoints, forward_endpoints=args.forward_endpoints,
                               device="cuda")
    tcfg = train_icd.train_config(args, cfg)
    check(tcfg.lazy_lora and tcfg.remat, "the CLI's flags did not reach the config")
    before = {k: v.cpu() for k, v in base.items()}  # base = teacher: the UNet's own tensors
    batches = train_icd.batch_iterator(args, cfg, side, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(12)
    state = init_train_state(gen, base, tcfg)
    n_adapters = len(state.lora_reverse)
    n_lora = sum(t.numel() for ab in state.lora_reverse.values() for t in ab.values())
    step_fn = make_train_step(unet, base, base, solver, schedule, tcfg)
    state, _ = step_fn(state, next(batches), gen)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path: counts reset just before, read just after ----
    fa.reset_launch_counts()
    step_ms = []
    for _ in range(XL_DIRECT_STEPS):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, next(batches), gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    step_launches = collections.Counter(fa.LAUNCH_SHAPES)
    # --------------------------------------------------------------------
    lazy_peak = torch.cuda.max_memory_allocated() / 2**30
    metrics = {k: float(v) for k, v in metrics.items()}
    check(sorted(metrics) == sorted(METRIC_NAMES) and all(map(math.isfinite, metrics.values())),
          f"metrics {metrics}")
    totals = {name: sum(n for key, n in step_launches.items() if key[0] == name) // XL_DIRECT_STEPS
              for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")}
    print(f"  make_train_step (lazy, remat): launches per step {totals}, by shape "
          f"{dict(step_launches)}")
    check(step_launches == want_steps, f"launches {dict(step_launches)} != {dict(want_steps)}")
    check(totals == {"flash_fwd": 14 * 140, "flash_bwd_dq": 4 * 140, "flash_bwd_dkdv": 4 * 140},
          f"launches per step {totals}")
    check(all(torch.equal(v.cpu(), before[k]) for k, v in base.items()),
          "a base (= teacher) weight changed")
    del before
    mean_ms = statistics.mean(step_ms)
    print(f"  sdxl train step (lazy, remat), batch {b}, 1024^2, {n_adapters} adapters of rank "
          f"{tcfg.lora_rank} per student ({n_lora / 1e6:.1f} M parameters): "
          + " / ".join(f"{ms:.1f}" for ms in step_ms)
          + f" ms; {b * 1e3 / mean_ms:.3f} samples/s; peak {lazy_peak:.2f} GiB ({card})")
    state_box = [state]

    def traced_step():
        state_box[0], _ = step_fn(state_box[0], next(batches), gen)
    trace_run(f"sdxl batch {b} train step, lazy + remat", traced_step)
    del state_box, state, step_fn
    torch.cuda.empty_cache()

    # ---- lazy against merged: one step from the same state and draws ----
    lora_r, lora_f = seeded_lora(base, gen, tcfg.lora_rank), seeded_lora(base, gen, tcfg.lora_rank)
    for ab in (*lora_r.values(), *lora_f.values()):
        ab["up"].mul_(0.1)  # seeded adapters a tenth of the fan-in scale: a visible delta
    batch = next(batches)
    draw = torch.Generator(device="cuda").manual_seed(13)
    draws = {"noise": torch.randn((b, side, side, 4), generator=draw, device="cuda"),
             "w": torch.tensor([7.0, 11.0][:b], device="cuda"),
             "reverse_index": torch.tensor([5, 12][:b], device="cuda"),
             "forward_index": torch.tensor([5, 12][:b], device="cuda"),
             "forward_preserve_index": torch.tensor([1, 2][:b], device="cuda"),
             "reverse_preserve_index": torch.tensor([1, 2][:b], device="cuda")}
    results = {}
    for mode in ("merged", "lazy"):
        mcfg = dataclasses.replace(tcfg, lazy_lora=mode == "lazy")
        fn = make_train_step(unet, base, base, solver, schedule, mcfg)
        st = ICDTrainState(0, lora_r, lora_f, init_optimizer(lora_r, mcfg),
                           init_optimizer(lora_f, mcfg))
        fn(st, batch, None, draws)  # warm-up: the allocator's pools for this path
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        new, m = fn(st, batch, None, draws)
        torch.cuda.synchronize()
        results[mode] = dict(ms=(time.perf_counter() - t0) * 1e3,
                             peak=torch.cuda.max_memory_allocated() / 2**30,
                             metrics={k: float(v) for k, v in m.items()},
                             mu=torch.cat([t.flatten().cpu() for o in (new.opt_reverse, new.opt_forward)
                                           for ab in o["mu"].values() for t in ab.values()]),
                             move=torch.cat([(new_ab[n] - old_ab[n]).flatten().cpu()
                                             for lo, ln in ((lora_r, new.lora_reverse),
                                                            (lora_f, new.lora_forward))
                                             for key, old_ab in lo.items()
                                             for new_ab in (ln[key],) for n in ("down", "up")]))
        del fn, st, new, m
        torch.cuda.empty_cache()
    mm, lz = results["merged"], results["lazy"]
    metric_err = {k: abs(lz["metrics"][k] - mm["metrics"][k]) / max(abs(mm["metrics"][k]), 1e-12)
                  for k in mm["metrics"]}
    grad_rel = ((lz["mu"] - mm["mu"]).norm() / mm["mu"].norm()).item()
    same_sign = (torch.sign(lz["move"]) == torch.sign(mm["move"])).float().mean().item()
    print(f"  lazy vs merged, one step (seeded adapters, same draws), batch {b}: metric relative "
          f"differences {({k: f'{v:.2e}' for k, v in sorted(metric_err.items())})} (tol "
          f"{UNET_REL_TOL}); gradients (Adam's first moment) relative L2 {grad_rel:.3e} (tol "
          f"{LAZY_GRAD_TOL}); adapter moves of the same sign {same_sign:.4f}")
    print(f"  peak memory, one step at batch {b} after one warm-up step: merged {mm['peak']:.2f} GiB, "
          f"lazy {lz['peak']:.2f} GiB; step ms merged {mm['ms']:.1f}, lazy {lz['ms']:.1f} ({card})")
    check(all(v <= UNET_REL_TOL for v in metric_err.values()), f"lazy vs merged metrics {metric_err}")
    check(math.isfinite(grad_rel) and grad_rel <= LAZY_GRAD_TOL, f"lazy vs merged gradients {grad_rel}")
    del results, mm, lz
    torch.cuda.empty_cache()

    # ---- kernel path against materialised path under grad: reverse_cd_loss, batch 1, d = 64 ----
    leaves = [t.requires_grad_(True) for ab in lora_r.values() for t in ab.values()]
    scale = tcfg.lora_alpha / tcfg.lora_rank
    targets = lora_modules(unet, lora_r)
    latents = batch["latents"][:1].permute(0, 3, 1, 2)
    context = batch["context"][:1]
    added = {k: v[:1] for k, v in batch["added_cond"].items()}
    noise = draws["noise"][:1].permute(0, 3, 1, 2)
    w = torch.tensor([7.0], device="cuda")

    def identity_hook(probs, meta: AttnMeta):
        return probs

    def adapter_grad(hook=None):
        def student(params, x, t, w_emb):
            return call_with_lora(unet, base, lora_r, scale, x, t, context, w_cond=w_emb,
                                  added_cond=added, attn_hook=hook, targets=targets)

        def teacher_apply(params, x, t, w_emb):
            return unet(x, t, context, w_cond=w_emb, added_cond=added)
        loss, _ = reverse_cd_loss(student, None, teacher_apply, None, latents, noise, w, None, solver,
                                  schedule, tcfg.loss, index=torch.tensor([5], device="cuda"))
        return loss.item(), torch.cat([g.flatten() for g in torch.autograd.grad(loss, leaves)])

    fa.reset_launch_counts()
    loss_k, grad_k = adapter_grad()
    counted = {name: fa.launches(name) for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")}
    loss_p, grad_p = adapter_grad(hook=identity_hook)
    check(counted == {"flash_fwd": 3 * 140, "flash_bwd_dq": 140, "flash_bwd_dkdv": 140},
          f"reverse_cd_loss launches {counted}")
    check(fa.launches("flash_fwd") == counted["flash_fwd"] + 140
          and fa.launches("flash_bwd_dq") == 140 and fa.launches("flash_bwd_dkdv") == 140,
          "the materialised path launched a backward kernel")
    rel = ((grad_k - grad_p).norm() / grad_p.norm()).item()
    print(f"  reverse_cd_loss adapter gradient (lazy, {grad_k.numel() / 1e6:.1f} M entries) at t=119, "
          f"kernel path (B1 lse, B3, B4 at d = 64) vs materialised path: relative L2 {rel:.3e} "
          f"(tol {GRAD_REL_TOL}); loss {loss_k:.6f} vs {loss_p:.6f}; |grad| {grad_p.norm().item():.3e}")
    check(math.isfinite(rel) and rel <= GRAD_REL_TOL and grad_p.norm().item() > 0,
          f"kernel-path gradient off by {rel}")
    del grad_k, grad_p, leaves, lora_r, lora_f, unet, base
    torch.cuda.empty_cache()
    return cli_launches + step_launches


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one GPU.")
    p.add_argument("--kernels-only", action="store_true",
                   help="run phases 1-3 and 6 only and print the kernel rows (not the device line)")
    p.add_argument("--q1-compare", action="store_true",
                   help="build and time Q1 at the int8 paths' costliest shapes (Q1_COMPARE) only")
    p.add_argument("--b2f32-compare", action="store_true",
                   help="build and time B2's fp32 build at SDXL's VAE shapes (B2F32_COMPARE) only")
    p.add_argument("--bwd160-compare", action="store_true",
                   help="build and time B3 and B4 at BACKWARD_SHAPES only, the d = 160 rows "
                        "checked against the plain backward and beside SDPA's backward")
    p.add_argument("--dist-worker", nargs=3, metavar=("RANK", "PORT", "OUT_DIR"), default=None,
                   help=argparse.SUPPRESS)  # one of phase 5d's two ranks (`dist_worker`)
    p.add_argument("--dist-job", choices=("dp", "sptp"), default="dp",
                   help=argparse.SUPPRESS)  # which ranks `--dist-worker` runs (5d's or 5e's)
    p.add_argument("--sp-fault", choices=("halo", "gn", "kv"), default=None,
                   help="run phase 5e's two ranks only, with sp's halo rows, GroupNorm "
                        "reduction or K/V gather taken out, and print what the sp gate reads")
    p.add_argument("--dist-fault", choices=("none", "sum", "to_tp"), default=None,
                   help="run phase 5d's two ranks only, with the trainer's gradient reduction "
                        "skipped (none) or summed (sum), or phase 5e's tp = 2 train step only, "
                        "with to_tp's backward sum taken out (to_tp), and print what the "
                        "step's gates read")
    p.add_argument("--package-root", default=None,
                   help="import invertible_cd_tpu_torch from this checkout (e.g. an unpacked "
                        "parent commit, to time two versions of the kernels in one call)")
    return p.parse_args(argv)


SCRIPT_START = time.perf_counter()
PHASE_WALL_S = {}  # each phase's wall seconds, in the order run


def timed(name: str, phase, *args):
    """`phase(*args)`, its wall time kept in PHASE_WALL_S."""
    t0 = time.perf_counter()
    try:
        return phase(*args)
    finally:
        PHASE_WALL_S[name] = time.perf_counter() - t0


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
    if args.dist_worker:
        rank, port, out_dir = args.dist_worker
        if args.dist_job == "sptp":
            return sptp_worker(int(rank), int(port), out_dir, args.sp_fault, args.dist_fault)
        return dist_worker(int(rank), int(port), out_dir, args.dist_fault)
    try:
        import invertible_cd_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

        print(f"package: {os.path.dirname(invertible_cd_tpu_torch.__file__)}")
        card = phase_card()
        phase_build(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv") if args.bwd160_compare
                    else ("flash_fwd", "flash_fwd_streamed", "flash_bwd_dq", "flash_bwd_dkdv")
                    if args.dist_fault or args.sp_fault else None)
        if args.q1_compare:
            phase_q1_compare()
            return 0
        if args.b2f32_compare:
            phase_b2f32_compare()
            return 0
        if args.bwd160_compare:
            phase_bwd160_compare()
            return 0
        if args.dist_fault:
            phase_dist_fault(args.dist_fault)
            return 0
        if args.sp_fault:
            phase_sp_fault(args.sp_fault)
            return 0
        rows = timed("kernels", phase_kernels, card) + timed("backward kernels",
                                                              phase_backward_kernels, card)
        harness_rows = timed("harness", phase_harness, card, rows)
        if args.kernels_only:
            phase_q1_compare()
            print(json.dumps({"kernels": rows + harness_rows}))
            return 0
        pipe, generate_launches = timed("generate", phase_main_path, card)
        edit_launches = timed("edit", phase_edit, card, pipe)
        serve_launches = timed("serve", phase_serve, card, pipe)
        baseline_launches = timed("baselines", phase_baselines, card, pipe)
        q1_rows = timed("int8", phase_int8, card, pipe)
        sdxl_launches, xl_q1_rows = timed("sdxl", phase_sdxl, card)
        torch.cuda.empty_cache()  # the SDXL bundle is gone
        train_launches = timed("train", phase_training, card, pipe)
        dist_launches = timed("distribution", phase_distributed, card, pipe)
        sptp_launches, tp_split_launches = timed("sp and tp", phase_sp_tp, card)
        eval_launches, eval_train_launches = timed("eval", phase_eval, card, pipe)
        del pipe
        torch.cuda.empty_cache()  # the SD1.5 bundle is gone
        xl_train_launches = timed("sdxl training", phase_xl_training, card)
    except Exception:  # report every phase failure and exit non-zero
        traceback.print_exc()
        return 1
    # launches on the main paths: the generate at the row's batch, the counted
    # invert (batch 1) and controlled pair (batch 2), the serving phase's
    # counted requests and edit CLI runs at the batch each kernel ran at (the
    # executor's at 1 and 4, HTTP's at 4), the baselines' runs at
    # the batch each kernel ran at (NTI's at 1, the CFG-doubled DDIM's at 2,
    # its controlled pair's at 4, the VAE's at the prompts'), SDXL's counted
    # generate and invert (batch 1) and edited pair (batch 2) with the
    # bf16-VAE opt-in's decodes, three train steps (batch 2) for the rows
    # at the generate's main batch, and the SDXL training phase's counted CLI
    # and direct steps for the rows at its batch, and the distribution
    # phase's counted runs at the batch each ran at ((a)'s step with phase 5's)
    none = collections.Counter()
    for row in rows:
        key = (row["kernel"],) + tuple(row["shape"])
        if row.get("tp_split"):  # half the heads: phase 5e's tp runs alone
            row["launches"] = tp_split_launches[key]
            continue
        row["launches"] = (generate_launches.get(row["batch"], none)[key]
                           + sptp_launches.get(row["batch"], none)[key]
                           + edit_launches.get(row["batch"], none)[key]
                           + serve_launches.get(row["batch"], none)[key]
                           + baseline_launches.get(row["batch"], none)[key]
                           + sdxl_launches.get(row["batch"], none)[key]
                           + eval_launches.get(row["batch"], none)[key]
                           + dist_launches.get(row["batch"], none)[key]
                           + (train_launches[key] + eval_train_launches[key]
                              if row["batch"] == BATCH else 0)
                           + (xl_train_launches[key] if row["batch"] == XL_TRAIN_BATCH else 0))
    # B5 runs on the harness path alone; its rows carry that path's launches;
    # Q1's and Q2's rows carry the int8 phases' counted runs
    rows += harness_rows + q1_rows + xl_q1_rows
    missing = [r["name"] for r in rows if r["launches"] == 0]
    if missing:
        print(f"chip_smoke: kernels not launched on their path: {missing}", file=sys.stderr)
        return 1
    print(json.dumps({"phase_wall_s": PHASE_WALL_S,
                      "script_s": time.perf_counter() - SCRIPT_START}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
