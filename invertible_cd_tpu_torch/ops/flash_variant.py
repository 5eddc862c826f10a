"""Kernel B5, the softmax-variant harness, with its plain version.

PyTorch counterpart of `_kernel` / `flash_variant` in `tools/exp_softmax.py`:
B1's forward without the logsumexp, on the (G, S, D) layout (one head per
instance), in five softmax variants:

  base      fp32 online softmax with the natural exp;
  exp2      log2(e) folded into the logit scale, exp2 for p and alpha;
  bf16exp   p = exp(bf16(logits - m)) in bf16, the row sum in fp32;
  exp2bf16  both;
  nomax     no running max: p = exp(logits), plain sums (unsafe by design;
            the inputs must keep |logits| small).

`flash_variant` launches the CUDA kernel (`csrc/flash_variant.cu`, built and
bound with the other kernels of `flash_attention`) on CUDA tensors or raises;
CPU tensors take `flash_variant_plain` at the kernel's key tile. Launches
count in `flash_attention.LAUNCH_SHAPES` under ("flash_variant", Sq, Sk, D,
variant).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import flash_attention as fa

VARIANTS = ("base", "exp2", "bf16exp", "exp2bf16", "nomax")
BF16_VARIANTS = ("bf16exp", "exp2bf16")
#: keys per tile of the kernel: the tile at which the bf16 variants round
KEY_TILE = 64
NEG_INF = -1e30
LOG2E = 1.4426950408889634

# one C entry point per variant: (q, k, v, o, batch, heads, sq, sk, d, scale, stream)
fa._ENTRY_POINTERS.update({f"icd_flash_variant_{v}": 4 for v in VARIANTS})


def flash_variant_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, variant: str,
    block_k: int = 512, scale: Optional[float] = None,
) -> torch.Tensor:
    """The variant's recurrence in fp32 PyTorch, one key tile of `block_k`
    at a time, as `tools/exp_softmax.py`'s `_kernel` runs it (the last tile
    may be shorter). The bf16 variants round `logits - m_new` to bf16 at each
    tile's running max and take the exponential in bf16; p meets V in V's
    dtype. Returns (G, Sq, D) in q's dtype."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    use_exp2 = variant in ("exp2", "exp2bf16")
    use_bf16 = variant in ("bf16exp", "exp2bf16")
    exp = torch.exp2 if use_exp2 else torch.exp
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    eff_scale = scale * LOG2E if use_exp2 else scale
    qf = q.float()
    g, sq, d = q.shape
    m = torch.full((g, sq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((g, sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((g, sq, d), dtype=torch.float32, device=q.device)
    for start in range(0, k.shape[1], block_k):
        k_t = k[:, start:start + block_k].float()
        v_t = v[:, start:start + block_k]
        logits = eff_scale * torch.einsum("gqd,gkd->gqk", qf, k_t)
        if variant == "nomax":
            p = torch.exp(logits)
            l = l + p.sum(-1, keepdim=True)
            acc = acc + torch.einsum("gqk,gkd->gqd", p.to(v.dtype).float(), v_t.float())
            continue
        m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
        diff = logits - m_new
        if use_bf16:
            p = exp(diff.to(torch.bfloat16))
            p_sum = p.float().sum(-1, keepdim=True)
        else:
            p = exp(diff)
            p_sum = p.sum(-1, keepdim=True)
        alpha = exp(m - m_new)
        l = l * alpha + p_sum
        acc = acc * alpha + torch.einsum("gqk,gkd->gqd", p.to(v.dtype).float(), v_t.float())
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def _bf16_rounding(x: torch.Tensor):
    """bf16(x) of positive fp32 `x`, and |x - bf16(x)| as a fraction of half
    the bf16 step on x's side (0: exact; 1: on the rounding boundary)."""
    b = x.to(torch.bfloat16)
    bits = b.view(torch.int16)
    side = torch.where(x > b.float(), bits + 1, bits - 1).view(torch.bfloat16).float()
    return b.float(), (x - b.float()).abs() / ((side - b.float()).abs() / 2)


def variant_probe(g: int, s: int, d: int, variant: str, scale: float,
                  device="cpu") -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """bf16 q, k, v of (G, S, D) on which a bf16 variant's rounding moves the
    output far more than anything else does, so a kernel that rounds in
    another way than `variant` says cannot pass for it.

    Key 0 is (1, 1, 0, ...) and every other key is 0; row i of q is
    (a_i, b_i, 0, ...). So row i has the logit x_i = (a_i + b_i) * scale
    (times log2(e) in exp2bf16) against key 0, the row max after the first
    tile, and 0 against every other key, whose p is then exp(-bf16(x_i)).
    v is -1 at key 0 and +1 elsewhere, so o_i = (r_i - 1) / (r_i + 1) with
    r_i = (S - 1) p_i in every column: near 0, and most sensitive to p, as
    x_i lies near ln(S - 1). Each x_i is picked so that bf16(x_i) is 0.2 to
    0.45 of a bf16 step off x_i (p moves by 1 to 3 % against base) and no
    fp32 rounding of the scale can flip it; and so that exp(-bf16(x_i)) is
    far from a bf16 rounding boundary (bf16exp) or exact, a power of two
    (exp2bf16). A kernel that rounds as its variant says then meets the
    plain version to the output's rounding; one that does not is off by the
    variant's whole distance from base."""
    if variant not in BF16_VARIANTS:
        raise ValueError(f"variant {variant!r} not in {BF16_VARIANTS}")
    if d < 2 or s < 2:
        raise ValueError(f"the probe needs S >= 2 and D >= 2, got S={s}, D={d}")
    use_exp2 = variant == "exp2bf16"
    a = torch.arange(1, 256, dtype=torch.float32).repeat_interleave(256)
    b = torch.arange(256, dtype=torch.float32).repeat(255) / 256  # a + b is exact in fp32
    logit = a + b
    scale32 = torch.tensor(scale, dtype=torch.float32)
    # the kernel's fp32 scale (scale * log2e in fp32) and the plain version's
    # (the product in double, then fp32)
    scales = ((scale32 * torch.tensor(LOG2E, dtype=torch.float32),
               torch.tensor(scale * LOG2E, dtype=torch.float32)) if use_exp2 else (scale32,))
    target = math.log2(s - 1) if use_exp2 else math.log(s - 1)
    ok = torch.ones_like(logit, dtype=torch.bool)
    rounded = None
    for c in scales:
        x = logit * c
        xb, frac = _bf16_rounding(x)
        ok &= (frac >= 0.4) & (frac <= 0.9) & ((x - target).abs() <= 0.7)
        ok &= (rounded is None) or (xb == rounded)
        rounded = xb
    if use_exp2:
        ok &= rounded == rounded.round()  # p = 2^-bf16(x) is a power of two
    else:
        p = torch.exp(-rounded.double()).float()
        ok &= _bf16_rounding(p)[1] <= 0.8
    picked = ok.nonzero().flatten()
    if picked.numel() == 0:
        raise ValueError(f"no probe logits for S={s}, scale={scale}")
    rows = picked[torch.arange(s) % picked.numel()]
    q = torch.zeros((g, s, d))
    q[:, :, 0] = a[rows]
    q[:, :, 1] = b[rows]
    k = torch.zeros((g, s, d))
    k[:, 0, :2] = 1.0
    v = torch.ones((g, s, d))
    v[:, 0] = -1.0
    return tuple(t.to(device=device, dtype=torch.bfloat16) for t in (q, k, v))


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        fa._check_tensor(name, t, q)
        if t.dim() != 3:
            raise ValueError(f"{name} must be (G, S, D), got {tuple(t.shape)}")
    g, sq, d = q.shape
    if k.shape != v.shape or k.shape[0] != g or k.shape[2] != d:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if not 0 < d <= 128 or d % 8:
        raise ValueError(f"head dim {d} outside (0, 128] or not a multiple of 8")
    if sq == 0 or k.shape[1] == 0 or g > 65535:
        raise ValueError(f"unsupported shape q {tuple(q.shape)} k {tuple(k.shape)}")


def flash_variant(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, variant: str,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Kernel B5: softmax(scale q k^T) v per instance in `variant`, q
    (G, Sq, D) and k/v (G, Sk, D) bf16, contiguous; scale defaults to
    D^-0.5. CPU tensors take `flash_variant_plain` at the kernel's tile."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_variant_plain(q, k, v, variant, block_k=KEY_TILE, scale=scale)
    _check(q, k, v)
    g, sq, d = q.shape
    sk = k.shape[1]
    o = torch.empty_like(q)
    fn = fa._entry("flash_variant", f"icd_flash_variant_{variant}")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), g, 1, sq, sk, d, scale, stream)
    if rc != 0:
        raise RuntimeError(f"icd_flash_variant_{variant} launch failed with CUDA error {rc}")
    fa.LAUNCH_SHAPES[("flash_variant", sq, sk, d, variant)] += 1
    return o
