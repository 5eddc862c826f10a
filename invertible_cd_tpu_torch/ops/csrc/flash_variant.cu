// Kernel B5: the softmax-variant harness, B1's forward without lse in five
// softmax variants, on the (G, S, D) layout (one head per instance).
//
// Replaces `_kernel` / `flash_variant` in tools/exp_softmax.py, the TPU
// experiment that asked whether the 4096-token d=40 self-attention sits at a
// floor set by the exponentials. Each C entry point `icd_flash_variant_<v>`
// is one instantiation of the same kernel; they take B1's argument list with
// batch = G and heads = 1, and the logit scale as an argument.
//
// Bounds on an H100 SXM (700 W) for G instances of S queries x S keys:
//   * 4*G*S^2*D FLOPs at 989e12 bf16 FLOP/s on the tensor cores;
//   * G*S^2 exponentials at 3.9e12/s: the MUFU unit issues 16 a clock per SM
//     (132 SMs at 1.83 GHz), FlashAttention-3's figure; exp2bf16's
//     ex2.approx.bf16x2 does two a MUFU issue, 7.8e12/s;
//   * 2*G*S*D*4 bytes (q, k, v read once, o written once) at 3.35e12 B/s.
// At the harness's G=32, S=4096, D=40 the exponentials bound (0.138 ms
// against 0.087 ms of products): any d < 64 puts the MUFU above the tensor
// cores on this card.
//
// The tile loop is B1's earlier mma.sync design (flash_mma.cuh, which B1
// keeps for head dim 256): one block = 64 query rows, 4 warps x 16 rows,
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate), 64-key tiles of K
// (row-major) and V (transposed) staged synchronously in shared memory,
// logits, softmax state and accumulator in registers. The variants' softmax
// stays here, so B1's Hopper design (flash_fwd.cu) leaves it where it was.
// What each variant changes in the instruction mix, per logit:
//   base      FMUL by the scale, FADD of -m, expf (an FMUL by log2(e) and a
//             range-reduced MUFU ex2 inside), FADD into the row sum; alpha
//             by expf;
//   exp2      log2(e) folded into the scale: FMUL, FADD, one MUFU ex2
//             (exp2f); alpha by exp2f;
//   bf16exp   as base up to logits - m, then one F2F pair-convert to bf16
//             and h2exp on the __nv_bfloat162 pair: on sm_90 the toolkit
//             widens each half to fp32, multiplies by log2(e) and takes two
//             fp32 ex2.approx before rounding back, so it saves no MUFU
//             issue; two bf16 -> fp32 for the fp32 row sum; p is already the
//             bf16 A operand of P V;
//   exp2bf16  as exp2 up to logits - m, then ex2.approx.ftz.bf16x2: one MUFU
//             issue for two exponentials;
//   nomax     no running max, no alpha, no rescale of the accumulator:
//             FMUL, expf, FADD. Unsafe by design (exp overflows for logits
//             above ~88); the inputs must keep |logits| small.
// Keys past Sk are masked to -1e30 (the TPU kernel assumed Sk a multiple of
// its key tile); l is clamped at 1e-30 as there.
#include "flash_mma.cuh"

namespace icd {

enum Variant { kBase = 0, kExp2 = 1, kBf16Exp = 2, kExp2Bf16 = 3, kNoMax = 4 };

__device__ __forceinline__ uint32_t exp2_bf16x2(uint32_t x) {
  uint32_t y;
  asm("ex2.approx.ftz.bf16x2 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// One tile's softmax for rows g (index 0) and g+8 (index 1) of a warp: the
// logits `s` (raw products) in, probabilities out as packed bf16 pairs
// p[n][0] = row g, keys 2t..2t+1 of 8-key tile n, p[n][1] = row g+8.
template <int NS, int V>
__device__ __forceinline__ void variant_softmax(const float (&s)[NS][4], uint32_t (&p)[NS][2],
                                                float (&m)[2], float (&l)[2], float (&alpha)[2],
                                                float scale, int k0, int sk, int t) {
  constexpr bool kUseExp2 = V == kExp2 || V == kExp2Bf16;
  constexpr bool kUseBf16 = V == kBf16Exp || V == kExp2Bf16;
  const float c = kUseExp2 ? scale * kLog2e : scale;
  float x[NS][4];
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int n = 0; n < NS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + n * 8 + 2 * t + (e & 1);
      x[n][e] = key < sk ? s[n][e] * c : kNegInf;
      mx[e >> 1] = fmaxf(mx[e >> 1], x[n][e]);
    }
  }
  float sum[2] = {0.f, 0.f};
  if constexpr (V == kNoMax) {
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float pe[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pe[e] = expf(x[n][e]);
        sum[e >> 1] += pe[e];
      }
      p[n][0] = pack_bf16(pe[0], pe[1]);
      p[n][1] = pack_bf16(pe[2], pe[3]);
    }
    alpha[0] = alpha[1] = 1.f;
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = kUseExp2 ? exp2f(m[r] - m_new) : expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float d0 = x[n][2 * r] - m[r];
        const float d1 = x[n][2 * r + 1] - m[r];
        if constexpr (kUseBf16) {
          __nv_bfloat162 dv = __floats2bfloat162_rn(d0, d1);
          __nv_bfloat162 pv;
          if constexpr (kUseExp2) {
            const uint32_t y = exp2_bf16x2(*reinterpret_cast<uint32_t*>(&dv));
            pv = *reinterpret_cast<const __nv_bfloat162*>(&y);
          } else {
            pv = h2exp(dv);
          }
          const float2 pf = __bfloat1622float2(pv);
          sum[r] += pf.x + pf.y;
          p[n][r] = *reinterpret_cast<uint32_t*>(&pv);
        } else {
          const float p0 = kUseExp2 ? exp2f(d0) : expf(d0);
          const float p1 = kUseExp2 ? exp2f(d1) : expf(d1);
          sum[r] += p0 + p1;
          p[n][r] = pack_bf16(p0, p1);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    l[r] = l[r] * alpha[r] + sum[r];
  }
}

// The variant's softmax as the policy of the shared loop (flash_mma.cuh),
// whose 64-key tile (kMmaKeys) is the one the plain version is held at.
template <int V>
struct VariantSoftmax {
  static constexpr bool kRescale = V != kNoMax;
  template <int NS>
  __device__ static void tile(float (&s)[NS][4], uint32_t (&p)[NS][2], float (&m)[2],
                              float (&l)[2], float (&alpha)[2], float scale, int k0, int sk,
                              int t) {
    variant_softmax<NS, V>(s, p, m, l, alpha, scale, k0, sk, t);
  }
};

// Head dims 40 (the UNet's, padded to 48), 64 (the tool's headline) and up
// to 128.
template <int V>
int dispatch_b5(const void* q, const void* k, const void* v, void* o, int batch, int heads,
                int sq, int sk, int d, float scale, void* stream) {
  using S = VariantSoftmax<V>;
  void* const no_lse = nullptr;
  if (d <= 48) return launch_fwd_mma<48, S>(q, k, v, o, no_lse, batch, heads, sq, sk, d, scale, stream);
  if (d <= 64) return launch_fwd_mma<64, S>(q, k, v, o, no_lse, batch, heads, sq, sk, d, scale, stream);
  if (d <= 128) return launch_fwd_mma<128, S>(q, k, v, o, no_lse, batch, heads, sq, sk, d, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace icd

#define ICD_B5_ENTRY(NAME, V)                                                              \
  extern "C" int icd_flash_variant_##NAME(const void* q, const void* k, const void* v,     \
                                          void* o, int batch, int heads, int sq, int sk,   \
                                          int d, float scale, void* stream) {              \
    return icd::dispatch_b5<V>(q, k, v, o, batch, heads, sq, sk, d, scale, stream);       \
  }
ICD_B5_ENTRY(base, icd::kBase)
ICD_B5_ENTRY(exp2, icd::kExp2)
ICD_B5_ENTRY(bf16exp, icd::kBf16Exp)
ICD_B5_ENTRY(exp2bf16, icd::kExp2Bf16)
ICD_B5_ENTRY(nomax, icd::kNoMax)
#undef ICD_B5_ENTRY
