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
// The tile loop is B1's Hopper loop (flash_wgmma.cuh: 128-row blocks of two
// warpgroups, wgmma for Q K^T and P V, a 3-stage cp.async K/V ring, 64-key
// tiles, row sums held per thread until the end), so the harness measures
// the softmax in the loop B1 runs. Each variant is a policy of that loop,
// writing P as its wgmma register A operand. What each variant does per
// logit:
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
//   nomax     no running max, no alpha, no rescale of the accumulator or the
//             row sums: FMUL, expf, FADD. Unsafe by design (exp overflows for
//             logits above ~88); the inputs must keep |logits| small.
// The bf16 variants round logits - m at each 64-key tile's running max, the
// tile the plain version is held at (flash_variant.KEY_TILE). Keys past Sk
// are masked to -1e30 on the ragged last tile (the TPU kernel assumed Sk a
// multiple of its key tile); l is clamped at 1e-30 as there. Padded head
// dims 48 (the UNet's 40), 64 (the tool's headline) and 128; there is no
// route above 128.
#include "flash_wgmma.cuh"

namespace icd {

enum Variant { kBase = 0, kExp2 = 1, kBf16Exp = 2, kExp2Bf16 = 3, kNoMax = 4 };

__device__ __forceinline__ uint32_t exp2_bf16x2(uint32_t x) {
  uint32_t y;
  asm("ex2.approx.ftz.bf16x2 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// The variant's softmax as a policy of the shared loop (flash_wgmma.cuh): the
// raw logits `s` of rows g (index 0) and g+8 (index 1) in, P out as the bf16
// A operands pa (k-step n / 2, row g in pa[n / 2][(n % 2) * 2], row g+8 in
// the next register), this thread's share of the row sums in `sum`.
template <int V>
struct VariantSoftmax {
  static constexpr bool kRescale = V != kNoMax;
  static constexpr bool kLse = false;
  template <int NS>
  __device__ static void tile(float (&s)[NS][4], uint32_t (&pa)[NS / 2][4], float (&m)[2],
                              float (&alpha)[2], float (&sum)[2], float scale, int k0, int sk,
                              int t) {
    constexpr bool kUseExp2 = V == kExp2 || V == kExp2Bf16;
    constexpr bool kUseBf16 = V == kBf16Exp || V == kExp2Bf16;
    const float c = kUseExp2 ? scale * kLog2e : scale;
    const bool ragged = k0 + NS * 8 > sk;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * c;
        if (ragged && k0 + n * 8 + 2 * t + (e & 1) >= sk) x = kNegInf;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    sum[0] = sum[1] = 0.f;
    if constexpr (V == kNoMax) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float p0 = expf(s[n][2 * r]);
          const float p1 = expf(s[n][2 * r + 1]);
          sum[r] += p0 + p1;
          pa[n / 2][(n % 2) * 2 + r] = pack_bf16(p0, p1);
        }
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
          const float d0 = s[n][2 * r] - m[r];
          const float d1 = s[n][2 * r + 1] - m[r];
          uint32_t p;
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
            p = *reinterpret_cast<uint32_t*>(&pv);
          } else {
            const float p0 = kUseExp2 ? exp2f(d0) : expf(d0);
            const float p1 = kUseExp2 ? exp2f(d1) : expf(d1);
            sum[r] += p0 + p1;
            p = pack_bf16(p0, p1);
          }
          pa[n / 2][(n % 2) * 2 + r] = p;
        }
      }
    }
  }
};

template <int V>
int dispatch_b5(const void* q, const void* k, const void* v, void* o, int batch, int heads,
                int sq, int sk, int d, float scale, void* stream) {
  using S = VariantSoftmax<V>;
  void* const no_lse = nullptr;
  if (d <= 48) return launch_fwd_wgmma<48, S>(q, k, v, o, no_lse, batch, heads, sq, sk, d, scale, stream);
  if (d <= 64) return launch_fwd_wgmma<64, S>(q, k, v, o, no_lse, batch, heads, sq, sk, d, scale, stream);
  if (d <= 128) return launch_fwd_wgmma<128, S>(q, k, v, o, no_lse, batch, heads, sq, sk, d, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace icd

// One Q K^T and one P V product of the loop at B5's padded width for d
// (q, k, v: 64 x d bf16; s: 64 x 64 fp32; o: 64 x d fp32): the card test of
// the descriptors at each width (tests/test_torch_gpu.py).
extern "C" int icd_wgmma_product_check(const void* q, const void* k, const void* v, void* s,
                                       void* o, int d, void* stream) {
  if (d <= 0 || d % 8) return (int)cudaErrorInvalidValue;
  if (d <= 48) return icd::launch_wgmma_product_check<48>(q, k, v, s, o, d, stream);
  if (d <= 64) return icd::launch_wgmma_product_check<64>(q, k, v, s, o, d, stream);
  if (d <= 128) return icd::launch_wgmma_product_check<128>(q, k, v, s, o, d, stream);
  return (int)cudaErrorInvalidValue;
}

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
