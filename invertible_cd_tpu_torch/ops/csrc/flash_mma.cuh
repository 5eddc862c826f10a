// The earlier flash-attention forward tile loop on mma.sync (B1's first
// design), kept for B1's route at padded head dim 256 (flash_fwd.cu), which
// is off every path of the port. B1's other widths and kernel B5 run the
// Hopper loop of flash_wgmma.cuh. The softmax is passed as a policy type.
//
// One block = 64 query rows of one (batch, head), 4 warps x 16 rows;
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate); 64-key tiles of K
// (row-major) and V (transposed by scalar stores) staged synchronously in
// shared memory between two barriers; logits, softmax state and
// accumulator in registers.
//
// A Softmax policy provides
//   static constexpr bool kRescale;  // the accumulator takes alpha
//   template <int NS> static __device__ void tile(
//       float (&s)[NS][4], uint32_t (&p)[NS][2], float (&m)[2], float (&l)[2],
//       float (&alpha)[2], float scale, int k0, int sk, int t);
// which takes one tile's raw logits `s` of rows g (index 0) and g+8
// (index 1), masks keys at or past sk, updates the running max `m` and the
// row sum `l` (reduced over the quad), and gives P as packed bf16 pairs:
// p[n][0] = row g, keys 2t..2t+1 of 8-key tile n; p[n][1] = row g+8. Given
// `lse`, the kernel writes ln2 * (m + log2 l), so a policy used with an lse
// keeps m in base-2 units.
#pragma once

#include "flash_common.cuh"

namespace icd {

constexpr int kMmaRows = 64;  // query rows per block
constexpr int kMmaKeys = 64;  // keys per tile

template <int DP>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * ((size_t)(kMmaRows + kMmaKeys) * (DP + 8) + (size_t)DP * (kMmaKeys + 8));
}

template <int DP, class Softmax>
__global__ void __launch_bounds__(128)
flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
              int heads, int sq, int sk, int d, float scale) {
  constexpr int LDI = DP + 8;        // Q and K row stride (elements)
  constexpr int LDT = kMmaKeys + 8;  // V^T row stride
  constexpr int NS = kMmaKeys / 8;   // 8-key tiles of logits per warp
  constexpr int NO = DP / 8;         // 8-column tiles of the accumulator

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kMmaRows * LDI;
  bf16* sVt = sK + kMmaKeys * LDI;

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y - b * heads;
  const int q0 = blockIdx.x * kMmaRows;
  const size_t rs = (size_t)heads * d;  // row stride of (B, S, H, D)
  const bf16* kb = k + (size_t)b * sk * rs + (size_t)h * d;
  const bf16* vb = v + (size_t)b * sk * rs + (size_t)h * d;
  bf16* ob = o + (size_t)b * sq * rs + (size_t)h * d;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const bf16* qw = sQ + warp * 16 * LDI;

  load_rows(sQ, LDI, q + ((size_t)b * sq + q0) * rs + (size_t)h * d, rs, kMmaRows, sq - q0, d, DP);

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < sk; k0 += kMmaKeys) {
    __syncthreads();  // the previous tile is consumed (and Q is staged)
    load_rows(sK, LDI, kb + (size_t)k0 * rs, rs, kMmaKeys, sk - k0, d, DP);
    load_rows_transposed(sVt, LDT, vb + (size_t)k0 * rs, rs, kMmaKeys, sk - k0, d, DP);
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t a[4];
      load_a(a, qw, LDI, kk, g, t);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const bf16* kp = sK + (n * 8 + g) * LDI + kk + 2 * t;
        mma_16816(s[n], a, ld32(kp), ld32(kp + 8));
      }
    }

    uint32_t p[NS][2];
    float alpha[2];
    Softmax::template tile<NS>(s, p, m, l, alpha, scale, k0, sk, t);
    if constexpr (Softmax::kRescale) {
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
    }

#pragma unroll
    for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
      const uint32_t a[4] = {p[2 * kk][0], p[2 * kk][1], p[2 * kk + 1][0], p[2 * kk + 1][1]};
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const bf16* vp = sVt + (n * 8 + g) * LDT + kk * 16 + 2 * t;
        mma_16816(acc[n], a, ld32(vp), ld32(vp + 8));
      }
    }
  }

  store_rows<NO>(ob, rs, acc, l, q0 + warp * 16 + g, sq, 0, d, t);
  if (lse != nullptr) store_lse(lse + (size_t)blockIdx.y * sq, m, l, q0 + warp * 16 + g, sq, t);
}

template <int DP, class Softmax>
int launch_fwd_mma(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
                   int heads, int sq, int sk, int d, float scale, void* stream) {
  const size_t smem = mma_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma<DP, Softmax>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + kMmaRows - 1) / kMmaRows, batch * heads);
  flash_fwd_mma<DP, Softmax><<<grid, 128, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), heads, sq, sk, d, scale);
  return (int)cudaGetLastError();
}

}  // namespace icd
