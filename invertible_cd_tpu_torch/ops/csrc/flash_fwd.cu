// Kernel B1: flash-attention forward for head dims <= 256.
//
// Replaces `_fwd_kernel` in invertible_cd_tpu/ops/flash_attention.py
// (launched by `_flash_forward` through `_flash_op`): every UNet self- and
// cross-attention of the SD1.5 main path, at Sq = Sk = 4096/1024/256/64 with
// d = 40/80/160/160, and Sk = 77 for cross-attention.
//
// What bounds it on an H100: operations. At 4096 tokens and d = 40 a
// (batch, head) pair does 4*4096^2*40 = 2.7 GFLOP on 1.3 MB of Q/K/V/O,
// some 2000 operations per byte against the card's ~295; at Sk = 77 and at
// 64 tokens the work is microseconds and launch overhead rules. The design
// keeps the operations on the tensor cores and everything else out of the
// way of them:
//   * one block = 64 query rows of one (batch, head), 4 warps x 16 rows;
//     the Q tile stays in shared memory for the whole key loop;
//   * per 64-key tile, K is staged row-major and V transposed in shared
//     memory, then each warp computes its 16 x 64 logits with
//     mma.sync.m16n8k16 (bf16 in, fp32 accumulate) into registers;
//   * the online softmax (fp32, base 2 with log2(e)/sqrt(d) folded into
//     one multiply) runs on those registers, and the probabilities feed the
//     P V product directly as bf16 A operands: logits, probabilities and the
//     fp32 output accumulator never leave registers;
//   * the head dim is a compile-time width: the true d rounded up to 48,
//     80, 160 (the main path's 40/80/160) or 256 (the wrapper's limit),
//     padded with zeros in shared memory while the scale stays the true
//     1/sqrt(d).
// Keys past Sk (the 77-key tail, or any Sk off the tile) get -1e30 logits
// and zero V rows; l is clamped at 1e-30. Not yet done: cp.async/TMA double
// buffering of the K/V tiles and wgmma, which the next version can add.
#include "flash_common.cuh"

namespace icd {

constexpr int kB1Rows = 64;  // query rows per block
constexpr int kB1Keys = 64;  // keys per tile

template <int DP>
constexpr size_t b1_smem_bytes() {
  return sizeof(bf16) * ((size_t)(kB1Rows + kB1Keys) * (DP + 8) + (size_t)DP * (kB1Keys + 8));
}

template <int DP>
__global__ void __launch_bounds__(128)
flash_fwd_b1(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o, int heads, int sq,
             int sk, int d, float scale_log2) {
  constexpr int LDI = DP + 8;       // Q and K row stride (elements)
  constexpr int LDT = kB1Keys + 8;  // V^T row stride
  constexpr int NS = kB1Keys / 8;   // 8-key tiles of logits per warp
  constexpr int NO = DP / 8;        // 8-column tiles of the accumulator

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kB1Rows * LDI;
  bf16* sVt = sK + kB1Keys * LDI;

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y - b * heads;
  const int q0 = blockIdx.x * kB1Rows;
  const size_t rs = (size_t)heads * d;  // row stride of (B, S, H, D)
  const bf16* kb = k + (size_t)b * sk * rs + (size_t)h * d;
  const bf16* vb = v + (size_t)b * sk * rs + (size_t)h * d;
  bf16* ob = o + (size_t)b * sq * rs + (size_t)h * d;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const bf16* qw = sQ + warp * 16 * LDI;

  load_rows(sQ, LDI, q + ((size_t)b * sq + q0) * rs + (size_t)h * d, rs, kB1Rows, sq - q0, d, DP);

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < sk; k0 += kB1Keys) {
    __syncthreads();  // the previous tile is consumed (and Q is staged)
    load_rows(sK, LDI, kb + (size_t)k0 * rs, rs, kB1Keys, sk - k0, d, DP);
    load_rows_transposed(sVt, LDT, vb + (size_t)k0 * rs, rs, kB1Keys, sk - k0, d, DP);
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

    float alpha[2];
    online_softmax<NS>(s, m, l, alpha, scale_log2, k0, sk, t);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

#pragma unroll
    for (int kk = 0; kk < kB1Keys / 16; ++kk) {
      uint32_t a[4];
      probs_as_a<NS>(a, s, kk);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const bf16* vp = sVt + (n * 8 + g) * LDT + kk * 16 + 2 * t;
        mma_16816(acc[n], a, ld32(vp), ld32(vp + 8));
      }
    }
  }

  store_rows<NO>(ob, rs, acc, l, q0 + warp * 16 + g, sq, 0, d, t);
}

template <int DP>
int launch_b1(const void* q, const void* k, const void* v, void* o, int batch, int heads,
              int sq, int sk, int d, float scale, void* stream) {
  const size_t smem = b1_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_b1<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + kB1Rows - 1) / kB1Rows, batch * heads);
  flash_fwd_b1<DP><<<grid, 128, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), heads, sq, sk, d, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace icd

extern "C" int icd_flash_fwd(const void* q, const void* k, const void* v, void* o,
                             int batch, int heads, int sq, int sk, int d,
                             float scale, void* stream) {
  using namespace icd;
#define ICD_B1_CASE(DP) \
  if (d <= DP) return launch_b1<DP>(q, k, v, o, batch, heads, sq, sk, d, scale, stream);
  ICD_B1_CASE(48)
  ICD_B1_CASE(80)
  ICD_B1_CASE(160)
  ICD_B1_CASE(256)
#undef ICD_B1_CASE
  return (int)cudaErrorInvalidValue;
}
