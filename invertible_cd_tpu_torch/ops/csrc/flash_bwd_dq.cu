// Kernel B3: flash-attention backward, the query gradient, head dims <= 256.
//
// Replaces `_dq_kernel` in invertible_cd_tpu/ops/flash_attention.py
// (launched by `_flash_backward`, the backward of `_flash_op`): every UNet
// self- and cross-attention that a training step differentiates, at the
// shapes of B1 (Sq = Sk = 4096/1024/256/64 with d = 40/80/160/160, and
// Sk = 77 for cross-attention).
//
// Per 64 query rows of one (batch, head), looping over 64-key tiles:
//   S  = Q K^T                  P  = exp(scale * S - lse)
//   dP = dO V^T                 dS = P * (dP - delta),  delta = rowsum(dO * O)
//   dQ = scale * sum over tiles of dS K
//
// What bounds it on an H100: operations, three products of 2*Sq*Sk*d each,
// on inputs that are read once per block; at 4096 tokens and d = 40 that is
// about 1500 operations per byte of Q/K/V/O/dO/dQ. At Sk = 77 and at 64
// tokens the work is microseconds and launch overhead rules.
//
// Design, as in B1: one block = 4 warps x 16 query rows; Q and dO stay in
// shared memory for the whole key loop; each warp's 16 x 64 tiles of S and
// dP are mma.sync.m16n8k16 accumulators in registers; P is recomputed from
// the saved logsumexp (no running max or rescaling: the loop carries only
// the dQ accumulator), dS is rounded to bf16 in the accumulator layout, which
// is already the A operand of dS K, and K is read as that product's B operand
// straight from its row-major tile with ldmatrix.trans (no transposed copy).
// delta is computed in this kernel from dO and O, as the TPU kernel does: the
// O tile is staged once in the K buffer before the key loop, each quad sums
// its rows. It is not written out; B4 computes its own, so either kernel can
// run without the other.
// Keys at or past Sk get P = 0 (not exp(garbage - lse)) and their K/V rows are
// zero in shared memory. Query rows at or past Sq have zero Q and dO rows, so
// their dS is zero; their lse is never read and their dQ never stored. The
// head dim is a compile-time width (48/80/160/256) padded with zeros in
// shared memory; the scale is the true 1/sqrt(d).
#include "flash_common.cuh"

namespace icd {

constexpr int kB3Rows = 64;  // query rows per block
constexpr int kB3Keys = 64;  // keys per tile

template <int DP>
constexpr size_t b3_smem_bytes() {
  return sizeof(bf16) * (size_t)(2 * kB3Rows + 2 * kB3Keys) * (DP + 8);
}

template <int DP>
__global__ void __launch_bounds__(128)
flash_bwd_dq_b3(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ o,
                const bf16* __restrict__ dout, const float* __restrict__ lse,
                bf16* __restrict__ dq, int heads, int sq, int sk, int d, float scale,
                float scale_log2) {
  static_assert(kB3Rows == kB3Keys, "the O tile is staged in the K buffer");
  constexpr int LDI = DP + 8;      // row stride of every tile (elements)
  constexpr int NS = kB3Keys / 8;  // 8-key tiles of S and dP per warp
  constexpr int NO = DP / 8;       // 8-column tiles of the dQ accumulator

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + kB3Rows * LDI;
  bf16* sK = sdO + kB3Rows * LDI;
  bf16* sV = sK + kB3Keys * LDI;

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y - b * heads;
  const int q0 = blockIdx.x * kB3Rows;
  const size_t rs = (size_t)heads * d;  // row stride of (B, S, H, D)
  const size_t qoff = ((size_t)b * sq + q0) * rs + (size_t)h * d;
  const bf16* kb = k + (size_t)b * sk * rs + (size_t)h * d;
  const bf16* vb = v + (size_t)b * sk * rs + (size_t)h * d;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const bf16* qw = sQ + warp * 16 * LDI;
  const bf16* dow = sdO + warp * 16 * LDI;
  const int row0 = q0 + warp * 16 + g;

  load_rows(sQ, LDI, q + qoff, rs, kB3Rows, sq - q0, d, DP);
  load_rows(sdO, LDI, dout + qoff, rs, kB3Rows, sq - q0, d, DP);
  load_rows(sK, LDI, o + qoff, rs, kB3Rows, sq - q0, d, DP);  // O, until the key loop

  float lse2[2];  // lse of rows g and g+8 in the base-2 domain
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse2[r] = row < sq ? lse[(size_t)blockIdx.y * sq + row] * kLog2e : 0.f;
  }
  __syncthreads();

  float delta[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int off = (warp * 16 + g + 8 * r) * LDI;
    for (int c = 2 * t; c < DP; c += 8) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sdO + off + c));
      const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sK + off + c));
      delta[r] += x.x * y.x + x.y * y.y;
    }
    delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 1);
    delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 2);
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int k0 = 0; k0 < sk; k0 += kB3Keys) {
    __syncthreads();  // the previous tile (or the staged O) is consumed
    load_rows(sK, LDI, kb + (size_t)k0 * rs, rs, kB3Keys, sk - k0, d, DP);
    load_rows(sV, LDI, vb + (size_t)k0 * rs, rs, kB3Keys, sk - k0, d, DP);
    __syncthreads();

    float s[NS][4];
    float dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t aq[4], ado[4];
      load_a(aq, qw, LDI, kk, g, t);
      load_a(ado, dow, LDI, kk, g, t);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int off = (n * 8 + g) * LDI + kk + 2 * t;
        mma_16816(s[n], aq, ld32(sK + off), ld32(sK + off + 8));
        mma_16816(dp[n], ado, ld32(sV + off), ld32(sV + off + 8));
      }
    }

    // dS = P * (dP - delta), in place of dP
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        const float p = key < sk ? exp2f(s[n][e] * scale_log2 - lse2[e >> 1]) : 0.f;
        dp[n][e] = p * (dp[n][e] - delta[e >> 1]);
      }
    }

    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < kB3Keys / 16; ++kk) {
      uint32_t a[4];
      probs_as_a<NS>(a, dp, kk);
      const bf16* krow = sK + (kk * 16 + (lane & 15)) * LDI;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, krow + n * 8);
        mma_16816(acc[n], a, b0, b1);
      }
    }
  }

  const float mul[2] = {scale, scale};
  store_rows_scaled<NO>(dq + qoff - (size_t)q0 * rs, rs, acc, mul, row0, sq, 0, d, t);
}

template <int DP>
int launch_b3(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const void* lse, void* dq, int batch, int heads, int sq, int sk, int d,
              float scale, void* stream) {
  const size_t smem = b3_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_b3<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + kB3Rows - 1) / kB3Rows, batch * heads);
  flash_bwd_dq_b3<DP><<<grid, 128, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<bf16*>(dq), heads, sq, sk, d, scale,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace icd

extern "C" int icd_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                const void* dout, const void* lse, void* dq, int batch,
                                int heads, int sq, int sk, int d, float scale, void* stream) {
  using namespace icd;
#define ICD_B3_CASE(DP) \
  if (d <= DP) return launch_b3<DP>(q, k, v, o, dout, lse, dq, batch, heads, sq, sk, d, scale, stream);
  ICD_B3_CASE(48)
  ICD_B3_CASE(80)
  ICD_B3_CASE(160)
  ICD_B3_CASE(256)
#undef ICD_B3_CASE
  return (int)cudaErrorInvalidValue;
}
