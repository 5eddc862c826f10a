// Kernel B3: flash-attention backward, the query gradient, head dims <= 256.
//
// Replaces `_dq_kernel` in invertible_cd_tpu/ops/flash_attention.py
// (launched by `_flash_backward`, the backward of `_flash_op`): every UNet
// self- and cross-attention that a training step differentiates, at the
// shapes of B1 (Sq = Sk = 4096/1024/256/64 with d = 40/80/160/160, and
// Sk = 77 for cross-attention).
//
// Per query row of one (batch, head), over every key:
//   S  = Q K^T                  P  = exp(scale * S - lse)
//   dP = dO V^T                 dS = P * (dP - delta),  delta = rowsum(dO * O)
//   dQ = scale * sum over keys of dS K
//
// What bounds it on an H100 SXM (700 W) at the hottest shape, Sq = Sk =
// 4096, d = 40, batch 4 x 8 heads: three products of 2 Sq Sk d each, 1.29e11
// FLOPs, take 0.130 ms at 989 TFLOP/s; one exponential a (query, key),
// 5.4e8, takes 0.138 ms on the MUFU unit, the floor; the bytes take
// microseconds. At Sk = 77 and at 64 tokens the work is microseconds and
// launch overhead rules. The earlier design (4 warps x 16 query rows,
// mma.sync, K and V staged synchronously behind two barriers a tile, 64-row
// blocks reading K and V Sq/64 times) took 1.06 ms there. The Hopper design,
// at padded head dims 48, 64 and 80, is B1's (flash_fwd.cu):
//   * one block = 128 query rows of one (batch, head), two warpgroups of 64
//     rows; the Q and dO tiles stay in shared memory for the whole key loop;
//   * S = Q K^T and dP = dO V^T are wgmma.m64n64k16 over a 64-key tile, all
//     operands K-major in shared memory;
//   * dQ += dS K is wgmma m64n48/n64/n80k16 with dS straight from the
//     accumulator registers as the A operand and K read MN-major from the
//     tile the first product read K-major (as B1 reads V): no transposed copy;
//   * K and V arrive through a ring of 3 stages filled with cp.async by all
//     threads two tiles ahead, one barrier a tile; P = exp2(S * c - lse2) is
//     one FFMA and one ex2.approx.ftz a logit, c = log2(e) / sqrt(d), from
//     the saved logsumexp: no running max, the loop carries only dQ;
//   * delta is computed in the prologue straight from dO and O in global
//     memory (two threads a row), under the first tiles' copies; it is not
//     written out: B4 computes its own, so either kernel runs without the
//     other.
// A thread takes 116 registers at DP = 48, so two blocks share an SM as in
// B1, and 148 at DP = 80, one block an SM. DP = 64 is SDXL's head dim (640
// channels over 10 heads, 1280 over 20); its rows are 128 bytes, and the
// layout (8x8 core matrices, no swizzle: LBO 128 bytes, SBO DP * 16) and the
// descriptors are written in DP, so only the dispatch and the occupancy
// below are its own. Nothing was tried beyond B1's own alternatives
// (flash_fwd.cu), which this design inherits.
// Keys past Sk get P = 0 on the ragged last tile (their K and V rows are
// zero). Query rows past Sq have zero Q and dO rows; their dQ is never
// stored.
//
// Head dims above 80 (DP = 160, 256: the 256- and 64-token shapes, where
// the earlier design already beats SDPA's backward) keep the earlier
// mma.sync loop as a static route by head dim.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace icd {

// ---- Hopper route, padded head dims 48, 64 and 80 ----
constexpr int kB3Rows = 128;   // query rows per block: two warpgroups of 64
constexpr int kB3Keys = 64;    // keys per tile
constexpr int kB3Stages = 3;   // K/V tiles in the ring, loaded two ahead

template <int DP>
__host__ __device__ constexpr int b3_min_blocks() {
  return DP <= 64 ? 2 : 1;
}

template <int DP>
constexpr size_t b3_smem_bytes() {
  return sizeof(bf16) * ((size_t)2 * kB3Rows * DP + (size_t)kB3Stages * 2 * kB3Keys * DP) +
         sizeof(float2) * kB3Rows;
}

template <int DP>
__global__ void __launch_bounds__(256, b3_min_blocks<DP>())
flash_bwd_dq_b3(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ o,
                const bf16* __restrict__ dout, const float* __restrict__ lse,
                bf16* __restrict__ dq, int heads, int sq, int sk, int d, float scale,
                float scale_log2) {
  constexpr int KT = kB3Keys;
  constexpr int NS = KT / 8;                // 8-key column tiles of S and dP
  constexpr int NO = DP / 8;                // 8-column tiles of the dQ accumulator
  constexpr uint32_t kGroup = DP * 16;      // bytes between 8-row groups of a tile
  constexpr int kTile = KT * DP;            // elements of one K or V tile

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + kB3Rows * DP;
  bf16* sK = sdO + kB3Rows * DP;
  bf16* sV = sK + kB3Stages * kTile;
  float2* sRow = reinterpret_cast<float2*>(sV + kB3Stages * kTile);  // (lse2, delta)

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y - b * heads;
  const int q0 = blockIdx.x * kB3Rows;
  const size_t rs = (size_t)heads * d;  // row stride of (B, S, H, D)
  const size_t qoff = ((size_t)b * sq + q0) * rs + (size_t)h * d;
  const bf16* kb = k + (size_t)b * sk * rs + (size_t)h * d;
  const bf16* vb = v + (size_t)b * sk * rs + (size_t)h * d;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int nt = (sk + KT - 1) / KT;

  auto load_kv = [&](int j) {
    const int st = j % kB3Stages;
    load_tile_async<DP>(sK + st * kTile, kb + (size_t)j * KT * rs, rs, KT, sk - j * KT, d, tid, 256);
    load_tile_async<DP>(sV + st * kTile, vb + (size_t)j * KT * rs, rs, KT, sk - j * KT, d, tid, 256);
  };
  load_tile_async<DP>(sQ, q + qoff, rs, kB3Rows, sq - q0, d, tid, 256);
  load_tile_async<DP>(sdO, dout + qoff, rs, kB3Rows, sq - q0, d, tid, 256);
#pragma unroll
  for (int j = 0; j < kB3Stages - 1; ++j) {
    if (j < nt) load_kv(j);
    cp_async_commit();  // one group a tile, empty past the last, so the counts stay aligned
  }

  // lse2 and delta of the block's rows, two threads a row, each over every
  // other 8-column chunk, while the copies run
  {
    const int r = tid >> 1;
    const int row = q0 + r;
    float sum = 0.f;
    if (row < sq) {
      const size_t off = qoff + (size_t)r * rs;
      for (int c = (tid & 1) * 8; c < d; c += 16) {
        const uint4 x4 = *reinterpret_cast<const uint4*>(dout + off + c);
        const uint4 y4 = *reinterpret_cast<const uint4*>(o + off + c);
        const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&x4);
        const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&y4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 xf = __bfloat1622float2(x[i]);
          const float2 yf = __bfloat1622float2(y[i]);
          sum += xf.x * yf.x + xf.y * yf.y;
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if ((tid & 1) == 0) {
      sRow[r] = make_float2(row < sq ? lse[(size_t)blockIdx.y * sq + row] * kLog2e : 0.f, sum);
    }
  }
  __syncthreads();
  const int rloc = wg * 64 + warp * 16 + g;  // this thread's rows: rloc and rloc + 8
  const float2 row_a = sRow[rloc];
  const float2 row_b = sRow[rloc + 8];
  const float lse2[2] = {row_a.x, row_b.x};
  const float delta[2] = {row_a.y, row_b.y};

  // descriptors: this warpgroup's Q and dO (A, K-major: LBO along the head
  // dim, SBO along the rows); stage 0 of K and V as the B of S and dP
  // (K-major) and of K as the B of dQ (MN-major: LBO along the keys, SBO
  // along the head dim); a k-step of 16 advances K-major operands by two
  // core matrices (256 bytes) and the MN-major one by two 8-key groups
  const uint64_t desc_q = smem_desc(sQ + wg * 64 * DP, 128, kGroup);
  const uint64_t desc_do = smem_desc(sdO + wg * 64 * DP, 128, kGroup);
  const uint64_t desc_k = smem_desc(sK, 128, kGroup);
  const uint64_t desc_v = smem_desc(sV, 128, kGroup);
  const uint64_t desc_kn = smem_desc(sK, kGroup, 128);
  constexpr uint64_t kStageStep = (uint64_t)kTile * sizeof(bf16) / 16;

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = 0; j < nt; ++j) {
    cp_async_wait<kB3Stages - 2>();  // tile j (and Q, dO) landed, for this thread's copies
    fence_proxy_async();
    __syncthreads();                 // for every thread's; and tile j-1's stage is free
    if (j + kB3Stages - 1 < nt) load_kv(j + kB3Stages - 1);
    cp_async_commit();

    const uint64_t stage = (uint64_t)(j % kB3Stages) * kStageStep;
    float s[NS][4];
    float dp[NS][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) wgmma_ss(s, desc_q + kk * 16, desc_k + stage + kk * 16, kk);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) wgmma_ss(dp, desc_do + kk * 16, desc_v + stage + kk * 16, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // dS as bf16 A operands (k-step n / 2): rows g and g + 8, keys
    // j * 64 + 8n + 2t and + 1; keys past Sk masked on the ragged last tile
    const int k0 = j * KT;
    const bool ragged = k0 + KT > sk;
    uint32_t da[KT / 16][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = fast_exp2(fmaf(s[n][e], scale_log2, -lse2[e >> 1]));
        if (ragged && k0 + n * 8 + 2 * t + (e & 1) >= sk) p[e] = 0.f;
      }
      da[n / 2][(n % 2) * 2] = pack_bf16(p[0] * (dp[n][0] - delta[0]), p[1] * (dp[n][1] - delta[0]));
      da[n / 2][(n % 2) * 2 + 1] =
          pack_bf16(p[2] * (dp[n][2] - delta[1]), p[3] * (dp[n][3] - delta[1]));
    }

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      wgmma_rs(acc, da[kk], desc_kn + stage + (uint64_t)kk * (2 * kGroup / 16), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }
  cp_async_wait<0>();

  const float mul[2] = {scale, scale};
  store_rows_scaled<NO>(dq + qoff - (size_t)q0 * rs, rs, acc, mul, q0 + rloc, sq, 0, d, t);
}

template <int DP>
int launch_b3(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const void* lse, void* dq, int batch, int heads, int sq, int sk, int d,
              float scale, void* stream) {
  const size_t smem = b3_smem_bytes<DP>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_b3<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((sq + kB3Rows - 1) / kB3Rows, batch * heads);
  flash_bwd_dq_b3<DP><<<grid, 256, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<bf16*>(dq), heads, sq, sk, d, scale,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

// ---- the mma.sync route, padded head dims 160 and 256 ----
constexpr int kB3MmaRows = 64;  // query rows per block
constexpr int kB3MmaKeys = 64;  // keys per tile

template <int DP>
constexpr size_t b3_mma_smem_bytes() {
  return sizeof(bf16) * (size_t)(2 * kB3MmaRows + 2 * kB3MmaKeys) * (DP + 8);
}

// 4 warps x 16 query rows; Q and dO stay in shared memory, K and V are
// staged per tile with plain loads; dS comes out of mma.sync.m16n8k16 as
// the A operand of dS K, and K is read as its B operand with ldmatrix.trans.
// delta is computed from the O tile, staged once in the K buffer before the
// key loop.
template <int DP>
__global__ void __launch_bounds__(128)
flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ o,
                 const bf16* __restrict__ dout, const float* __restrict__ lse,
                 bf16* __restrict__ dq, int heads, int sq, int sk, int d, float scale,
                 float scale_log2) {
  static_assert(kB3MmaRows == kB3MmaKeys, "the O tile is staged in the K buffer");
  constexpr int LDI = DP + 8;         // row stride of every tile (elements)
  constexpr int NS = kB3MmaKeys / 8;  // 8-key tiles of S and dP per warp
  constexpr int NO = DP / 8;          // 8-column tiles of the dQ accumulator

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + kB3MmaRows * LDI;
  bf16* sK = sdO + kB3MmaRows * LDI;
  bf16* sV = sK + kB3MmaKeys * LDI;

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y - b * heads;
  const int q0 = blockIdx.x * kB3MmaRows;
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

  load_rows(sQ, LDI, q + qoff, rs, kB3MmaRows, sq - q0, d, DP);
  load_rows(sdO, LDI, dout + qoff, rs, kB3MmaRows, sq - q0, d, DP);
  load_rows(sK, LDI, o + qoff, rs, kB3MmaRows, sq - q0, d, DP);  // O, until the key loop

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

  for (int k0 = 0; k0 < sk; k0 += kB3MmaKeys) {
    __syncthreads();  // the previous tile (or the staged O) is consumed
    load_rows(sK, LDI, kb + (size_t)k0 * rs, rs, kB3MmaKeys, sk - k0, d, DP);
    load_rows(sV, LDI, vb + (size_t)k0 * rs, rs, kB3MmaKeys, sk - k0, d, DP);
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
    for (int kk = 0; kk < kB3MmaKeys / 16; ++kk) {
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
int launch_b3_mma(const void* q, const void* k, const void* v, const void* o, const void* dout,
                  const void* lse, void* dq, int batch, int heads, int sq, int sk, int d,
                  float scale, void* stream) {
  const size_t smem = b3_mma_smem_bytes<DP>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_mma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((sq + kB3MmaRows - 1) / kB3MmaRows, batch * heads);
  flash_bwd_dq_mma<DP><<<grid, 128, smem, (cudaStream_t)stream>>>(
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
  if (d <= 48) return launch_b3<48>(q, k, v, o, dout, lse, dq, batch, heads, sq, sk, d, scale, stream);
  if (d <= 64) return launch_b3<64>(q, k, v, o, dout, lse, dq, batch, heads, sq, sk, d, scale, stream);
  if (d <= 80) return launch_b3<80>(q, k, v, o, dout, lse, dq, batch, heads, sq, sk, d, scale, stream);
  if (d <= 160) return launch_b3_mma<160>(q, k, v, o, dout, lse, dq, batch, heads, sq, sk, d, scale, stream);
  if (d <= 256) return launch_b3_mma<256>(q, k, v, o, dout, lse, dq, batch, heads, sq, sk, d, scale, stream);
  return (int)cudaErrorInvalidValue;
}
