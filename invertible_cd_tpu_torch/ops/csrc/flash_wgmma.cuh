// The Hopper flash-attention forward tile loop, shared by kernel B1
// (flash_fwd.cu: padded head dims 48, 64, 80 and 160) and kernel B5's five
// softmax variants (flash_variant.cu: padded head dims 48, 64 and 128). The
// softmax is the one thing they vary; each passes its own as a policy type.
//
// The design (B1's, see flash_fwd.cu for its bounds):
//   * one block = 128 query rows of one (batch, head), two warpgroups of 64
//     rows; the Q tile stays in shared memory for the whole key loop;
//   * S = Q K^T is wgmma.m64n64k16 over a 64-key tile, reading Q and K from
//     shared memory, the head dim padded to a multiple of 16 only (3 k-steps
//     at d = 40); at DP <= 80 a thread stays under 128 registers, so two
//     blocks share an SM;
//   * O += P V is wgmma with P straight from the S registers as the A
//     operand and V read from shared memory MN-major, in the layout K has
//     (wgmma transposes bf16 itself): no transposed copy of V;
//   * K and V arrive through a ring of 3 stages filled with cp.async by all
//     threads two tiles ahead (16-byte chunks; the pad columns and rows past
//     Sk are zero-filled by the copy itself), so the loads of tiles j+1 and
//     j+2 run under the products and the softmax of tile j; one barrier a
//     tile. cp.async rather than TMA: the (B, S, H, D) layout interleaves
//     heads, so a TMA box wider than d = 40 would read the next head, and
//     d = 40 is no swizzle width;
//   * the policy's softmax turns a tile of raw logits into P, in the
//     registers of the P V product's A operand, and gives this thread's
//     share of the tile's row sums: the row sums stay per thread until the
//     end; alpha rescales the accumulator between the two products.
// The warpgroups of an SM (four at DP <= 80) run independently between the
// barriers, so one's softmax overlaps another's products. Keys past Sk (the
// 77-key tail, or any Sk off the tile) get -1e30 logits on the last tile
// only and zero V rows; l is clamped at 1e-30.
//
// A Softmax policy provides
//   static constexpr bool kRescale;  // the accumulator and the row sums take alpha
//   static constexpr bool kLse;      // m is kept in raw logit units and `scale`
//                                    // is the base-2 factor, so the kernel can
//                                    // write lse = ln2 (m scale + log2 l)
//   template <int NS> static __device__ void tile(
//       float (&s)[NS][4], uint32_t (&pa)[NS / 2][4], float (&m)[2], float (&alpha)[2],
//       float (&sum)[2], float scale, int k0, int sk, int t);
// which takes one tile's raw logits `s` of rows g (index 0) and g+8
// (index 1) of a warp (keys at or past sk to be masked on the ragged last
// tile), updates the running max `m`, gives P as the bf16 A operands of the
// P V product (k-step n / 2 holds 8-key tiles n and n+1), alpha, and
// `sum`, this thread's share of the tile's row sums.
#pragma once

#include "flash_common.cuh"
#include "hopper.cuh"

namespace icd {

constexpr int kWgRows = 128;  // query rows per block: two warpgroups of 64
constexpr int kWgStages = 3;  // K/V tiles in the ring, loaded two ahead

// Keys per tile: 64. At DP <= 80 that keeps a thread under 128 registers, so
// two blocks (four warpgroups) share an SM and one block's softmax runs
// under the other's products; 128-key tiles, one block an SM, measured
// slower at DP 48 and 80. At DP = 128 and 160 the accumulator alone takes 64
// and 80 registers: one block an SM. B5's bf16 variants round at this tile's
// running max (flash_variant.KEY_TILE).
constexpr int kWgKeys = 64;

template <int DP>
__host__ __device__ constexpr int wgmma_min_blocks() {
  return DP <= 80 ? 2 : 1;
}

template <int DP>
constexpr size_t wgmma_smem_bytes() {
  return sizeof(bf16) * ((size_t)kWgRows * DP + (size_t)kWgStages * 2 * kWgKeys * DP);
}

// B1's softmax: base 2 with the scale folded into one FFMA a logit,
// p = exp2(s * c - m * c) with `scale` = c = log2(e) / sqrt(d), one fp32
// ex2.approx.ftz each (the lse entry point needs fp32); m in raw units.
// B2 (flash_fwd_streamed.cu) takes it too.
struct B1Softmax {
  static constexpr bool kRescale = true;
  static constexpr bool kLse = true;
  template <int NS>
  __device__ static void tile(float (&s)[NS][4], uint32_t (&pa)[NS / 2][4], float (&m)[2],
                              float (&alpha)[2], float (&sum)[2], float scale_log2, int k0,
                              int sk, int t) {
    if (k0 + NS * 8 > sk) {  // the ragged last tile
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (k0 + n * 8 + 2 * t + (e & 1) >= sk) s[n][e] = kNegInf;
        }
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = fast_exp2((m[r] - mx[r]) * scale_log2);
      m[r] = mx[r];
      mc[r] = mx[r] * scale_log2;
    }
    sum[0] = sum[1] = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const float p0 = fast_exp2(fmaf(s[n][0], scale_log2, -mc[0]));
      const float p1 = fast_exp2(fmaf(s[n][1], scale_log2, -mc[0]));
      const float p2 = fast_exp2(fmaf(s[n][2], scale_log2, -mc[1]));
      const float p3 = fast_exp2(fmaf(s[n][3], scale_log2, -mc[1]));
      sum[0] += p0 + p1;
      sum[1] += p2 + p3;
      pa[n / 2][(n % 2) * 2] = pack_bf16(p0, p1);
      pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
  }
};

template <int DP, class Softmax>
__global__ void __launch_bounds__(256, wgmma_min_blocks<DP>())
flash_fwd_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                int heads, int sq, int sk, int d, float scale) {
  constexpr int KT = kWgKeys;
  constexpr int NS = KT / 8;                // 8-key column tiles of S
  constexpr int NO = DP / 8;                // 8-column tiles of the accumulator
  constexpr uint32_t kGroup = DP * 16;      // bytes between 8-row groups of a tile
  constexpr int kTile = KT * DP;            // elements of one K or V tile

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kWgRows * DP;
  bf16* sV = sK + kWgStages * kTile;

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y - b * heads;
  const int q0 = blockIdx.x * kWgRows;
  const size_t rs = (size_t)heads * d;  // row stride of (B, S, H, D)
  const bf16* kb = k + (size_t)b * sk * rs + (size_t)h * d;
  const bf16* vb = v + (size_t)b * sk * rs + (size_t)h * d;
  bf16* ob = o + (size_t)b * sq * rs + (size_t)h * d;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int nt = (sk + KT - 1) / KT;

  auto load_kv = [&](int j) {
    const int st = j % kWgStages;
    load_tile_async<DP>(sK + st * kTile, kb + (size_t)j * KT * rs, rs, KT, sk - j * KT, d, tid, 256);
    load_tile_async<DP>(sV + st * kTile, vb + (size_t)j * KT * rs, rs, KT, sk - j * KT, d, tid, 256);
  };
  load_tile_async<DP>(sQ, q + ((size_t)b * sq + q0) * rs + (size_t)h * d, rs, kWgRows, sq - q0, d,
                      tid, 256);
#pragma unroll
  for (int j = 0; j < kWgStages - 1; ++j) {
    if (j < nt) load_kv(j);
    cp_async_commit();  // one group a tile, empty past the last, so the counts stay aligned
  }

  // descriptors: Q of this warpgroup and stage 0 of K (K-major: LBO along
  // the head dim, SBO along the rows), stage 0 of V (MN-major: LBO along
  // the keys, SBO along the head dim); a k-step of 16 advances Q/K by two
  // core matrices (256 bytes) and V by two 8-key groups
  const uint64_t desc_q = smem_desc(sQ + wg * 64 * DP, 128, kGroup);
  const uint64_t desc_k = smem_desc(sK, 128, kGroup);
  const uint64_t desc_v = smem_desc(sV, kGroup, 128);
  constexpr uint64_t kStageStep = (uint64_t)kTile * sizeof(bf16) / 16;

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  for (int j = 0; j < nt; ++j) {
    cp_async_wait<kWgStages - 2>();  // tile j (and Q) landed, for this thread's copies
    fence_proxy_async();
    __syncthreads();                 // for every thread's; and tile j-1's stage is free
    if (j + kWgStages - 1 < nt) load_kv(j + kWgStages - 1);
    cp_async_commit();

    const uint64_t stage = (uint64_t)(j % kWgStages) * kStageStep;
    float s[NS][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) wgmma_ss(s, desc_q + kk * 16, desc_k + stage + kk * 16, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    float alpha[2];
    uint32_t pa[KT / 16][4];  // P as the A operand, k-step n / 2
    float sum[2];
    Softmax::template tile<NS>(s, pa, m, alpha, sum, scale, j * KT, sk, t);
    if constexpr (Softmax::kRescale) {
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] += sum[r];
    }

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      wgmma_rs(acc, pa[kk], desc_v + stage + (uint64_t)kk * (2 * kGroup / 16), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int row0 = q0 + wg * 64 + warp * 16 + g;
  store_rows<NO>(ob, rs, acc, l, row0, sq, 0, d, t);
  if constexpr (Softmax::kLse) {
    if (lse != nullptr) {
      const float m2[2] = {m[0] * scale, m[1] * scale};
      store_lse(lse + (size_t)blockIdx.y * sq, m2, l, row0, sq, t);
    }
  }
}

template <int DP, class Softmax>
int launch_fwd_wgmma(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
                     int heads, int sq, int sk, int d, float scale, void* stream) {
  const size_t smem = wgmma_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<DP, Softmax>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + kWgRows - 1) / kWgRows, batch * heads);
  flash_fwd_wgmma<DP, Softmax><<<grid, 256, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), heads, sq, sk, d, scale);
  return (int)cudaGetLastError();
}

// One product of each kind the loop issues, at padded head dim DP, for a
// card test of the descriptors (LBO/SBO) at that width: one warpgroup takes
// q, k, v of 64 rows x d (row-major, d <= DP, a multiple of 8), writes
// s = q k^T (64 x 64 fp32) from wgmma_ss and o = bf16(s) v (64 x d fp32)
// from wgmma_rs, with the loop's tile layout, copies and descriptors.
template <int DP>
__global__ void __launch_bounds__(128)
wgmma_product_check(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, float* __restrict__ s_out,
                    float* __restrict__ o_out, int d) {
  constexpr int NO = DP / 8;
  constexpr uint32_t kGroup = DP * 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + 64 * DP;
  bf16* sV = sK + 64 * DP;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int t = tid % 4;
  load_tile_async<DP>(sQ, q, d, 64, 64, d, tid, 128);
  load_tile_async<DP>(sK, k, d, 64, 64, d, tid, 128);
  load_tile_async<DP>(sV, v, d, 64, 64, d, tid, 128);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  const uint64_t desc_q = smem_desc(sQ, 128, kGroup);
  const uint64_t desc_k = smem_desc(sK, 128, kGroup);
  const uint64_t desc_v = smem_desc(sV, kGroup, 128);
  float s[8][4];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) wgmma_ss(s, desc_q + kk * 16, desc_k + kk * 16, kk);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);

  uint32_t pa[4][4];
  const int row = warp * 16 + g;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = n * 8 + 2 * t;
    s_out[row * 64 + col] = s[n][0];
    s_out[row * 64 + col + 1] = s[n][1];
    s_out[(row + 8) * 64 + col] = s[n][2];
    s_out[(row + 8) * 64 + col + 1] = s[n][3];
    pa[n / 2][(n % 2) * 2] = pack_bf16(s[n][0], s[n][1]);
    pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(s[n][2], s[n][3]);
  }
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, pa[kk], desc_v + (uint64_t)kk * (2 * kGroup / 16), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = n * 8 + 2 * t;
    if (col < d) {
      o_out[row * d + col] = acc[n][0];
      o_out[row * d + col + 1] = acc[n][1];
      o_out[(row + 8) * d + col] = acc[n][2];
      o_out[(row + 8) * d + col + 1] = acc[n][3];
    }
  }
}

template <int DP>
int launch_wgmma_product_check(const void* q, const void* k, const void* v, void* s, void* o,
                               int d, void* stream) {
  const size_t smem = sizeof(bf16) * 3 * 64 * DP;
  cudaError_t err = cudaFuncSetAttribute(
      wgmma_product_check<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  wgmma_product_check<DP><<<1, 128, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<float*>(s), static_cast<float*>(o), d);
  return (int)cudaGetLastError();
}

}  // namespace icd
