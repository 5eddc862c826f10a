// Kernel B1: flash-attention forward for head dims <= 256.
//
// Replaces `_fwd_kernel` in invertible_cd_tpu/ops/flash_attention.py
// (launched by `_flash_forward` through `_flash_op`): every UNet self- and
// cross-attention of the SD1.5 main path, at Sq = Sk = 4096/1024/256/64 with
// d = 40/80/160/160, and Sk = 77 for cross-attention.
//
// Bounds on an H100 SXM (700 W) at the hottest shape, Sq = Sk = 4096, d = 40,
// batch 4 x 8 heads: 8.59e10 FLOPs take 0.087 ms at 989 TFLOP/s; 5.37e8
// exponentials (one per logit) take 0.138 ms at 3.9e12/s (the MUFU unit, 16
// a clock per SM); 10.5 MB of q, k, v, o take 0.003 ms at 3.35 TB/s; SDPA's
// forward took 0.364 ms. So below d = 64 the exponentials, not the tensor
// cores, set the floor, and the design has to keep the MUFU busy while the
// products and loads run beside it. The earlier design (4 warps x 16 rows,
// mma.sync, K and V staged synchronously, V transposed by scalar stores,
// kept in flash_mma.cuh for DP = 256 and B5) took 0.979 ms at that
// shape; the Hopper design:
//   * one block = 128 query rows of one (batch, head), two warpgroups of 64
//     rows; the Q tile stays in shared memory for the whole key loop;
//   * S = Q K^T is wgmma.m64n64k16 over a 64-key tile, reading Q and K from
//     shared memory, the head dim padded to a multiple of 16 only (3 k-steps
//     at d = 40); at d <= 80 a thread stays under 128 registers, so two
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
//   * the softmax is base 2 with the scale folded into one FFMA a logit,
//     p = exp2(s * c - m * c) with c = log2(e) / sqrt(d), one fp32
//     ex2.approx.ftz each (the lse entry point needs fp32); the row sums
//     stay per thread until the end; alpha rescales the accumulator between
//     the two products.
// The warpgroups of an SM (four at d <= 80) run independently between the
// barriers, so one's softmax overlaps another's products; an explicit
// ping-pong of the two warpgroups of a block over named barriers measured
// slower. Keys past Sk (the 77-key tail, or any Sk off the tile) get -1e30
// logits on the last tile only and zero V rows; l is clamped at 1e-30. The
// second entry point also writes the fp32 row logsumexp (natural log,
// (B, H, Sq)) that the backward kernels B3 and B4 recompute the
// probabilities from; the inference entry point writes nothing more, as the
// reference's `_flash_op` does.
//
// Head dims above 160 (DP = 256: off every path of the port, where the
// accumulator alone would take 128 registers a thread) take the earlier
// mma.sync loop of flash_mma.cuh, which B5 shares, as a static route by
// head dim.
#include "flash_common.cuh"
#include "flash_mma.cuh"
#include "hopper.cuh"

namespace icd {

// ---- Hopper route, padded head dims 48, 80 and 160 ----
constexpr int kB1Rows = 128;   // query rows per block: two warpgroups of 64
constexpr int kB1Stages = 3;   // K/V tiles in the ring, loaded two ahead

// Keys per tile: 64. At DP = 48 and 80 that keeps a thread under 128
// registers, so two blocks (four warpgroups) share an SM and one block's
// softmax runs under the other's products; 128-key tiles, one block an SM,
// measured slower at both. At DP = 160 the accumulator alone takes 80
// registers: one block an SM.
constexpr int kB1Keys = 64;

template <int DP>
__host__ __device__ constexpr int b1_min_blocks() {
  return DP <= 80 ? 2 : 1;
}

template <int DP>
constexpr size_t b1_smem_bytes() {
  return sizeof(bf16) * ((size_t)kB1Rows * DP + (size_t)kB1Stages * 2 * kB1Keys * DP);
}

// One tile's softmax for rows g (index 0) and g+8 (index 1) of a warp: the
// raw logits `s` in (keys at or past sk masked on the ragged last tile), the
// running max `m` (raw units) updated, P out as bf16 A operands (k-step
// n / 2), alpha the factor the accumulator and the row sums take, `sum`
// this thread's share of the tile's row sums.
template <int NS>
__device__ __forceinline__ void b1_softmax(float (&s)[NS][4], uint32_t (&pa)[NS / 2][4],
                                           float (&m)[2], float (&alpha)[2], float (&sum)[2],
                                           float scale_log2, int k0, int sk, int t) {
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

template <int DP>
__global__ void __launch_bounds__(256, b1_min_blocks<DP>())
flash_fwd_b1(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
             int heads, int sq, int sk, int d, float scale_log2) {
  constexpr int KT = kB1Keys;
  constexpr int NS = KT / 8;                // 8-key column tiles of S
  constexpr int NO = DP / 8;                // 8-column tiles of the accumulator
  constexpr uint32_t kGroup = DP * 16;      // bytes between 8-row groups of a tile
  constexpr int kTile = KT * DP;            // elements of one K or V tile

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kB1Rows * DP;
  bf16* sV = sK + kB1Stages * kTile;

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y - b * heads;
  const int q0 = blockIdx.x * kB1Rows;
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
    const int st = j % kB1Stages;
    load_tile_async<DP>(sK + st * kTile, kb + (size_t)j * KT * rs, rs, KT, sk - j * KT, d, tid, 256);
    load_tile_async<DP>(sV + st * kTile, vb + (size_t)j * KT * rs, rs, KT, sk - j * KT, d, tid, 256);
  };
  load_tile_async<DP>(sQ, q + ((size_t)b * sq + q0) * rs + (size_t)h * d, rs, kB1Rows, sq - q0, d,
                      tid, 256);
#pragma unroll
  for (int j = 0; j < kB1Stages - 1; ++j) {
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
    cp_async_wait<kB1Stages - 2>();  // tile j (and Q) landed, for this thread's copies
    fence_proxy_async();
    __syncthreads();                 // for every thread's; and tile j-1's stage is free
    if (j + kB1Stages - 1 < nt) load_kv(j + kB1Stages - 1);
    cp_async_commit();

    const uint64_t stage = (uint64_t)(j % kB1Stages) * kStageStep;
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
    b1_softmax<NS>(s, pa, m, alpha, sum, scale_log2, j * KT, sk, t);
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
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
  if (lse != nullptr) {
    const float m2[2] = {m[0] * scale_log2, m[1] * scale_log2};
    store_lse(lse + (size_t)blockIdx.y * sq, m2, l, row0, sq, t);
  }
}

template <int DP>
int launch_b1(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
              int heads, int sq, int sk, int d, float scale, void* stream) {
  const size_t smem = b1_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_b1<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + kB1Rows - 1) / kB1Rows, batch * heads);
  flash_fwd_b1<DP><<<grid, 256, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), heads, sq, sk, d, scale * kLog2e);
  return (int)cudaGetLastError();
}

// ---- the mma.sync route, padded head dim 256 only ----
// B1's softmax on the shared mma.sync loop (flash_mma.cuh): base 2, the
// logits times scale * log2(e), m and l in the base-2 units store_lse takes.
struct B1MmaSoftmax {
  static constexpr bool kRescale = true;
  template <int NS>
  __device__ static void tile(float (&s)[NS][4], uint32_t (&p)[NS][2], float (&m)[2],
                              float (&l)[2], float (&alpha)[2], float scale_log2, int k0, int sk,
                              int t) {
    online_softmax<NS>(s, m, l, alpha, scale_log2, k0, sk, t);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      p[n][0] = pack_bf16(s[n][0], s[n][1]);
      p[n][1] = pack_bf16(s[n][2], s[n][3]);
    }
  }
};

int dispatch_b1(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
                int heads, int sq, int sk, int d, float scale, void* stream) {
  if (d <= 48) return launch_b1<48>(q, k, v, o, lse, batch, heads, sq, sk, d, scale, stream);
  if (d <= 80) return launch_b1<80>(q, k, v, o, lse, batch, heads, sq, sk, d, scale, stream);
  if (d <= 160) return launch_b1<160>(q, k, v, o, lse, batch, heads, sq, sk, d, scale, stream);
  if (d <= 256) {
    return launch_fwd_mma<256, B1MmaSoftmax>(q, k, v, o, lse, batch, heads, sq, sk, d,
                                            scale * kLog2e, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace icd

extern "C" int icd_flash_fwd(const void* q, const void* k, const void* v, void* o,
                             int batch, int heads, int sq, int sk, int d,
                             float scale, void* stream) {
  return icd::dispatch_b1(q, k, v, o, nullptr, batch, heads, sq, sk, d, scale, stream);
}

// The same kernel, also writing lse (B, H, Sq) fp32.
extern "C" int icd_flash_fwd_lse(const void* q, const void* k, const void* v, void* o,
                                 void* lse, int batch, int heads, int sq, int sk, int d,
                                 float scale, void* stream) {
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  return icd::dispatch_b1(q, k, v, o, lse, batch, heads, sq, sk, d, scale, stream);
}
