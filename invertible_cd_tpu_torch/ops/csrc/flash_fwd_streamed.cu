// Kernel B2: flash-attention forward for large head dims (256 < d <= 512).
//
// Replaces `_fwd_kernel_streamed` in invertible_cd_tpu/ops/flash_attention.py
// (launched by `_flash_forward_streamed` through `_flash_op_streamed`): the
// SD1.5 VAE mid-block's single d = 512 head over 4096 tokens, at batch 4
// and, in a latency-bound generate, batch 1. On the TPU the key axis was a
// sequential grid dimension with m, l and acc persisting in VMEM scratch;
// here a block loops over the key tiles itself, since Hopper blocks run in
// no order and share nothing between them.
//
// What bounds it on an H100 SXM (700 W): operations. One image does
// 4 * 4096^2 * 512 = 34.4 GFLOP (0.035 ms at 989 TFLOP/s) on 17 MB of
// Q/K/V/O (0.005 ms at 3.35 TB/s); the 1.7e7 exponentials take 0.004 ms.
// The earlier design (16 warps, mma.sync, K and V staged synchronously and
// V transposed by scalar stores, a 16-warp exchange of partial logits each
// 32-key tile, one block of 512 threads an SM) reached 72 TFLOP/s.
//
// The design problem is the accumulator: 64 query rows x 512 fp32 columns
// is 128 KB, 256 registers a thread of one warpgroup. Chosen:
//   * one block = 64 query rows of one (batch, head) and two consumer
//     warpgroups; each owns 256 of the 512 output columns, an m64n256 fp32
//     accumulator (128 registers a thread);
//   * the logits need all 512 columns: each warpgroup computes a partial
//     S = Q K^T over its 256 columns of the head dim with wgmma.m64n32k16
//     (Q and K from shared memory, K-major, 16 k-steps), and the two
//     partials meet through 16 KB of shared memory; IEEE addition is
//     commutative, so both warpgroups hold bit-identical S, and with it the
//     same m, l and P;
//   * O_half += P V[:, half] is wgmma.m64n256k16 with P straight from the S
//     registers as the A operand and V read MN-major from the layout K has
//     (hopper.cuh): no transposed copy of V; a warpgroup reads only its half
//     of V, and of K for its partial logits;
//   * K and V arrive through a 2-stage ring of 32-key tiles, tile j+1
//     loading under the products of tile j, so Q (64 KB), two stages of K
//     and V (128 KB) and the exchange (16 KB) take 208 KB, one block an SM;
//   * the loads, not the products, set the time (a build of this loop with
//     its copies removed ran several times faster), and with 64 query rows
//     a block each K/V byte feeds only 64 flops. So the two
//     blocks of neighbouring query tiles form a cluster on two SMs and share
//     each tile: one thread of each issues TMA copies of its half of the
//     tile's keys, multicast into both blocks, and each block's stage
//     barrier (an mbarrier) expects both halves; a second barrier a stage
//     tells the pair that both are done with it before it is refilled. The
//     tensor map (b2_tensor_map) lays the rows out in the wgmma tile layout
//     of hopper.cuh, so the descriptors are B1's. Tried and slower: a
//     cluster of four; the peer's half copied through registers from its
//     shared memory; separate K and V rings refilled half a tile apart;
//   * the softmax is B1's (B1Softmax, flash_wgmma.cuh): base 2, one FFMA
//     and one ex2.approx.ftz a logit, row sums per thread until the end; the
//     accumulator's rescale (128 FMULs a thread) is skipped by a warp whose
//     alphas are all exactly 1 (its running max did not move), which
//     changes no bit;
//   * filling the card: where batch x heads x ceil(Sq / 64) blocks are
//     fewer than the SMs (64 at batch 1), the key tiles are split over a
//     few blocks per query tile (b2_plan); each writes its fp32 partial
//     (unnormalised O, m, l) to the wrapper's workspace, and a second pass
//     (b2_combine) merges the splits in split order. No atomics: repeats are
//     bit-identical.
// Rejected: one warpgroup computing all of S and handing P to the other
// through shared memory leaves the other idle for half of each tile.
// Heads > 1 stay interleaved (row stride heads * d); d < 512 (a multiple of
// 8) is padded with zero columns in shared memory by the copies; rows past
// Sq are zero-filled, and keys past Sk get -1e30 logits on the last tile
// (their K and V rows are zeros, the caller's zero padding up to a multiple
// of 8 rows, or the next batch item's rows, all finite). Query tiles are
// padded to whole clusters; a block past Sq computes rows it never stores.
// The second entry point also writes the row logsumexp for the backward
// (which is plain PyTorch, as the reference's `_streamed_backward_xla` is
// plain XLA).
#include <cuda.h>  // CUtensorMap; cuTensorMapEncodeTiled itself is looked up at run time

#include "flash_common.cuh"
#include "flash_wgmma.cuh"

namespace icd {

constexpr int kB2Dp = 512;               // compile-time head width
constexpr int kB2Half = kB2Dp / 2;       // output columns a warpgroup owns
constexpr int kB2Rows = 64;              // query rows a block
constexpr int kB2Keys = 32;              // keys a tile
constexpr int kB2Stages = 2;             // K/V tiles in the ring
constexpr int kB2MinTiles = 8;           // key tiles a split takes at least
constexpr int kB2Cluster = 2;            // blocks of neighbouring query tiles sharing K/V loads
constexpr int kB2Span = kB2Rows * kB2Cluster;  // query rows of a cluster

constexpr size_t b2_smem_bytes() {  // Q, the ring, the exchange, two barriers per stage
  return sizeof(bf16) * ((size_t)kB2Rows * kB2Dp + (size_t)kB2Stages * 2 * kB2Keys * kB2Dp) +
         sizeof(float) * 2 * kB2Rows * kB2Keys + sizeof(uint64_t) * 2 * kB2Stages;
}

// How the key tiles of each query tile are cut: `tiles` per block, `splits`
// blocks. One block a query tile where the grid fills the SMs; otherwise
// about one block an SM, each split at least kB2MinTiles key tiles.
struct B2Plan {
  int tiles;
  int splits;
};

inline B2Plan b2_plan(int bh, int sq, int sk) {
  const int nt = (sk + kB2Keys - 1) / kB2Keys;
  const long long blocks = (long long)bh * ((sq + kB2Span - 1) / kB2Span) * kB2Cluster;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (blocks >= sms) return {nt, 1};
  const int want = (int)(sms / blocks);
  int tiles = (nt + want - 1) / want;
  if (tiles < kB2MinTiles) tiles = kB2MinTiles;
  if (tiles > nt) tiles = nt;
  return {tiles, (nt + tiles - 1) / tiles};
}

// Workspace bytes: for split key ranges, per split and per query row padded
// to whole clusters of query tiles, the fp32 unnormalised output (512
// columns) and (m, l).
inline size_t b2_workspace_bytes(int batch, int heads, int sq, int sk) {
  const int bh = batch * heads;
  const B2Plan plan = b2_plan(bh, sq, sk);
  if (plan.splits == 1) return 0;
  const size_t rows = (size_t)plan.splits * bh * ((sq + kB2Span - 1) / kB2Span) * kB2Span;
  return rows * (sizeof(float) * kB2Dp + sizeof(float2));
}

// K or V, (B, sk8, H, D) with sk8 a multiple of 8, as the TMA source of
// whole tiles in the core-matrix layout of hopper.cuh: five dims, innermost
// first, c % 8 (contiguous), r % 8 (the row stride), c / 8 (16 bytes),
// R / 8 (8 rows; R = b * sk8 + s runs over the batch) and h (d elements).
// A box of (8, 8, 64, 2, 1), half a key tile, lands as byte (r / 8) * 8192 +
// (c / 8) * 128 + (r % 8) * 16 + (c % 8) * 2, the tile layout at DP = 512;
// column chunks past d / 8 and row groups past the tensor are zeros.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline cudaError_t b2_tensor_map(CUtensorMap* map, const void* base, int batch, int heads,
                                 int sk8, int d) {
  static EncodeTiledFn encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return (EncodeTiledFn) nullptr;
    }
    return reinterpret_cast<EncodeTiledFn>(fn);
  }();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t row = (cuuint64_t)heads * d * sizeof(bf16);  // bytes between rows
  const cuuint64_t dims[5] = {8, 8, (cuuint64_t)d / 8, (cuuint64_t)batch * sk8 / 8,
                              (cuuint64_t)heads};
  const cuuint64_t strides[4] = {row, 16, 8 * row, (cuuint64_t)d * sizeof(bf16)};
  const cuuint32_t box[5] = {8, 8, kB2Dp / 8, kB2Keys / 8 / kB2Cluster, 1};
  const cuuint32_t steps[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(base), dims,
                            strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

__global__ void __cluster_dims__(kB2Cluster, 1, 1) __launch_bounds__(256, 1)
flash_fwd_b2(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
             const bf16* __restrict__ q, bf16* __restrict__ o, float* __restrict__ lse,
             float* __restrict__ part_o, float2* __restrict__ part_ml, int heads, int sq,
             int sq_pad, int sk, int sk8, int d, int tiles, float scale_log2) {
  constexpr int NS = kB2Keys / 8;           // 8-key column tiles of S
  constexpr int NO = kB2Half / 8;           // 8-column tiles of a warpgroup's accumulator
  constexpr uint32_t kGroup = kB2Dp * 16;   // bytes between 8-row groups of a tile
  constexpr int kTile = kB2Keys * kB2Dp;    // elements of one K or V tile

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kB2Rows * kB2Dp;
  bf16* sV = sK + kB2Stages * kTile;
  float* sX = reinterpret_cast<float*>(sV + kB2Stages * kTile);  // [warpgroup][16 values][128 threads]
  uint64_t* full = reinterpret_cast<uint64_t*>(sX + 2 * kB2Rows * kB2Keys);  // a stage landed
  uint64_t* empty = full + kB2Stages;  // both blocks of the pair are done with a stage

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y - b * heads;
  const int q0 = blockIdx.x * kB2Rows;
  const size_t rs = (size_t)heads * d;  // row stride of (B, S, H, D)

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int wt = tid % 128;
  const int warp = wt / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int nt = (sk + kB2Keys - 1) / kB2Keys;
  const int j0 = blockIdx.z * tiles;
  const int n = min(nt, j0 + tiles) - j0;  // key tiles of this split (>= 1)

  const uint32_t rank = cluster_rank();
  // one thread: this block's half (keys rank * 16 ..) of key tile i of K and
  // V, one TMA box each, multicast into stage i % 2 of both blocks of the
  // pair; the stage's barrier in each block expects both halves
  auto load_kv = [&](int i) {
    constexpr int kHalf = kTile / kB2Cluster;
    const int st = i % kB2Stages;
    const int group = (b * sk8 + (j0 + i) * kB2Keys) / 8 + (int)rank * (kB2Keys / 8 / kB2Cluster);
    mbar_expect_tx(&full[st], 2 * kTile * sizeof(bf16));
    tma_load_5d_multicast(sK + st * kTile + rank * kHalf, &tk, 0, 0, 0, group, h, &full[st],
                          (1 << kB2Cluster) - 1);
    tma_load_5d_multicast(sV + st * kTile + rank * kHalf, &tv, 0, 0, 0, group, h, &full[st],
                          (1 << kB2Cluster) - 1);
  };
  if (tid == 0) {
    for (int st = 0; st < kB2Stages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kB2Cluster);
    }
    fence_mbar_init();
  }
  load_tile_async<kB2Dp>(sQ, q + ((size_t)b * sq + q0) * rs + (size_t)h * d, rs, kB2Rows, sq - q0,
                         d, tid, 256);
  cp_async_commit();
  cluster_sync();  // the barriers of both blocks are set up
  if (tid == 0) load_kv(0);
  cp_async_wait<0>();
  fence_proxy_async();  // Q, copied by this thread, to wgmma's proxy

  // this warpgroup's columns: Q and K K-major from column wg * 256 (LBO
  // along the head dim, SBO along the rows), V MN-major from the same column
  // (LBO along the keys, SBO along the head dim); a k-step of 16 advances
  // Q/K by two core matrices (256 bytes), V by two 8-key groups
  const uint64_t desc_q = smem_desc(sQ + wg * kB2Half * 8, 128, kGroup);
  const uint64_t desc_k = smem_desc(sK + wg * kB2Half * 8, 128, kGroup);
  const uint64_t desc_v = smem_desc(sV + wg * kB2Half * 8, kGroup, 128);
  constexpr uint64_t kStageStep = (uint64_t)kTile * sizeof(bf16) / 16;

  float acc[NO][4];
#pragma unroll
  for (int c = 0; c < NO; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  float* mine = sX + wg * 16 * 128 + wt;
  const float* other = sX + (1 - wg) * 16 * 128 + wt;

  for (int i = 0; i < n; ++i) {
    __syncthreads();  // Q landed; this block is done with tile i-1 and the exchange
    if (tid == 0 && i + 1 < n) {
      // tile i+1 refills tile i-1's stage: once both blocks are done with it
      const int st = (i + 1) % kB2Stages;
      if (i >= 1) {
        for (uint32_t r = 0; r < kB2Cluster; ++r) mbar_arrive_cluster(&empty[st], r);
        mbar_wait(&empty[st], ((i - 1) / kB2Stages) & 1);
      }
      load_kv(i + 1);
    }
    mbar_wait(&full[i % kB2Stages], (i / kB2Stages) & 1);  // tile i landed

    const uint64_t stage = (uint64_t)(i % kB2Stages) * kStageStep;
    float s[NS][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kB2Half / 16; ++kk) {
      wgmma_ss(s, desc_q + kk * 16, desc_k + stage + kk * 16, kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // the two partial logits meet: thread wt of each warpgroup holds the
    // same 16 (row, key) entries
#pragma unroll
    for (int c = 0; c < NS; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[(c * 4 + e) * 128] = s[c][e];
    __syncthreads();
#pragma unroll
    for (int c = 0; c < NS; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[c][e] += other[(c * 4 + e) * 128];

    float alpha[2];
    uint32_t pa[NS / 2][4];  // P as the A operand, k-step c / 2
    float sum[2];
    B1Softmax::tile<NS>(s, pa, m, alpha, sum, scale_log2, (j0 + i) * kB2Keys, sk, t);
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int c = 0; c < NO; ++c) {
        acc[c][0] *= alpha[0];
        acc[c][1] *= alpha[0];
        acc[c][2] *= alpha[1];
        acc[c][3] *= alpha[1];
      }
    }

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kB2Keys / 16; ++kk) {
      wgmma_rs(acc, pa[kk], desc_v + stage + (uint64_t)kk * (2 * kGroup / 16), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }
  cluster_sync();  // no copy or arrival of the peer still targets this block

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int row0 = q0 + warp * 16 + g;
  const int col0 = wg * kB2Half;
  if (part_o == nullptr) {
    store_rows<NO>(o + (size_t)b * sq * rs + (size_t)h * d, rs, acc, l, row0, sq, col0, d, t);
    // both warpgroups hold the same m and l: the first writes
    if (lse != nullptr && wg == 0) {
      const float m2[2] = {m[0] * scale_log2, m[1] * scale_log2};
      store_lse(lse + (size_t)blockIdx.y * sq, m2, l, row0, sq, t);
    }
    return;
  }
  // a split: the unnormalised rows (all sq_pad of them), m in base-2 units, l
  const size_t prow = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * sq_pad + row0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* dst = part_o + (prow + 8 * r) * kB2Dp + col0 + 2 * t;
#pragma unroll
    for (int c = 0; c < NO; ++c) {
      *reinterpret_cast<float2*>(dst + c * 8) = make_float2(acc[c][2 * r], acc[c][2 * r + 1]);
    }
    if (wg == 0 && t == 0) part_ml[prow + 8 * r] = make_float2(m[r] * scale_log2, l[r]);
  }
}

// Merges the splits' partials of one query row and 8 columns (a thread),
// in split order: M = max m_i, L = sum 2^(m_i - M) l_i, o = sum 2^(m_i - M)
// O_i / L; the thread of columns 0..7 also writes lse = ln2 (M + log2 L).
__global__ void b2_combine(const float* __restrict__ part_o, const float2* __restrict__ part_ml,
                           bf16* __restrict__ o, float* __restrict__ lse, int splits, int bh_count,
                           int heads, int sq, int sq_pad, int d) {
  const int chunks = d / 8;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)bh_count * sq * chunks) return;
  const int c = (int)(idx % chunks);
  const size_t rowi = idx / chunks;
  const int bh = (int)(rowi / sq);
  const int r = (int)(rowi - (size_t)bh * sq);
  const size_t stride = (size_t)bh_count * sq_pad;  // rows between splits
  const size_t base = (size_t)bh * sq_pad + r;
  float mx = kNegInf;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, part_ml[s * stride + base].x);
  float L = 0.f;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < splits; ++s) {
    const float2 ml = part_ml[s * stride + base];
    const float w = exp2f(ml.x - mx);
    L += w * ml.y;
    const float4* src = reinterpret_cast<const float4*>(part_o + (s * stride + base) * kB2Dp + c * 8);
    const float4 a = src[0];
    const float4 b = src[1];
    acc[0] += w * a.x; acc[1] += w * a.y; acc[2] += w * a.z; acc[3] += w * a.w;
    acc[4] += w * b.x; acc[5] += w * b.y; acc[6] += w * b.z; acc[7] += w * b.w;
  }
  const float inv = 1.f / fmaxf(L, 1e-30f);
  const int b = bh / heads;
  const int h = bh - b * heads;
  uint4 out;
  out.x = pack_bf16(acc[0] * inv, acc[1] * inv);
  out.y = pack_bf16(acc[2] * inv, acc[3] * inv);
  out.z = pack_bf16(acc[4] * inv, acc[5] * inv);
  out.w = pack_bf16(acc[6] * inv, acc[7] * inv);
  *reinterpret_cast<uint4*>(o + ((size_t)b * sq + r) * heads * d + (size_t)h * d + c * 8) = out;
  if (lse != nullptr && c == 0) lse[(size_t)bh * sq + r] = kLn2 * (mx + log2f(fmaxf(L, 1e-30f)));
}

int launch_b2(const void* q, const void* k, const void* v, void* o, void* lse, void* work,
              int batch, int heads, int sq, int sk, int d, float scale, void* stream) {
  if (d > kB2Dp || d % 8) return (int)cudaErrorInvalidValue;
  const int sk8 = (sk + 7) / 8 * 8;
  CUtensorMap tk, tv;
  cudaError_t made = b2_tensor_map(&tk, k, batch, heads, sk8, d);
  if (made == cudaSuccess) made = b2_tensor_map(&tv, v, batch, heads, sk8, d);
  if (made != cudaSuccess) return (int)made;
  const size_t smem = b2_smem_bytes();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_b2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const cudaStream_t s = (cudaStream_t)stream;
  const int bh = batch * heads;
  const int sq_pad = (sq + kB2Span - 1) / kB2Span * kB2Span;  // whole clusters of query tiles
  const B2Plan plan = b2_plan(bh, sq, sk);
  if (plan.splits > 1 && work == nullptr) return (int)cudaErrorInvalidValue;
  float* part_o = plan.splits > 1 ? static_cast<float*>(work) : nullptr;
  float2* part_ml = plan.splits > 1
      ? reinterpret_cast<float2*>(part_o + (size_t)plan.splits * bh * sq_pad * kB2Dp)
      : nullptr;
  dim3 grid(sq_pad / kB2Rows, bh, plan.splits);
  flash_fwd_b2<<<grid, 256, smem, s>>>(
      tk, tv, static_cast<const bf16*>(q), static_cast<bf16*>(o), static_cast<float*>(lse), part_o,
      part_ml, heads, sq, sq_pad, sk, sk8, d, plan.tiles, scale * kLog2e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || part_o == nullptr) return (int)err;
  const size_t threads = (size_t)bh * sq * (d / 8);
  b2_combine<<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(
      part_o, part_ml, static_cast<bf16*>(o), static_cast<float*>(lse), plan.splits, bh, heads,
      sq, sq_pad, d);
  return (int)cudaGetLastError();
}

}  // namespace icd

// Bytes of the workspace `icd_flash_fwd_streamed(_lse)` needs at this shape
// on the current device (0 where the key range is not split).
extern "C" size_t icd_flash_fwd_streamed_workspace(int batch, int heads, int sq, int sk, int d) {
  return icd::b2_workspace_bytes(batch, heads, sq, sk);
}

// k and v hold round_up(sk, 8) rows per batch item (the TMA copies read
// whole groups of 8 rows; rows past sk never reach the output). `work`:
// icd_flash_fwd_streamed_workspace bytes (16-byte aligned), or unused.
extern "C" int icd_flash_fwd_streamed(const void* q, const void* k, const void* v, void* o,
                                      void* work, int batch, int heads, int sq, int sk, int d,
                                      float scale, void* stream) {
  return icd::launch_b2(q, k, v, o, nullptr, work, batch, heads, sq, sk, d, scale, stream);
}

// The same kernel, also writing lse (B, H, Sq) fp32.
extern "C" int icd_flash_fwd_streamed_lse(const void* q, const void* k, const void* v,
                                          void* o, void* lse, void* work, int batch, int heads,
                                          int sq, int sk, int d, float scale, void* stream) {
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  return icd::launch_b2(q, k, v, o, lse, work, batch, heads, sq, sk, d, scale, stream);
}
