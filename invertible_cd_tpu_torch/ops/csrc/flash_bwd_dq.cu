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
//   * delta: a thread loads O for its two rows (a quarter of each) before
//     the tiles' copies, and once dO has landed each quad sums its rows
//     against the staged dO tile, before the key loop; it is not written
//     out: B4 computes its own, so either kernel runs without the other;
//   * dQ leaves through shared memory (the free K/V ring) in 16-byte
//     pieces along the rows.
// A thread takes 116 registers at DP = 48, so two blocks share an SM as in
// B1, and 145 at DP = 80, one block an SM. DP = 64 is SDXL's head dim (640
// channels over 10 heads, 1280 over 20); its rows are 128 bytes, and the
// layout (8x8 core matrices, no swizzle: LBO 128 bytes, SBO DP * 16) and the
// descriptors are written in DP, so only the dispatch and the occupancy
// below are its own. Nothing was tried beyond B1's own alternatives
// (flash_fwd.cu), which this design inherits.
// Keys past Sk get P = 0 on the ragged last tile (their K and V rows are
// zero). Query rows past Sq have zero Q and dO rows; their dQ is never
// stored.
//
// Padded head dim 160 (80 < d <= 160: SD1.5's 256- and 64-token layers,
// over 256/64 keys and the 77-key tail). Every such shape is a few
// microseconds of work (0.3-4.7 us at its bound), so what bounds it is the
// serial chain of one block and the launches, not a rate: the earlier
// mma.sync design (64-row blocks of 4 warps, K and V staged synchronously)
// took 0.017-0.040 ms whatever the batch. Timestamps inside a one-tile
// block (64 queries, 64 keys) showed where that chain goes on an H100: its
// copies of Q, dO, K and V and the loads of O, ~120 KB into one SM at ~15
// bytes a cycle, took 7700 cycles, the products 1700, and issuing the
// scattered dQ stores 2900. The same template at DP = 160, then:
//   * one warpgroup a block (64 query rows, 128 threads): dQ takes 80
//     registers, S and dP 32 each (185 in all); the grid doubles against
//     128-row blocks, and a 64-token layer has no idle second warpgroup;
//   * a 64-key tile, or one 80-key tile where 64 < Sk <= 80 (wgmma
//     m64n80k16 for S and dP, five k-steps of dS K; 205 registers): the
//     77-key tail is one tile, not a full one and a 13-key one;
//   * where the grid is under about one block an SM (the 256-key shapes
//     below batch 4), the key tiles are split over blocks (split_plan); each
//     split writes fp32 partial dQ to the wrapper's workspace
//     (icd_flash_bwd_dq_workspace) and b3_sum_splits, launched as a
//     programmatic dependent (launch_after), adds them in split order; all
//     one launch. No atomics: repeats are bit-identical;
//   * delta's dO comes from the staged tile and dQ leaves through shared
//     memory, as above (one 20 KB read and 2000-odd cycles less a block).
// Tried and dropped (NVIDIA H100 80GB HBM3, 700 W, per launch in a CUDA
// graph): two 64-key tiles at Sk = 77 (0.9-2.4 us slower: the second tile
// splits or runs in turn) and 128-row blocks of two warpgroups at DP = 160
// (0.6-4.3 us slower at every shape). What holds it now is the copies into
// the SM (cp.async through L2): a tensor-memory copy, multicast to the
// blocks that share K and V, is the next step.
// Head dim 256 (no path launches it) keeps the earlier mma.sync loop.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace icd {

// ---- Hopper route, padded head dims 48, 64, 80 and 160 ----
// WG warpgroups of 64 query rows a block, KT keys a tile, STAGES K/V tiles
// in the ring (loaded STAGES - 1 ahead)
template <int DP, int WG, int KT, int STAGES>
constexpr size_t b3_smem_bytes() {
  return sizeof(bf16) * ((size_t)2 * 64 * WG * DP + (size_t)STAGES * 2 * KT * DP);
}

// grid (query blocks, B*H, splits); split z walks key tiles [z * tiles,
// min((z + 1) * tiles, all)). `part` == nullptr: one split, dQ written as
// bf16; otherwise the split's fp32 partial dQ, unscaled, at
// part + z * B*Sq*H*d in dQ's (B, Sq, H, d) layout.
template <int DP, int WG, int KT, int STAGES>
__global__ void __launch_bounds__(128 * WG, DP <= 64 ? 2 : 1)
flash_bwd_dq_b3(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ o,
                const bf16* __restrict__ dout, const float* __restrict__ lse,
                bf16* __restrict__ dq, float* __restrict__ part, int heads, int sq, int sk, int d,
                int tiles, float scale, float scale_log2) {
  constexpr int NT = 128 * WG;              // threads
  constexpr int ROWS = 64 * WG;             // query rows a block
  constexpr int NS = KT / 8;                // 8-key column tiles of S and dP
  constexpr int NO = DP / 8;                // 8-column tiles of the dQ accumulator
  constexpr uint32_t kGroup = DP * 16;      // bytes between 8-row groups of a tile
  constexpr int kTile = KT * DP;            // elements of one K or V tile
  constexpr int LDO = DP + 8;               // row stride of the staged output tile
  static_assert(sizeof(float) * ROWS * LDO <= sizeof(bf16) * 2 * STAGES * kTile,
                "the output tile is staged in the K/V ring");

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + ROWS * DP;
  bf16* sK = sdO + ROWS * DP;
  bf16* sV = sK + STAGES * kTile;

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y - b * heads;
  const int q0 = blockIdx.x * ROWS;
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
  const int rloc = wg * 64 + warp * 16 + g;              // this thread's rows: rloc and rloc + 8
  const int j0 = blockIdx.z * tiles;                     // this split's first key tile
  const int nt = min((sk + KT - 1) / KT - j0, tiles);    // and its count

  // lse2 of this thread's rows, and their O in 8-column chunks t, t + 4, ...
  // for delta, loaded before the tiles' copies so that they arrive first
  constexpr int NC = (DP / 8 + 3) / 4;  // O chunks a row a thread
  float lse2[2];
  uint4 o4[2][NC];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + rloc + 8 * r;
    lse2[r] = row < sq ? lse[(size_t)blockIdx.y * sq + row] * kLog2e : 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = (t + 4 * i) * 8;
      o4[r][i] = make_uint4(0u, 0u, 0u, 0u);
      if (row < sq && c < d) {
        o4[r][i] = *reinterpret_cast<const uint4*>(o + qoff + (size_t)(rloc + 8 * r) * rs + c);
      }
    }
  }

  auto load_kv = [&](int j) {
    const int st = j % STAGES;
    const int k0 = (j0 + j) * KT;
    load_tile_async<DP>(sK + st * kTile, kb + (size_t)k0 * rs, rs, KT, sk - k0, d, tid, NT);
    load_tile_async<DP>(sV + st * kTile, vb + (size_t)k0 * rs, rs, KT, sk - k0, d, tid, NT);
  };
  load_tile_async<DP>(sQ, q + qoff, rs, ROWS, sq - q0, d, tid, NT);
  load_tile_async<DP>(sdO, dout + qoff, rs, ROWS, sq - q0, d, tid, NT);
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < nt) load_kv(j);
    cp_async_commit();  // one group a tile, empty past the last, so the counts stay aligned
  }
  // delta of rows rloc and rloc + 8 from the staged dO (zero past Sq and d)
  // and the O chunks: a quarter of each row a thread, summed over the quad;
  // here, not in the loop, so that the O chunks are dead before it
  cp_async_wait<STAGES - 2>();  // Q, dO (and tile 0) landed, for this thread's copies
  __syncthreads();              // for every thread's
  griddep_launch_dependents();  // the sum of split partials may start launching
  float delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = rloc + 8 * r;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c8 = t + 4 * i;
      if (c8 * 8 >= DP) continue;
      const uint4 x4 = *reinterpret_cast<const uint4*>(sdO + (rr >> 3) * (DP * 8) + c8 * 64 + (rr & 7) * 8);
      sum += dot8(x4, o4[r][i]);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    delta[r] = sum;
  }

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
    cp_async_wait<STAGES - 2>();  // tile j (and Q, dO) landed, for this thread's copies
    fence_proxy_async();
    __syncthreads();              // for every thread's; and tile j-1's stage is free
    if (j + STAGES - 1 < nt) load_kv(j + STAGES - 1);
    cp_async_commit();
    const uint64_t stage = (uint64_t)(j % STAGES) * kStageStep;
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
    // k0 + 8n + 2t and + 1; keys past Sk masked on the ragged last tile
    const int k0 = (j0 + j) * KT;
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
  __syncthreads();  // every product has read its tiles: the K/V ring takes the output tile

  if (part == nullptr) {
    bf16* so = sK;
    stage_out(so, LDO, acc, scale, rloc, t);
    __syncthreads();
    copy_rows_out(dq + qoff, rs, so, LDO, ROWS, sq - q0, d, tid, NT);
  } else {
    float* so = reinterpret_cast<float*>(sK);
    stage_out(so, LDO, acc, 1.f, rloc, t);
    __syncthreads();
    float* pq = part + (size_t)blockIdx.z * (gridDim.y / heads) * sq * rs;  // this split's (B, Sq, H, d)
    copy_rows_out(pq + qoff, rs, so, LDO, ROWS, sq - q0, d, tid, NT);
  }
}

// dQ = scale * the sum of the splits' partials, in split order; one thread
// a pair of elements of the (B, Sq, H, d) layout.
__global__ void b3_sum_splits(const float* __restrict__ part, bf16* __restrict__ dq, int splits,
                              size_t n, float scale) {
  griddep_wait();  // launched with launch_after: the partials are written
  const size_t e = 2 * ((size_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (e >= n) return;
  float2 sum = make_float2(0.f, 0.f);
  for (int z = 0; z < splits; ++z) {
    const float2 a = *reinterpret_cast<const float2*>(part + z * n + e);
    sum.x += a.x;
    sum.y += a.y;
  }
  *reinterpret_cast<uint32_t*>(dq + e) = pack_bf16(sum.x * scale, sum.y * scale);
}

// The routes by padded head dim: DP 48/64/80 take 128-row blocks of two
// warpgroups, 64-key tiles, three stages and never split; DP 160 takes
// 64-row blocks of one warpgroup and splits its key tiles where the grid is
// under about one block an SM; Sk in (64, 80] is one 80-key tile there.
struct B3Route {
  int wg;  // warpgroups (64 query rows each) a block
  int kt;  // keys a tile
};

inline B3Route b3_route(int sk, int d) {
  if (d <= 80) return {2, 64};
  return {1, sk > 64 && sk <= 80 ? 80 : 64};
}

inline SplitPlan b3_plan(int batch, int heads, int sq, int sk, int d) {
  const B3Route r = b3_route(sk, d);
  const int nt = (sk + r.kt - 1) / r.kt;
  if (d <= 80) return {nt, 1};
  const int rows = 64 * r.wg;
  return split_plan((long long)((sq + rows - 1) / rows) * batch * heads, nt);
}

// Workspace bytes: fp32 partial dQ (splits, B, Sq, H, d) where the key tiles
// are split, none otherwise.
inline size_t b3_workspace_bytes(int batch, int heads, int sq, int sk, int d) {
  if (d > 160) return 0;
  const SplitPlan plan = b3_plan(batch, heads, sq, sk, d);
  return plan.splits > 1 ? sizeof(float) * plan.splits * batch * sq * heads * d : 0;
}

template <int DP, int WG, int KT, int STAGES>
int launch_b3(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const void* lse, void* dq, void* work, int batch, int heads, int sq, int sk, int d,
              float scale, void* stream) {
  const size_t smem = b3_smem_bytes<DP, WG, KT, STAGES>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_b3<DP, WG, KT, STAGES>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const cudaStream_t s = (cudaStream_t)stream;
  const SplitPlan plan = b3_plan(batch, heads, sq, sk, d);
  float* part = plan.splits > 1 ? static_cast<float*>(work) : nullptr;
  dim3 grid((sq + 64 * WG - 1) / (64 * WG), batch * heads, plan.splits);
  flash_bwd_dq_b3<DP, WG, KT, STAGES><<<grid, 128 * WG, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<bf16*>(dq), part, heads, sq, sk, d, plan.tiles,
      scale, scale * kLog2e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return (int)err;
  const size_t n = (size_t)batch * sq * heads * d;
  return (int)launch_after(b3_sum_splits, dim3((unsigned)((n / 2 + 255) / 256)), dim3(256), 0, s,
                           (const float*)part, static_cast<bf16*>(dq), plan.splits, n, scale);
}

// ---- the mma.sync route, padded head dim 256 ----
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

// Bytes of the workspace `icd_flash_bwd_dq` needs at this shape on the
// current device (0 where it does not split its key tiles).
extern "C" size_t icd_flash_bwd_dq_workspace(int batch, int heads, int sq, int sk, int d) {
  return icd::b3_workspace_bytes(batch, heads, sq, sk, d);
}

// `work`: icd_flash_bwd_dq_workspace bytes (16-byte aligned), or unused.
extern "C" int icd_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                const void* dout, const void* lse, void* dq, void* work,
                                int batch, int heads, int sq, int sk, int d, float scale,
                                void* stream) {
  using namespace icd;
  if (d <= 48) return launch_b3<48, 2, 64, 3>(q, k, v, o, dout, lse, dq, work, batch, heads, sq, sk, d, scale, stream);
  if (d <= 64) return launch_b3<64, 2, 64, 3>(q, k, v, o, dout, lse, dq, work, batch, heads, sq, sk, d, scale, stream);
  if (d <= 80) return launch_b3<80, 2, 64, 3>(q, k, v, o, dout, lse, dq, work, batch, heads, sq, sk, d, scale, stream);
  if (d <= 160) {
    if (b3_route(sk, d).kt == 80)
      return launch_b3<160, 1, 80, 2>(q, k, v, o, dout, lse, dq, work, batch, heads, sq, sk, d, scale, stream);
    return launch_b3<160, 1, 64, 3>(q, k, v, o, dout, lse, dq, work, batch, heads, sq, sk, d, scale, stream);
  }
  if (d <= 256) return launch_b3_mma<256>(q, k, v, o, dout, lse, dq, batch, heads, sq, sk, d, scale, stream);
  return (int)cudaErrorInvalidValue;
}
