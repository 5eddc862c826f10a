// Kernel B4: flash-attention backward, the key and value gradients, head
// dims <= 256.
//
// Replaces `_dkdv_kernel` in invertible_cd_tpu/ops/flash_attention.py
// (launched by `_flash_backward`, the backward of `_flash_op`), at the shapes
// of B1 and B3: Sq = Sk = 4096/1024/256/64 with d = 40/80/160/160, and
// Sk = 77 for cross-attention.
//
// Per key of one (batch, head), over every query row:
//   S^T  = K Q^T                P^T  = exp(scale * S^T - lse[query])
//   dP^T = V dO^T               dS^T = P^T * (dP^T - delta[query])
//   dV   = sum over queries of P^T dO
//   dK   = scale * sum over queries of dS^T Q
//
// What bounds it on an H100 SXM (700 W) at the hottest shape, Sq = Sk =
// 4096, d = 40, batch 4 x 8 heads: four products of 2 Sq Sk d each, 1.72e11
// FLOPs, take 0.174 ms at 989 TFLOP/s; one exponential a (query, key),
// 5.4e8, takes 0.138 ms on the MUFU unit; the bytes take microseconds. So
// the tensor cores and the exponentials set the floor together, and the
// elementwise work between the products (an FFMA, ex2, a subtraction, a
// product and two bf16 packs a logit) has to stay off the tensor cores'
// path. The earlier design (4 warps x 16 keys, mma.sync, every query tile
// staged synchronously behind three barriers, delta recomputed from the O
// tile by every key block) took 2.32 ms there. The Hopper design, at padded
// head dims 48, 64 (SDXL's d = 64) and 80:
//   * one block owns a key tile of 128 keys, 64 per consumer warpgroup; the
//     two warpgroups share each staged Q and dO tile, which halves what the
//     blocks read through L2; K and V stay in shared memory for the whole
//     query loop;
//   * S^T = K Q^T and dP^T = V dO^T are wgmma.m64n64k16 with K and V as the
//     A operand and the Q and dO tiles as B, all K-major;
//   * dV += P^T dO and dK += dS^T Q are wgmma m64n48/n64/n80k16 with P^T and
//     dS^T straight from the accumulator registers as the A operand (as B1's
//     P) and dO and Q read MN-major from the same tiles the first two
//     products read K-major: no tile is staged twice and none transposed;
//   * Q, dO and the per-row (lse * log2 e, delta) pairs arrive through a
//     ring of 3 stages filled with cp.async by all threads two tiles ahead,
//     one barrier a tile; P^T = exp2(S^T * c - lse2) is one FFMA and one
//     ex2.approx.ftz a logit, c = log2(e) / sqrt(d);
//   * delta = rowsum(dO * O) is computed once per call by a row pre-pass
//     (b4_rows), which also takes lse into base 2, so O is read once and not
//     once per key block; the pre-pass is part of B4, so
//     `flash_backward_dkdv` stands alone;
//   * every dK/dV row has one writer, or a fixed-order sum: with Sk <= 128
//     (cross-attention, one key tile) a block per (batch, head) would leave
//     most of the 132 SMs idle while it walked all query tiles, so the query
//     tiles are split over several blocks (b4_plan: about one block an SM),
//     each writing fp32 partial dK and dV to the wrapper's workspace, and a
//     second pass (b4_sum_splits) adds them in split order. No atomics:
//     repeats are bit-identical.
// A thread takes 208 registers at DP = 80 (168 at 48): one block an SM.
// Tried and dropped: one warpgroup a block (64 keys, two blocks an SM),
// as fast at 4096/40 and 27% slower at 1024/80 (0.110 against 0.087 ms on
// an H100 80GB HBM3 at 700 W, chip_smoke.py's kernel rows).
// Rows past Sq are zero Q and dO rows with zero delta: they add nothing to
// dK or dV, so no query masking is needed. Keys past Sk are zero K and V
// rows; they touch only their own dK/dV rows, which are never stored.
//
// Padded head dim 160 (80 < d <= 160: SD1.5's 256- and 64-token layers).
// Every such shape is a few microseconds of work (0.3-5.5 us at its bound),
// so the serial chain of a block and the launches bound it; the earlier
// mma.sync design (64 keys of 4 warps, each query tile staged synchronously,
// delta recomputed from O by every key block) took 0.018-0.051 ms whatever
// the batch. Both accumulators of 64 keys take 160 registers at DP = 160,
// with S^T and dP^T past 255: the DP 80 design would spill. So here
// (flash_bwd_dkdv_pair) the two warpgroups of a block share its 64 keys and
// each owns one accumulator:
//   * warpgroup 0 computes S^T = K Q^T, P^T, and dV += P^T dO; warpgroup 1
//     computes dP^T = V dO^T, takes P^T from warpgroup 0 through 16 KB of
//     shared memory (each thread the fp32 values its peer holds, behind one
//     named barrier a tile), and dK += dS^T Q. Both issue the same wgmma
//     sequence on operands picked by warpgroup, so no product sits under a
//     branch; 192 registers, no spills;
//   * the two first products run side by side on the tensor cores, as do
//     the two second ones: four products a tile, none computed twice;
//   * the query split of b4_plan covers every shape whose grid of 64-key
//     blocks is under about one block an SM, not only Sk <= 128;
//   * it is launched as a programmatic dependent of b4_rows (launch_after),
//     so its K and V copies run while the pre-pass ends, and waits for the
//     rows before it copies them; the split sum is launched so too;
//   * dK and dV leave through the free ring in 16-byte pieces along rows.
// The pre-pass's one thread a row waited for 20 loads in turn at d = 160
// (7 us; now 2); those three changes took 4.5, 0.5-2.6 and 1.3-3.6 us off
// the d = 160 rows (H100 80GB HBM3, 700 W, per launch in a CUDA graph).
// Tried and dropped: a 4-stage ring (no change: 21.9 against 22.0 us at
// batch 4, 256 x 256, NVIDIA H100 80GB HBM3, 700 W). At 128 blocks a
// one-tile block takes 11 us against 7 us at 8 blocks: the copies through
// L2 into the SMs hold it (each Q/dO tile is copied by every key block of
// its head), for which a tensor-memory copy multicast over a cluster of the
// key blocks is the next step.
// Head dim 256 (no path launches it) keeps the earlier mma.sync loop; it
// computes delta itself.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace icd {

// ---- Hopper route, padded head dims 48, 64 and 80 (160: the pair route below) ----
constexpr int kB4Warpgroups = 2;             // consumer warpgroups a block
constexpr int kB4Keys = 64 * kB4Warpgroups;  // keys a block
constexpr int kB4Rows = 64;                  // query rows a tile
constexpr int kB4Stages = 3;                 // Q/dO tiles in the ring, loaded two ahead
constexpr int kB4CrossKeys = 128;            // Sk at or below this splits the query tiles (DP <= 80)
constexpr int kB4PairKeys = 64;              // keys a block at DP 160 (both warpgroups)

// One ring stage: the Q tile, the dO tile, then (lse2, delta) of its rows.
template <int DP>
__host__ __device__ constexpr size_t b4_stage_bytes() {
  return sizeof(bf16) * 2 * kB4Rows * DP + sizeof(float2) * kB4Rows;
}

template <int DP>
constexpr size_t b4_smem_bytes() {
  return sizeof(bf16) * 2 * kB4Keys * DP + kB4Stages * b4_stage_bytes<DP>();
}

// How the query tiles of each key block are cut (split_plan): at DP <= 80
// one block a key tile unless Sk <= kB4CrossKeys, where the tiles are spread
// so that the grid is about one block an SM; at DP 160 (64-key blocks)
// wherever the grid is under that.
inline SplitPlan b4_plan(int bh, int sq, int sk, int d) {
  const int nt = (sq + kB4Rows - 1) / kB4Rows;
  if (d > 80) return split_plan((long long)((sk + kB4PairKeys - 1) / kB4PairKeys) * bh, nt);
  if (sk > kB4CrossKeys) return {nt, 1};
  return split_plan((long long)((sk + kB4Keys - 1) / kB4Keys) * bh, nt);
}

// Workspace bytes: (lse2, delta) per row padded to whole tiles, then, when
// the query tiles are split, fp32 partial dK and dV (splits, B*H, Sk, d).
inline size_t b4_workspace_bytes(int batch, int heads, int sq, int sk, int d) {
  const int bh = batch * heads;
  const size_t rows = (size_t)bh * ((sq + kB4Rows - 1) / kB4Rows) * kB4Rows;
  const SplitPlan plan = b4_plan(bh, sq, sk, d);
  const size_t part = plan.splits > 1 ? 2 * (size_t)plan.splits * bh * sk * d : 0;
  return sizeof(float2) * rows + sizeof(float) * part;
}

// (lse * log2 e, rowsum(dO * O)) of every query row, rows padded to whole
// tiles with (0, 0). At DP <= 80 one thread a row loops over its 8-column
// chunks into one running sum (at 4096 tokens the loop beat both forms
// below by 1-3 us, and summing each chunk apart (dot8) by 1.2 us); at
// DP 160, where that thread waited for 20 loads in turn (7 us against 2 at
// 256 tokens), RT = 8 threads a row each take every eighth chunk with their
// loads issued together.
template <int DP, int RT>
__global__ void b4_rows(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, float2* __restrict__ rows, int heads,
                        int sq, int sq_pad, int d, int bh_count) {
  constexpr int CH = (DP / 8 + RT - 1) / RT;  // chunks a thread
  if constexpr (DP > 80) griddep_launch_dependents();  // the pair kernel may start, loading K and V
  const size_t idx = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) / RT;
  const int part = threadIdx.x % RT;
  const bool live = idx < (size_t)bh_count * sq_pad;
  const int bh = live ? (int)(idx / sq_pad) : 0;
  const int r = live ? (int)(idx - (size_t)bh * sq_pad) : sq;
  float sum = 0.f;
  if (r < sq) {
    const int b = bh / heads;
    const int h = bh - b * heads;
    const size_t off = ((size_t)b * sq + r) * heads * d + (size_t)h * d;
    if constexpr (RT == 1) {
      for (int c = 0; c < d; c += 8) {
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
    } else {
      uint4 x4[CH], y4[CH];
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const int c = (part + RT * i) * 8;
        x4[i] = y4[i] = make_uint4(0u, 0u, 0u, 0u);
        if (c < d) {
          x4[i] = *reinterpret_cast<const uint4*>(dout + off + c);
          y4[i] = *reinterpret_cast<const uint4*>(o + off + c);
        }
      }
#pragma unroll
      for (int i = 0; i < CH; ++i) sum += dot8(x4[i], y4[i]);
    }
  }
#pragma unroll
  for (int m = 1; m < RT; m *= 2) sum += __shfl_xor_sync(0xffffffffu, sum, m);
  if (live && part == 0) {
    rows[idx] = r < sq ? make_float2(lse[(size_t)bh * sq + r] * kLog2e, sum) : make_float2(0.f, 0.f);
  }
}

// Rows g and g+8 of fp32 accumulator tiles, unscaled, into a (rows, d) fp32
// block; rows at or past `limit` and columns at or past d are not stored.
template <int NT>
__device__ __forceinline__ void store_rows_f32(float* p, const float (&acc)[NT][4], int row0,
                                               int limit, int d, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= limit) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < d) {
        *reinterpret_cast<float2*>(p + (size_t)row * d + col) =
            make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
      }
    }
  }
}

// grid (key tiles, B*H, splits); split z walks query tiles [z * tiles,
// min((z + 1) * tiles, all)). `part` == nullptr: one split, dK and dV
// written as bf16; otherwise fp32 partials, dK unscaled.
template <int DP>
__global__ void __launch_bounds__(128 * kB4Warpgroups, 1)
flash_bwd_dkdv_b4(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float2* __restrict__ rows, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, float* __restrict__ part, int heads, int sq,
                  int sq_pad, int sk, int d, int tiles, float scale, float scale_log2) {
  constexpr int NT = 128 * kB4Warpgroups;   // threads
  constexpr int NQ = kB4Rows / 8;           // 8-query column tiles of S^T
  constexpr int NO = DP / 8;                // 8-column tiles of the dK and dV accumulators
  constexpr uint32_t kGroup = DP * 16;      // bytes between 8-row groups of a tile
  constexpr int kTile = kB4Rows * DP;       // elements of one Q or dO tile
  constexpr size_t kStage = b4_stage_bytes<DP>();

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kB4Keys * DP;
  unsigned char* ring = reinterpret_cast<unsigned char*>(sV + kB4Keys * DP);
  auto stage_q = [&](int st) { return reinterpret_cast<bf16*>(ring + st * kStage); };
  auto stage_do = [&](int st) { return stage_q(st) + kTile; };
  auto stage_rows = [&](int st) { return reinterpret_cast<float2*>(stage_q(st) + 2 * kTile); };

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int k0 = blockIdx.x * kB4Keys;
  const int t0 = blockIdx.z * tiles;
  const int nt = min(sq_pad / kB4Rows - t0, tiles);
  const size_t rs = (size_t)heads * d;  // row stride of (B, S, H, D)
  const bf16* qb = q + (size_t)b * sq * rs + (size_t)h * d;
  const bf16* dob = dout + (size_t)b * sq * rs + (size_t)h * d;
  const float2* rowb = rows + (size_t)bh * sq_pad;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const size_t koff = ((size_t)b * sk + k0) * rs + (size_t)h * d;
  load_tile_async<DP>(sK, k + koff, rs, kB4Keys, sk - k0, d, tid, NT);
  load_tile_async<DP>(sV, v + koff, rs, kB4Keys, sk - k0, d, tid, NT);
  auto load_tile = [&](int j) {
    const int st = j % kB4Stages;
    const int q0 = (t0 + j) * kB4Rows;
    load_tile_async<DP>(stage_q(st), qb + (size_t)q0 * rs, rs, kB4Rows, sq - q0, d, tid, NT);
    load_tile_async<DP>(stage_do(st), dob + (size_t)q0 * rs, rs, kB4Rows, sq - q0, d, tid, NT);
    if (tid < kB4Rows / 2) cp_async16(stage_rows(st) + 2 * tid, rowb + q0 + 2 * tid, true);
  };
#pragma unroll
  for (int j = 0; j < kB4Stages - 1; ++j) {
    if (j < nt) load_tile(j);
    cp_async_commit();  // one group a tile, empty past the last (K and V ride in the first)
  }

  // descriptors: this warpgroup's K and V (A, K-major); stage 0 of Q and dO
  // as the B of S^T and dP^T (K-major: LBO along the head dim, SBO along the
  // rows) and as the B of dK and dV (MN-major: LBO along the queries, SBO
  // along the head dim); a k-step of 16 advances K-major operands by two
  // core matrices (256 bytes) and MN-major ones by two 8-row groups
  const uint64_t desc_k = smem_desc(sK + wg * 64 * DP, 128, kGroup);
  const uint64_t desc_v = smem_desc(sV + wg * 64 * DP, 128, kGroup);
  const uint64_t desc_q = smem_desc(stage_q(0), 128, kGroup);
  const uint64_t desc_do = smem_desc(stage_do(0), 128, kGroup);
  const uint64_t desc_qn = smem_desc(stage_q(0), kGroup, 128);
  const uint64_t desc_don = smem_desc(stage_do(0), kGroup, 128);
  constexpr uint64_t kStageStep = kStage / 16;
  constexpr uint64_t kRowStep = 2 * kGroup / 16;

  float dk_acc[NO][4];
  float dv_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  }

  for (int j = 0; j < nt; ++j) {
    cp_async_wait<kB4Stages - 2>();  // tile j (and K, V) landed, for this thread's copies
    fence_proxy_async();
    __syncthreads();                 // for every thread's; and tile j-1's stage is free
    if (j + kB4Stages - 1 < nt) load_tile(j + kB4Stages - 1);
    cp_async_commit();

    const int st = j % kB4Stages;
    const uint64_t stage = (uint64_t)st * kStageStep;
    float s[NQ][4];
    float dp[NQ][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) wgmma_ss(s, desc_k + kk * 16, desc_q + stage + kk * 16, kk);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) wgmma_ss(dp, desc_v + kk * 16, desc_do + stage + kk * 16, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P^T and dS^T as bf16 A operands (k-step n / 2); this thread's query
    // columns are 8n + 2t and 8n + 2t + 1, rows keys g and g + 8
    const float2* sr = stage_rows(st);
    uint32_t pa[NQ / 2][4];
    uint32_t da[NQ / 2][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      const float4 x = *reinterpret_cast<const float4*>(sr + n * 8 + 2 * t);  // l0 d0 l1 d1
      const float p0 = fast_exp2(fmaf(s[n][0], scale_log2, -x.x));
      const float p1 = fast_exp2(fmaf(s[n][1], scale_log2, -x.z));
      const float p2 = fast_exp2(fmaf(s[n][2], scale_log2, -x.x));
      const float p3 = fast_exp2(fmaf(s[n][3], scale_log2, -x.z));
      pa[n / 2][(n % 2) * 2] = pack_bf16(p0, p1);
      pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(p2, p3);
      da[n / 2][(n % 2) * 2] = pack_bf16(p0 * (dp[n][0] - x.y), p1 * (dp[n][1] - x.w));
      da[n / 2][(n % 2) * 2 + 1] = pack_bf16(p2 * (dp[n][2] - x.y), p3 * (dp[n][3] - x.w));
    }

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NQ / 2; ++kk) wgmma_rs(dv_acc, pa[kk], desc_don + stage + kk * kRowStep, 1);
#pragma unroll
    for (int kk = 0; kk < NQ / 2; ++kk) wgmma_rs(dk_acc, da[kk], desc_qn + stage + kk * kRowStep, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
  }
  cp_async_wait<0>();

  const int key0 = k0 + wg * 64 + warp * 16 + g;  // this thread's keys: key0 and key0 + 8
  if (part == nullptr) {
    const size_t kvbase = (size_t)b * sk * rs + (size_t)h * d;
    const float one[2] = {1.f, 1.f};
    const float mul[2] = {scale, scale};
    store_rows_scaled<NO>(dv + kvbase, rs, dv_acc, one, key0, sk, 0, d, t);
    store_rows_scaled<NO>(dk + kvbase, rs, dk_acc, mul, key0, sk, 0, d, t);
  } else {
    const size_t block = (size_t)sk * d;  // one (split, b, h) of the partials
    float* pk = part + ((size_t)blockIdx.z * gridDim.y + bh) * block;
    store_rows_f32<NO>(pk, dk_acc, key0, sk, d, t);
    store_rows_f32<NO>(pk + (size_t)gridDim.z * gridDim.y * block, dv_acc, key0, sk, d, t);
  }
}

// dK = scale * sum of the partial dK, dV = sum of the partial dV, in split
// order; one thread a pair of columns of one (b, h, key). kAfter: launched
// with launch_after (DP 160).
template <bool kAfter>
__global__ void b4_sum_splits(const float* __restrict__ part, bf16* __restrict__ dk,
                              bf16* __restrict__ dv, int splits, int bh_count, int heads,
                              int sk, int d, float scale) {
  if constexpr (kAfter) griddep_wait();  // the partials are written
  const size_t n = (size_t)bh_count * sk * d;
  const size_t e = 2 * ((size_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (e >= n) return;
  float2 sk_sum = make_float2(0.f, 0.f);
  float2 sv_sum = make_float2(0.f, 0.f);
  for (int z = 0; z < splits; ++z) {
    const float2 a = *reinterpret_cast<const float2*>(part + z * n + e);
    const float2 c = *reinterpret_cast<const float2*>(part + (splits + z) * n + e);
    sk_sum.x += a.x;
    sk_sum.y += a.y;
    sv_sum.x += c.x;
    sv_sum.y += c.y;
  }
  const int bh = (int)(e / ((size_t)sk * d));
  const int rem = (int)(e - (size_t)bh * sk * d);
  const int key = rem / d;
  const int col = rem - key * d;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const size_t off = ((size_t)b * sk + key) * heads * d + (size_t)h * d + col;
  *reinterpret_cast<uint32_t*>(dk + off) = pack_bf16(sk_sum.x * scale, sk_sum.y * scale);
  *reinterpret_cast<uint32_t*>(dv + off) = pack_bf16(sv_sum.x, sv_sum.y);
}

// ---- DP 160: two warpgroups share a block's 64 keys ----
// One ring stage as above, then the hand-off of P^T: 128 threads x 8 float4.
template <int DP>
constexpr size_t b4_pair_smem_bytes() {
  return sizeof(bf16) * 2 * kB4PairKeys * DP + kB4Stages * b4_stage_bytes<DP>() +
         sizeof(float4) * 128 * (kB4Rows / 8);
}

// grid (64-key blocks, B*H, splits), 256 threads. Warpgroup 0 owns dV:
// S^T = K Q^T, P^T, dV += P^T dO; warpgroup 1 owns dK: dP^T = V dO^T, then,
// with warpgroup 0's P^T from shared memory, dS^T and dK += dS^T Q. The two
// run the same products on their own operands (descriptors picked by
// warpgroup), so each holds one 64 x DP accumulator. `part` as in
// flash_bwd_dkdv_b4.
template <int DP>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dkdv_pair(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float2* __restrict__ rows, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, float* __restrict__ part, int heads, int sq,
                    int sq_pad, int sk, int d, int tiles, float scale, float scale_log2) {
  constexpr int NT = 256;                   // threads
  constexpr int NQ = kB4Rows / 8;           // 8-query column tiles of S^T and dP^T
  constexpr int NO = DP / 8;                // 8-column tiles of the dK or dV accumulator
  constexpr uint32_t kGroup = DP * 16;      // bytes between 8-row groups of a tile
  constexpr int kTile = kB4Rows * DP;       // elements of one Q or dO tile
  constexpr size_t kStage = b4_stage_bytes<DP>();
  constexpr int kHandoff = 1;               // named barrier of the P^T hand-off
  constexpr int LDO = DP + 8;               // row stride of the staged output tiles
  static_assert(2 * sizeof(float) * kB4PairKeys * LDO <= kB4Stages * kStage,
                "both output tiles are staged in the ring");

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kB4PairKeys * DP;
  unsigned char* ring = reinterpret_cast<unsigned char*>(sV + kB4PairKeys * DP);
  float4* sP = reinterpret_cast<float4*>(ring + kB4Stages * kStage);
  auto stage_q = [&](int st) { return reinterpret_cast<bf16*>(ring + st * kStage); };
  auto stage_do = [&](int st) { return stage_q(st) + kTile; };
  auto stage_rows = [&](int st) { return reinterpret_cast<float2*>(stage_q(st) + 2 * kTile); };

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int k0 = blockIdx.x * kB4PairKeys;
  const int t0 = blockIdx.z * tiles;
  const int nt = min(sq_pad / kB4Rows - t0, tiles);
  const size_t rs = (size_t)heads * d;  // row stride of (B, S, H, D)
  const bf16* qb = q + (size_t)b * sq * rs + (size_t)h * d;
  const bf16* dob = dout + (size_t)b * sq * rs + (size_t)h * d;
  const float2* rowb = rows + (size_t)bh * sq_pad;

  const int tid = threadIdx.x;
  const int wg = tid / 128;                 // 0: dV, 1: dK
  const int wt = tid % 128;                 // thread in the warpgroup
  const int warp = wt / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const size_t koff = ((size_t)b * sk + k0) * rs + (size_t)h * d;
  load_tile_async<DP>(sK, k + koff, rs, kB4PairKeys, sk - k0, d, tid, NT);
  load_tile_async<DP>(sV, v + koff, rs, kB4PairKeys, sk - k0, d, tid, NT);
  auto load_tile = [&](int j) {
    const int st = j % kB4Stages;
    const int q0 = (t0 + j) * kB4Rows;
    load_tile_async<DP>(stage_q(st), qb + (size_t)q0 * rs, rs, kB4Rows, sq - q0, d, tid, NT);
    load_tile_async<DP>(stage_do(st), dob + (size_t)q0 * rs, rs, kB4Rows, sq - q0, d, tid, NT);
    if (tid < kB4Rows / 2) cp_async16(stage_rows(st) + 2 * tid, rowb + q0 + 2 * tid, true);
  };
  griddep_wait();  // launched with launch_after: b4_rows has written the rows
#pragma unroll
  for (int j = 0; j < kB4Stages - 1; ++j) {
    if (j < nt) load_tile(j);
    cp_async_commit();  // one group a tile, empty past the last (K and V ride in the first)
  }
  griddep_launch_dependents();  // the sum of split partials may start launching

  // descriptors, by warpgroup: the first product's A (K or V, K-major) and
  // B (stage 0 of Q or dO, K-major: LBO along the head dim, SBO along the
  // rows); the second product's B (stage 0 of dO or Q, MN-major: LBO along
  // the queries, SBO along the head dim)
  const uint64_t desc_a = smem_desc(wg ? sV : sK, 128, kGroup);
  const uint64_t desc_b = smem_desc(wg ? stage_do(0) : stage_q(0), 128, kGroup);
  const uint64_t desc_bn = smem_desc(wg ? stage_q(0) : stage_do(0), kGroup, 128);
  constexpr uint64_t kStageStep = kStage / 16;
  constexpr uint64_t kRowStep = 2 * kGroup / 16;

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = 0; j < nt; ++j) {
    cp_async_wait<kB4Stages - 2>();  // tile j (and K, V) landed, for this thread's copies
    fence_proxy_async();
    __syncthreads();                 // for every thread's; tile j-1's stage and sP are free
    if (j + kB4Stages - 1 < nt) load_tile(j + kB4Stages - 1);
    cp_async_commit();

    const int st = j % kB4Stages;
    const uint64_t stage = (uint64_t)st * kStageStep;
    float x[NQ][4];  // S^T (warpgroup 0) or dP^T (warpgroup 1)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) wgmma_ss(x, desc_a + kk * 16, desc_b + stage + kk * 16, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(x);

    // P^T or dS^T as bf16 A operands (k-step n / 2); this thread's query
    // columns are 8n + 2t and 8n + 2t + 1, rows keys g and g + 8. The
    // thread of warpgroup 1 holds dP^T at the places its peer in
    // warpgroup 0 holds S^T, and takes P^T from it in fp32.
    const float2* sr = stage_rows(st);
    uint32_t a[NQ / 2][4];
    if (wg == 0) {
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const float4 y = *reinterpret_cast<const float4*>(sr + n * 8 + 2 * t);  // l0 d0 l1 d1
        const float p0 = fast_exp2(fmaf(x[n][0], scale_log2, -y.x));
        const float p1 = fast_exp2(fmaf(x[n][1], scale_log2, -y.z));
        const float p2 = fast_exp2(fmaf(x[n][2], scale_log2, -y.x));
        const float p3 = fast_exp2(fmaf(x[n][3], scale_log2, -y.z));
        sP[n * 128 + wt] = make_float4(p0, p1, p2, p3);
        a[n / 2][(n % 2) * 2] = pack_bf16(p0, p1);
        a[n / 2][(n % 2) * 2 + 1] = pack_bf16(p2, p3);
      }
      named_arrive(kHandoff, NT);
    } else {
      named_sync(kHandoff, NT);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const float4 y = *reinterpret_cast<const float4*>(sr + n * 8 + 2 * t);
        const float4 p = sP[n * 128 + wt];
        a[n / 2][(n % 2) * 2] = pack_bf16(p.x * (x[n][0] - y.y), p.y * (x[n][1] - y.w));
        a[n / 2][(n % 2) * 2 + 1] = pack_bf16(p.z * (x[n][2] - y.y), p.w * (x[n][3] - y.w));
      }
    }

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NQ / 2; ++kk) wgmma_rs(acc, a[kk], desc_bn + stage + kk * kRowStep, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }
  cp_async_wait<0>();

  // each warpgroup's tile leaves through its half of the ring, then in
  // 16-byte pieces along the rows
  __syncthreads();  // every product has read its tiles
  const int key0 = warp * 16 + g;  // this thread's keys in the block: key0 and key0 + 8
  if (part == nullptr) {
    bf16* so = reinterpret_cast<bf16*>(ring) + wg * kB4PairKeys * LDO;
    stage_out(so, LDO, acc, wg ? scale : 1.f, key0, t);
    __syncthreads();
    bf16* out = (wg ? dk : dv) + ((size_t)b * sk + k0) * rs + (size_t)h * d;
    copy_rows_out(out, rs, so, LDO, kB4PairKeys, sk - k0, d, wt, 128);
  } else {
    float* so = reinterpret_cast<float*>(ring) + wg * kB4PairKeys * LDO;
    stage_out(so, LDO, acc, 1.f, key0, t);
    __syncthreads();
    const size_t block = (size_t)sk * d;  // one (split, b, h) of the partials: dK's, then dV's
    float* out = part + ((size_t)blockIdx.z * gridDim.y + bh) * block +
                 (wg ? 0 : (size_t)gridDim.z * gridDim.y * block) + (size_t)k0 * d;
    copy_rows_out(out, (size_t)d, so, LDO, kB4PairKeys, sk - k0, d, wt, 128);
  }
}

// The main kernel by padded head dim (only the chosen one is instantiated).
template <int DP>
auto b4_kernel() {
  if constexpr (DP > 80) {
    return flash_bwd_dkdv_pair<DP>;
  } else {
    return flash_bwd_dkdv_b4<DP>;
  }
}

// The row pre-pass, the main kernel (flash_bwd_dkdv_b4 at DP <= 80,
// flash_bwd_dkdv_pair at DP 160) and, for split query tiles, the sum.
template <int DP>
int launch_b4(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const void* lse, void* dk, void* dv, void* work, int batch, int heads, int sq,
              int sk, int d, float scale, void* stream) {
  constexpr bool kPair = DP > 80;
  constexpr int kKeys = kPair ? kB4PairKeys : kB4Keys;
  const auto kernel = b4_kernel<DP>();
  const size_t smem = kPair ? b4_pair_smem_bytes<DP>() : b4_smem_bytes<DP>();
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const cudaStream_t s = (cudaStream_t)stream;
  const int bh = batch * heads;
  const int sq_pad = (sq + kB4Rows - 1) / kB4Rows * kB4Rows;
  const SplitPlan plan = b4_plan(bh, sq, sk, d);
  float2* rows = static_cast<float2*>(work);
  float* part = plan.splits > 1 ? reinterpret_cast<float*>(rows + (size_t)bh * sq_pad) : nullptr;

  const size_t nrows = (size_t)bh * sq_pad;
  constexpr int kRowThreads = kPair ? 8 : 1;
  b4_rows<DP, kRowThreads><<<(unsigned)((nrows * kRowThreads + 255) / 256), 256, 0, s>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      rows, heads, sq, sq_pad, d, bh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sk + kKeys - 1) / kKeys, bh, plan.splits);
  const bf16* args_q = static_cast<const bf16*>(q);
  const bf16* args_k = static_cast<const bf16*>(k);
  const bf16* args_v = static_cast<const bf16*>(v);
  const bf16* args_do = static_cast<const bf16*>(dout);
  if constexpr (kPair) {  // its K and V copies run while b4_rows ends
    err = launch_after(kernel, grid, dim3(128 * kB4Warpgroups), smem, s, args_q, args_k, args_v,
                       args_do, (const float2*)rows, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                       part, heads, sq, sq_pad, sk, d, plan.tiles, scale, scale * kLog2e);
  } else {
    kernel<<<grid, 128 * kB4Warpgroups, smem, s>>>(
        args_q, args_k, args_v, args_do, rows, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
        part, heads, sq, sq_pad, sk, d, plan.tiles, scale, scale * kLog2e);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || part == nullptr) return (int)err;
  const size_t pairs = (size_t)bh * sk * d / 2;
  const dim3 sum_grid((unsigned)((pairs + 255) / 256));
  if constexpr (kPair) {
    return (int)launch_after(b4_sum_splits<true>, sum_grid, dim3(256), 0, s, (const float*)part,
                             static_cast<bf16*>(dk), static_cast<bf16*>(dv), plan.splits, bh,
                             heads, sk, d, scale);
  }
  b4_sum_splits<false><<<sum_grid, 256, 0, s>>>(
      part, static_cast<bf16*>(dk), static_cast<bf16*>(dv), plan.splits, bh, heads, sk, d, scale);
  return (int)cudaGetLastError();
}

// ---- the mma.sync route, padded head dim 256 ----
constexpr int kB4MmaKeys = 64;  // keys per block
constexpr int kB4MmaRows = 64;  // query rows per tile

template <int DP>
constexpr size_t b4_mma_smem_bytes() {
  return sizeof(bf16) * (size_t)(2 * kB4MmaKeys + 3 * kB4MmaRows) * (DP + 8) +
         sizeof(float) * 2 * kB4MmaRows;
}

// Per 64 keys, 4 warps x 16 keys, looping over 64-query tiles staged with
// plain loads; the tile is computed transposed (keys as rows), so P^T and
// dS^T come out of mma.sync.m16n8k16 as the A operand of the next product,
// and dO and Q are read as its B operand with ldmatrix.trans. delta is
// computed per query tile from the staged dO and O tiles. QCH: queries
// worked through at a time (32: the two fp32 accumulators take DP registers).
template <int DP, int QCH>
__global__ void __launch_bounds__(128)
flash_bwd_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ o,
                   const bf16* __restrict__ dout, const float* __restrict__ lse,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int heads, int sq, int sk,
                   int d, float scale, float scale_log2) {
  static_assert(DP % 16 == 0 && kB4MmaRows % QCH == 0 && QCH % 16 == 0, "tile shapes");
  constexpr int LDI = DP + 8;  // row stride of every tile (elements)
  constexpr int NQ = QCH / 8;  // 8-query tiles of S^T and dP^T per warp
  constexpr int NO = DP / 8;   // 8-column tiles of the dK and dV accumulators

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kB4MmaKeys * LDI;
  bf16* sQ = sV + kB4MmaKeys * LDI;
  bf16* sdO = sQ + kB4MmaRows * LDI;
  bf16* sO = sdO + kB4MmaRows * LDI;
  float* sLse = reinterpret_cast<float*>(sO + kB4MmaRows * LDI);  // base-2 domain
  float* sDelta = sLse + kB4MmaRows;

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y - b * heads;
  const int k0 = blockIdx.x * kB4MmaKeys;
  const size_t rs = (size_t)heads * d;  // row stride of (B, S, H, D)
  const size_t koff = ((size_t)b * sk + k0) * rs + (size_t)h * d;
  const size_t qbase = (size_t)b * sq * rs + (size_t)h * d;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const bf16* kw = sK + warp * 16 * LDI;
  const bf16* vw = sV + warp * 16 * LDI;
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0 and key0 + 8

  load_rows(sK, LDI, k + koff, rs, kB4MmaKeys, sk - k0, d, DP);
  load_rows(sV, LDI, v + koff, rs, kB4MmaKeys, sk - k0, d, DP);

  float dkacc[NO][4];
  float dvacc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    dkacc[n][0] = dkacc[n][1] = dkacc[n][2] = dkacc[n][3] = 0.f;
    dvacc[n][0] = dvacc[n][1] = dvacc[n][2] = dvacc[n][3] = 0.f;
  }

  for (int q0 = 0; q0 < sq; q0 += kB4MmaRows) {
    __syncthreads();  // the previous query tile is consumed
    const size_t qoff = qbase + (size_t)q0 * rs;
    load_rows(sQ, LDI, q + qoff, rs, kB4MmaRows, sq - q0, d, DP);
    load_rows(sdO, LDI, dout + qoff, rs, kB4MmaRows, sq - q0, d, DP);
    load_rows(sO, LDI, o + qoff, rs, kB4MmaRows, sq - q0, d, DP);
    if (threadIdx.x < kB4MmaRows) {
      const int row = q0 + threadIdx.x;
      sLse[threadIdx.x] = row < sq ? lse[(size_t)blockIdx.y * sq + row] * kLog2e : 0.f;
    }
    __syncthreads();  // the tiles (and, the first time, K and V) are staged
    {
      // delta of row r: two threads, each over every other 8-column chunk
      const int r = threadIdx.x >> 1;
      float sum = 0.f;
      for (int c = (threadIdx.x & 1) * 8; c < DP; c += 16) {
        const uint4 x4 = *reinterpret_cast<const uint4*>(sdO + r * LDI + c);
        const uint4 y4 = *reinterpret_cast<const uint4*>(sO + r * LDI + c);
        const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&x4);
        const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&y4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 xf = __bfloat1622float2(x[i]);
          const float2 yf = __bfloat1622float2(y[i]);
          sum += xf.x * yf.x + xf.y * yf.y;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if ((threadIdx.x & 1) == 0) sDelta[r] = sum;
    }
    __syncthreads();

    for (int qc = 0; qc < kB4MmaRows && q0 + qc < sq; qc += QCH) {
      float st[NQ][4];
      float dpt[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
        dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < DP; kk += 16) {
        uint32_t ak[4], av[4];
        load_a(ak, kw, LDI, kk, g, t);
        load_a(av, vw, LDI, kk, g, t);
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          const int off = (qc + n * 8 + g) * LDI + kk + 2 * t;
          mma_16816(st[n], ak, ld32(sQ + off), ld32(sQ + off + 8));
          mma_16816(dpt[n], av, ld32(sdO + off), ld32(sdO + off + 8));
        }
      }

      // P^T in place of S^T, dS^T in place of dP^T
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = qc + n * 8 + 2 * t + (e & 1);
          const bool valid = q0 + ql < sq && key0 + 8 * (e >> 1) < sk;
          const float p = valid ? exp2f(st[n][e] * scale_log2 - sLse[ql]) : 0.f;
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - sDelta[ql]);
        }
      }

      // dV += P^T dO, dK += dS^T Q
#pragma unroll
      for (int kk = 0; kk < QCH / 16; ++kk) {
        uint32_t ap[4], ads[4];
        probs_as_a<NQ>(ap, st, kk);
        probs_as_a<NQ>(ads, dpt, kk);
        const int roff = (qc + kk * 16 + (lane & 15)) * LDI;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          uint32_t b0, b1;
          ldmatrix_x2_trans(b0, b1, sdO + roff + n * 8);
          mma_16816(dvacc[n], ap, b0, b1);
          ldmatrix_x2_trans(b0, b1, sQ + roff + n * 8);
          mma_16816(dkacc[n], ads, b0, b1);
        }
      }
    }
  }

  const size_t kvbase = (size_t)b * sk * rs + (size_t)h * d;
  const float one[2] = {1.f, 1.f};
  const float mul[2] = {scale, scale};
  store_rows_scaled<NO>(dv + kvbase, rs, dvacc, one, key0, sk, 0, d, t);
  store_rows_scaled<NO>(dk + kvbase, rs, dkacc, mul, key0, sk, 0, d, t);
}

template <int DP>
int launch_b4_mma(const void* q, const void* k, const void* v, const void* o, const void* dout,
                  const void* lse, void* dk, void* dv, int batch, int heads, int sq, int sk,
                  int d, float scale, void* stream) {
  const size_t smem = b4_mma_smem_bytes<DP>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkdv_mma<DP, 32>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((sk + kB4MmaKeys - 1) / kB4MmaKeys, batch * heads);
  flash_bwd_dkdv_mma<DP, 32><<<grid, 128, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<bf16*>(dk), static_cast<bf16*>(dv), heads,
      sq, sk, d, scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace icd

// Bytes of the workspace `icd_flash_bwd_dkdv` needs at this shape on the
// current device (0 for head dims above 160).
extern "C" size_t icd_flash_bwd_dkdv_workspace(int batch, int heads, int sq, int sk, int d) {
  return d <= 160 ? icd::b4_workspace_bytes(batch, heads, sq, sk, d) : 0;
}

// `work`: icd_flash_bwd_dkdv_workspace bytes (16-byte aligned), or unused.
extern "C" int icd_flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* o,
                                  const void* dout, const void* lse, void* dk, void* dv,
                                  void* work, int batch, int heads, int sq, int sk, int d,
                                  float scale, void* stream) {
  using namespace icd;
  if (d <= 48) return launch_b4<48>(q, k, v, o, dout, lse, dk, dv, work, batch, heads, sq, sk, d, scale, stream);
  if (d <= 64) return launch_b4<64>(q, k, v, o, dout, lse, dk, dv, work, batch, heads, sq, sk, d, scale, stream);
  if (d <= 80) return launch_b4<80>(q, k, v, o, dout, lse, dk, dv, work, batch, heads, sq, sk, d, scale, stream);
  if (d <= 160) return launch_b4<160>(q, k, v, o, dout, lse, dk, dv, work, batch, heads, sq, sk, d, scale, stream);
  if (d <= 256) return launch_b4_mma<256>(q, k, v, o, dout, lse, dk, dv, batch, heads, sq, sk, d, scale, stream);
  return (int)cudaErrorInvalidValue;
}
