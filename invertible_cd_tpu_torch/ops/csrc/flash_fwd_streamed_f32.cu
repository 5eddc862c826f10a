// Kernel B2 on fp32 input: flash-attention forward for large head dims
// (256 < d <= 512), fp32 Q, K, V and O.
//
// Replaces `_fwd_kernel_streamed` in invertible_cd_tpu/ops/flash_attention.py
// on the inputs the JAX package gives it in fp32 (its docstring: "fp32
// inputs (SDXL's fp32 VAE at 16k tokens)"): SDXL's VAE runs in fp32 by
// default, and its mid-block attends with one d = 512 head over 128^2 =
// 16384 tokens, in the encoder at batch 1 and the decoder at batch 1 and 2.
// The JAX kernel's products there are fp32-input products with fp32
// accumulation; this kernel's are TF32 tensor-core products (operands
// rounded to nearest, ties away, by cvt.rna) with fp32 accumulation, and
// fp32 everywhere else: the softmax (exp2f, not the MUFU approximation),
// the running max and sums, the output. The bf16 build of B2
// (flash_fwd_streamed.cu, SDXL's `vae_dtype=bf16` opt-in and SD1.5's VAE)
// is a separate source, so its code and numbers stay as they are.
//
// What bounds it on an H100 SXM (700 W): operations. One image at 16384
// tokens does 4 * 16384^2 * 512 = 5.50e11 FLOP: 1.11 ms at TF32's 494.7
// TFLOP/s dense; its 2.7e8 exponentials take 0.07 ms; Q, K, V and O are
// 134 MB, 0.04 ms at 3.35 TB/s.
//
// Two routes, chosen by d. d = 512 (every caller) takes the Hopper design
// below; 256 < d < 512 keeps the first version (`flash_fwd_b2_f32`, the
// mma.sync route further down: 8.05 ms at 16384^2, 0.14 of the bound).
//
// The d = 512 route. What held the first version back: every operand
// fragment re-read from shared memory and re-rounded on every 16-key tile
// (Q's included), three block barriers a tile, and each 64-row block
// streaming all of K and V alone (16 GiB from L2 per image). Two facts of
// fp32 shape the redesign: a 64-row Q tile at d = 512 is 128 KB and a
// useful K tile another 128 KB, against the 227 KB a block may hold; and
// TF32 wgmma reads shared operands K-major only, while V as stored ((S, d)
// row-major) is MN-major for P V. So:
//   * a prepass (`b2_tf32_prepass`, same launch) writes K rounded to TF32,
//     (B*H, Skp, 512), and V transposed and rounded, (B*H, 512, Skp), keys
//     contiguous, into the wrapper's workspace; Skp is Sk rounded up to the
//     32-key tile, the rows past Sk zeros (0.05 ms at batch 1). Q is
//     rounded in place in shared memory once it has landed. Each operand is
//     rounded once, not once a tile;
//   * the head dim is split across a pair of blocks: each holds Q[64 rows,
//     its 256 columns] (64 KB) and streams K[:, its half] and V^T[its half,
//     :] through rings of two 32-key stages each (128 KB). It computes the
//     partial logits over its half (wgmma.m64n32k8, Q and K from shared
//     memory in the 128-byte swizzle, 32 k-steps), and the two partials
//     meet through distributed shared memory: each thread st.async-es its
//     16 values into the peer block, completing bytes on the peer's
//     exchange barrier (8 KB a tile). IEEE addition commutes, so both
//     blocks hold the same S, m, l and P. Each then owns O[:, its half],
//     an m64n256 fp32 accumulator (128 registers a thread), and adds P V^T
//     with P from registers (rounded by cvt.rna) as the A operand and the
//     V^T tile as B (wgmma.m64n256k8, four k-steps a tile);
//   * the A operand of m64nNk8 holds columns t and t + 4 where the logits'
//     accumulator holds keys 2t and 2t + 1: the prepass stores each 8-key
//     group of V^T in the order 0 2 4 6 1 3 5 7, so that P's accumulator
//     registers are the A operand as they are;
//   * a cluster of four blocks is 2 neighbouring 64-row query tiles x the
//     two halves. The pair of blocks with the same half shares each K and
//     V^T tile: one copies K tiles, the other V^T tiles, each a single TMA
//     box multicast into both, so each K/V byte brought on chip feeds 128
//     query rows. A stage's `full` mbarrier is armed by its own consumers
//     when they release it (so no copy can land on an unarmed phase), and
//     the copying block's `empty` mbarrier counts both consumers' releases,
//     arrived with relaxed ordering (the readers are wgmma products already
//     waited for; a release at cluster scope cost ~800 cycles a call);
//   * one consumer warpgroup and one producer warp (160 threads: the
//     consumers take 255 registers without setmaxnreg). Per key tile j the
//     consumers issue the next tile's 32 logit products in four groups of
//     8, with tile j's exchange and softmax written between the groups
//     (issuing waits on the tensor cores; the warps compute meanwhile);
//     those products queue behind P V(j-1), which is left in flight across
//     the loop edge and waited for (wait_group 1) only before the rescale
//     of O. The last tile is peeled off so that the groups' pattern is the
//     same on every pass of the loop: ptxas serialises every wgmma of a
//     kernel once it cannot prove that no register a product in flight
//     writes is read, and it could not with a commit under a run-time
//     branch. The next tile's partial goes to the peer once its products
//     are done and before P V(j) is issued (an st.async of those registers
//     with a product in flight is such a read);
//   * the softmax is the first version's (online_softmax, exp2f), without
//     the key mask on every tile but a split's last; the accumulator's
//     rescale is skipped by a warp whose alphas are all 1;
//   * filling the card: 208 KB of shared memory, one block an SM; an H100
//     SXM holds 30 clusters of four at once (cudaOccupancyMaxActiveClusters,
//     120 SMs). 16384 rows give 128 clusters a (batch, head): 5 rounds of
//     30 where 4.27 would do, so where a split saves 8% or more of the
//     rounds (t32_plan) the key range is cut into up to 4 splits, each
//     writing fp32 partials (unnormalised O, m, l) that a second pass
//     (b2_tf32_combine) merges in split order. No atomics: repeats are
//     bit-identical. Batch 1 takes 3 splits, batch 2 none.
// What bounds it: the consumer warpgroup's serial path, about 2000 cycles a
// 32-key tile against 1354 for its products alone on one warpgroup (841 the
// logits, at 24 cycles a product: Q and K read from shared memory each
// time; 576 P V; a probe of the products alone) and 1280 at the SM's TF32
// peak. Of the rest, the softmax takes ~550 cycles a tile and the wait for
// the peer's partial ~280 (clock64 stamps in a patched copy); issuing more
// logit groups before that wait did not hide it. On an H100 SXM (700 W),
// at (1, 16384^2, 1, 512) 2.66 ms (0.42 of the bound), at batch 2 5.24 ms
// (0.42); the first version 7.95 and 15.92. Tried, in order, at batch 1 / 2
// (ms): this design with
// wgmma serialised by ptxas (the send read the logits' registers while
// P V ran) 8.54 / 15.43; unserialised, the send after P V 6.16 / 11.09;
// the send before P V 5.54 / 10.00; two accumulators for the logits'
// k-steps (the chain was not the limit; spills) 5.72; relaxed `empty`
// arrivals 3.87 / 6.98; a second consumer warpgroup that owns O and issues
// P V, P handed over through shared memory (ptxas then held each thread to
// 168 registers, spilled, and injected a warpgroup.wait) 5.27 / 9.55; the
// softmax between the issue groups 3.48 / 6.29; P V in flight across the
// loop edge without the peeled tile (serialised again) 6.06; peeled 2.94 /
// 5.34; the split 2.77 / 5.53; the key mask on a split's last tile only
// 2.66 / 5.24.
// Rows past Sq come in as zeros (TMA fills the out-of-bounds rows; a query
// tile wholly past Sq, the second of an odd count, computes zeros it never
// stores); keys past Sk are the prepass's zero rows and get -1e30 logits.
// The second entry point also writes the fp32 row logsumexp (natural log,
// (B, H, Sq)).
#include <cuda.h>  // CUtensorMap; cuTensorMapEncodeTiled itself is looked up at run time

#include <type_traits>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace icd {

// ---------------------------------------------------------------------------
// the d = 512 route
// ---------------------------------------------------------------------------
constexpr int kT32D = 512;                // head width of this route
constexpr int kT32Half = kT32D / 2;       // head-dim columns a block
constexpr int kT32Rows = 64;              // query rows a block
constexpr int kT32Keys = 32;              // keys a tile
constexpr int kT32Consumers = 128;        // one consumer warpgroup
constexpr int kT32Threads = kT32Consumers + 32;  // and one producer warp
constexpr int kT32Cluster = 4;            // 2 query tiles x 2 head-dim halves
constexpr uint32_t kT32QBytes = kT32Rows * kT32Half * 4;   // 64 KB
constexpr uint32_t kT32KBytes = kT32Keys * kT32Half * 4;   // 32 KB a K stage
constexpr uint32_t kT32VBytes = kT32Half * kT32Keys * 4;   // 32 KB a V^T stage
constexpr uint32_t kT32XBytes = kT32Rows * kT32Keys * 4;   // 8 KB of partial logits
constexpr int kT32Bars = 11;  // Q; full and empty of K and V, exchange: two stages each

constexpr size_t t32_smem_bytes() {  // + 1024 to align the swizzled tiles
  return (size_t)kT32QBytes + 2 * kT32KBytes + 2 * kT32VBytes + 2 * kT32XBytes + kT32Bars * 8 +
         1024;
}

constexpr int kT32MaxSplits = 4;   // key-range splits at most
constexpr int kT32MinTiles = 8;    // key tiles a split takes at least

// Keys rounded up to whole tiles: the workspace's row count a (batch, head).
inline int t32_keys_padded(int sk) { return (sk + kT32Keys - 1) / kT32Keys * kT32Keys; }

// The prepass: for key tile blockIdx.x of (batch, head) blockIdx.y,
//   kr[bh][s][c] = tf32(K[b][s][h][c]),  vt[bh][c][8 (s / 8) + p(s % 8)] = tf32(V[b][s][h][c]),
// p = (0 4 1 5 2 6 3 7) (place of key s % 8 in the group order 0 2 4 6 1 3 5 7), zeros for
// s >= sk. V goes through shared memory 128 columns at a time.
__global__ void __launch_bounds__(256)
b2_tf32_prepass(const float* __restrict__ k, const float* __restrict__ v, float* __restrict__ kr,
                float* __restrict__ vt, int heads, int sk, int skp) {
  __shared__ float tile[kT32Keys][128 + 1];
  const int s0 = blockIdx.x * kT32Keys;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const size_t rs = (size_t)heads * kT32D;
  const float* kb = k + (size_t)b * sk * rs + (size_t)h * kT32D;
  const float* vb = v + (size_t)b * sk * rs + (size_t)h * kT32D;
  float* krb = kr + ((size_t)bh * skp + s0) * kT32D;
  float* vtb = vt + (size_t)bh * kT32D * skp + s0;
  const int tid = threadIdx.x;
  for (int idx = tid; idx < kT32Keys * kT32D / 4; idx += 256) {
    const int r = idx / (kT32D / 4);
    const int c = (idx - r * (kT32D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s0 + r < sk) x = *reinterpret_cast<const float4*>(kb + (size_t)(s0 + r) * rs + c);
    *reinterpret_cast<float4*>(krb + (size_t)r * kT32D + c) =
        make_float4(__uint_as_float(to_tf32(x.x)), __uint_as_float(to_tf32(x.y)),
                    __uint_as_float(to_tf32(x.z)), __uint_as_float(to_tf32(x.w)));
  }
  for (int c0 = 0; c0 < kT32D; c0 += 128) {
    __syncthreads();  // the last chunk's reads are done
    for (int idx = tid; idx < kT32Keys * 32; idx += 256) {
      const int r = idx / 32;
      const int c = (idx - r * 32) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s0 + r < sk) x = *reinterpret_cast<const float4*>(vb + (size_t)(s0 + r) * rs + c0 + c);
      tile[r][c] = x.x;
      tile[r][c + 1] = x.y;
      tile[r][c + 2] = x.z;
      tile[r][c + 3] = x.w;
    }
    __syncthreads();
    // V^T row c0 + c, places 4j .. 4j + 3 of the tile: keys 8 (j / 2) + (j % 2) + {0, 2, 4, 6}
    for (int idx = tid; idx < 128 * (kT32Keys / 4); idx += 256) {
      const int c = idx / (kT32Keys / 4);
      const int j = idx - c * (kT32Keys / 4);
      const int key = 8 * (j / 2) + (j % 2);
      *reinterpret_cast<float4*>(vtb + (size_t)(c0 + c) * skp + 4 * j) =
          make_float4(__uint_as_float(to_tf32(tile[key][c])),
                      __uint_as_float(to_tf32(tile[key + 2][c])),
                      __uint_as_float(to_tf32(tile[key + 4][c])),
                      __uint_as_float(to_tf32(tile[key + 6][c])));
    }
  }
}

__global__ void __cluster_dims__(kT32Cluster, 1, 1) __launch_bounds__(kT32Threads, 1)
flash_fwd_b2_tf32(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, float* __restrict__ o,
                  float* __restrict__ lse, float* __restrict__ part_o,
                  float2* __restrict__ part_ml, int heads, int sq, int sk, int tiles,
                  float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  float* sQ = reinterpret_cast<float*>(smem);                 // [8 blocks][64 rows][32], swizzled
  uint8_t* sK = smem + kT32QBytes;                            // 2 x [8 blocks][32 keys][32]
  uint8_t* sV = sK + 2 * kT32KBytes;                          // 2 x [256 rows][32 keys]
  float4* sX = reinterpret_cast<float4*>(sV + 2 * kT32VBytes);  // 2 x [4][128 threads]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sX + 2 * kT32XBytes / 16);
  uint64_t* k_full = q_full + 1;   // a K stage landed
  uint64_t* k_empty = q_full + 3;  // both consumers of a K stage are done (in the copying block)
  uint64_t* v_full = q_full + 5;
  uint64_t* v_empty = q_full + 7;
  uint64_t* x_full = q_full + 9;   // the peer's partial logits of a tile landed

  const uint32_t rank = cluster_rank();
  const int half = rank & 1;   // head-dim columns 256 half ..
  const int pair = rank >> 1;  // which query tile of the cluster's two
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = ((blockIdx.x / kT32Cluster) * 2 + pair) * kT32Rows;
  const int j0 = blockIdx.z * tiles;  // this split's first key tile
  const int n = min((sk + kT32Keys - 1) / kT32Keys, j0 + tiles) - j0;  // and its count (>= 1)
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < 2; ++st) {
      mbar_init(&k_full[st], 1);
      mbar_init(&v_full[st], 1);
      mbar_init(&x_full[st], 1);
      mbar_init(&k_empty[st], 2);
      mbar_init(&v_empty[st], 2);
    }
    fence_mbar_init();
    // the first phases: Q, and tiles 0 and 1 of K, V^T and the peer's logits
    mbar_expect_tx(q_full, kT32QBytes);
    for (int st = 0; st < 2 && st < n; ++st) {
      mbar_expect_tx(&k_full[st], kT32KBytes);
      mbar_expect_tx(&v_full[st], kT32VBytes);
      mbar_expect_tx(&x_full[st], kT32XBytes);
    }
  }
  cluster_sync();  // every block's barriers are set up before any copy targets them

  if (tid >= kT32Consumers) {
    // ---------------- producer: Q, and K tiles (pair 0) or V^T tiles (pair 1) ----------------
    if (tid == kT32Consumers) {
      tma_load_5d(sQ, &tq, 0, q0, half * (kT32Half / 32), h, b, q_full);
      const uint16_t mask = (uint16_t)((1u << half) | (1u << (half + 2)));
      for (int i = 0; i < n; ++i) {
        const int st = i & 1;
        if (pair == 0) {
          if (i >= 2) mbar_wait(&k_empty[st], ((i >> 1) - 1) & 1);
          tma_load_4d_multicast(sK + st * kT32KBytes, &tk, 0, (j0 + i) * kT32Keys, half * (kT32Half / 32),
                                bh, &k_full[st], mask);
        } else {
          if (i >= 2) mbar_wait(&v_empty[st], ((i >> 1) - 1) & 1);
          tma_load_3d_multicast(sV + st * kT32VBytes, &tv, (j0 + i) * kT32Keys, half * kT32Half, bh,
                                &v_full[st], mask);
        }
      }
    }
    __syncwarp();
    cluster_sync();  // as the consumers' below
    return;
  }

  // ---------------- consumers ----------------
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const uint32_t peer = rank ^ 1u;             // the other half of these rows
  const uint32_t k_src = (uint32_t)half;       // the block that copies this half's K tiles
  const uint32_t v_src = 2u + (uint32_t)half;  // and its V^T tiles
  const uint32_t x_peer = cluster_addr(sX, peer);
  const uint32_t xbar_peer = cluster_addr(x_full, peer);

  // Q landed: round it to TF32 in place and hand it to wgmma's proxy
  mbar_wait(q_full, 0);
  {
    float4* q4 = reinterpret_cast<float4*>(sQ);
    for (int idx = tid; idx < (int)(kT32QBytes / 16); idx += kT32Consumers) {
      const float4 x = q4[idx];
      q4[idx] = make_float4(__uint_as_float(to_tf32(x.x)), __uint_as_float(to_tf32(x.y)),
                            __uint_as_float(to_tf32(x.z)), __uint_as_float(to_tf32(x.w)));
    }
  }
  fence_proxy_async();
  named_sync(1, kT32Consumers);

  const uint64_t desc_q = smem_desc_sw128(sQ);
  const uint64_t desc_k = smem_desc_sw128(sK);
  const uint64_t desc_v = smem_desc_sw128(sV);
  // k-steps kk0 .. kk0 + 7 of S (64 x 32) = Q_half K_half^T over this
  // block's 256 columns: k-step kk is 32-float block kk / 4 at byte
  // (kk % 4) * 32
  auto logits = [&](float (&d)[4][4], int st, int kk0) {
    const uint64_t kb = desc_k + ((uint64_t)st * kT32KBytes >> 4);
#pragma unroll
    for (int kk = kk0; kk < kk0 + 8; ++kk) {
      const uint32_t in_block = (kk & 3) * 32;
      wgmma_ss_tf32(d, desc_q + (((kk >> 2) * kT32Rows * 128 + in_block) >> 4),
                    kb + (((kk >> 2) * kT32Keys * 128 + in_block) >> 4), kk > 0);
    }
  };
  // this thread's partial logits into the peer's exchange buffer `st`
  auto send = [&](const float (&d)[4][4], int st) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      st_async_v4(x_peer + ((st * 4 + c) * kT32Consumers + tid) * 16, d[c][0], d[c][1], d[c][2],
                  d[c][3], xbar_peer + st * 8);
    }
  };
  // a stage of K (or V^T) is done with: re-arm its `full` barrier for tile
  // i + 2, then count this consumer's release in the copying block
  auto release = [&](uint64_t* full, uint64_t* empty, int i, uint32_t bytes, uint32_t src) {
    if (tid == 0) {
      if (i + 2 < n) mbar_expect_tx(&full[i & 1], bytes);
      mbar_arrive_cluster_relaxed(&empty[i & 1], src);
    }
  };

  float acc[kT32Half / 8][4];
#pragma unroll
  for (int c = 0; c < kT32Half / 8; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float s[4][4];   // this tile's logits: this block's partial, then all of them
  float sn[4][4];  // the next tile's partial

  // Each issue window (wgmma_fence .. commit) is fenced on both sides by
  // fence_regs of the registers its products write or read, so the compiler
  // moves no other access to them into it; and no register a product in
  // flight writes is read (ptxas serialises every wgmma of the kernel when
  // it finds either).
  mbar_wait(&k_full[0], 0);
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk0 = 0; kk0 < kT32Half / 8; kk0 += 8) logits(s, 0, kk0);
  wgmma_commit();
  fence_regs(s);
  wgmma_wait<0>();
  fence_regs(s);
  release(k_full, k_empty, 0, kT32KBytes, k_src);
  send(s, 0);

  uint32_t pa[4][4];  // P as the A operand of P V
  // One key tile; `more` (a compile-time flag: every tile but the last)
  // says that the next tile's logits are issued under this one. The last
  // tile is peeled off so that the pattern of issued, committed and waited
  // groups in the loop is fixed, as ptxas needs it to keep the products
  // asynchronous.
  auto tile = [&](int i, auto more_flag) {
    constexpr bool more = decltype(more_flag)::value;
    const int st = i & 1;
    const uint32_t ph = (i >> 1) & 1;
    // The next tile's partial logits (32 products, issued in four groups of
    // 8) queue behind the last tile's P V and run under this tile's exchange
    // and softmax, which are written between the groups: issuing waits on
    // the tensor cores, and the warps compute meanwhile.
    if constexpr (more) {
      mbar_wait(&k_full[st ^ 1], ((i + 1) >> 1) & 1);
      fence_regs(sn);
      wgmma_fence();
      logits(sn, st ^ 1, 0);
    }
    mbar_wait(&x_full[st], ph);  // the peer's partial of tile i
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 y = sX[(st * 4 + c) * kT32Consumers + tid];
      s[c][0] += y.x;
      s[c][1] += y.y;
      s[c][2] += y.z;
      s[c][3] += y.w;
    }
    if (tid == 0 && i + 2 < n) mbar_expect_tx(&x_full[st], kT32XBytes);
    if constexpr (more) logits(sn, st ^ 1, 8);
    float alpha[2];
    // only a split's last tile can reach past Sk: the others skip the key mask
    online_softmax<4, !more>(s, m, l, alpha, scale_log2, (j0 + i) * kT32Keys, sk, t);
    if constexpr (more) {
      logits(sn, st ^ 1, 16);
      logits(sn, st ^ 1, 24);
      wgmma_commit();
      fence_regs(sn);
      wgmma_wait<1>();  // the last tile's P V is done (these logits may still run)
    } else {
      wgmma_wait<0>();
    }
    fence_regs(acc);
    fence_regs(pa);
    if (i > 0) release(v_full, v_empty, i - 1, kT32VBytes, v_src);
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int c = 0; c < kT32Half / 8; ++c) {
        acc[c][0] *= alpha[0];
        acc[c][1] *= alpha[0];
        acc[c][2] *= alpha[1];
        acc[c][3] *= alpha[1];
      }
    }
    // k-step c takes keys 8c .. 8c + 7, a0..a3 = keys 2t (rows g, g + 8)
    // and 2t + 1 (rows g, g + 8)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      pa[c][0] = to_tf32(s[c][0]);
      pa[c][1] = to_tf32(s[c][2]);
      pa[c][2] = to_tf32(s[c][1]);
      pa[c][3] = to_tf32(s[c][3]);
    }
    if constexpr (more) {  // the next tile's partial is done: off to the peer before P V
      wgmma_wait<0>();
      fence_regs(sn);
      release(k_full, k_empty, i + 1, kT32KBytes, k_src);
      send(sn, st ^ 1);
    }
    mbar_wait(&v_full[st], ph);
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      wgmma_rs_tf32(acc, pa[c], desc_v + (((uint64_t)st * kT32VBytes + c * 32) >> 4), 1);
    }
    wgmma_commit();
    fence_regs(acc);
    fence_regs(pa);
    if constexpr (more) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[c][e] = sn[c][e];
    }
  };
  for (int i = 0; i + 1 < n; ++i) tile(i, std::true_type{});
  tile(n - 1, std::false_type{});
  wgmma_wait<0>();
  fence_regs(acc);
  release(v_full, v_empty, n - 1, kT32VBytes, v_src);

  const int row0 = q0 + warp * 16 + g;
  const size_t rs = (size_t)heads * kT32D;
  if (part_o == nullptr) {
    const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
    float* ob = o + (size_t)b * sq * rs + (size_t)h * kT32D + half * kT32Half + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= sq) continue;
#pragma unroll
      for (int c = 0; c < kT32Half / 8; ++c) {
        *reinterpret_cast<float2*>(ob + (size_t)row * rs + c * 8) =
            make_float2(acc[c][2 * r] * inv[r], acc[c][2 * r + 1] * inv[r]);
      }
    }
    // both halves hold the same m and l: the first writes
    if (lse != nullptr && half == 0) store_lse(lse + (size_t)bh * sq, m, l, row0, sq, t);
  } else {
    // a split of the key range: the unnormalised rows, m (base-2 units) and l
    const size_t prow = ((size_t)blockIdx.z * gridDim.y + bh) * sq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= sq) continue;
      float* dst = part_o + (prow + row) * kT32D + half * kT32Half + 2 * t;
#pragma unroll
      for (int c = 0; c < kT32Half / 8; ++c) {
        *reinterpret_cast<float2*>(dst + c * 8) = make_float2(acc[c][2 * r], acc[c][2 * r + 1]);
      }
      if (half == 0 && t == 0) part_ml[prow + row] = make_float2(m[r], l[r]);
    }
  }
  cluster_sync();  // no copy, st.async or arrival of a peer still targets this block
}

// Merges the splits' partials of one query row and 8 columns (a thread),
// in split order: M = max m_i, L = sum 2^(m_i - M) l_i, o = sum 2^(m_i - M)
// O_i / L; the thread of columns 0..7 also writes lse = ln2 (M + log2 L).
__global__ void b2_tf32_combine(const float* __restrict__ part_o,
                                const float2* __restrict__ part_ml, float* __restrict__ o,
                                float* __restrict__ lse, int splits, int bh_count, int heads,
                                int sq) {
  constexpr int chunks = kT32D / 8;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)bh_count * sq * chunks) return;
  const int c = (int)(idx % chunks);
  const size_t rowi = idx / chunks;  // bh * sq + r
  const size_t stride = (size_t)bh_count * sq;  // rows between splits
  float mx = kNegInf;
  for (int z = 0; z < splits; ++z) mx = fmaxf(mx, part_ml[z * stride + rowi].x);
  float L = 0.f;
  float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0;
  for (int z = 0; z < splits; ++z) {
    const float2 ml = part_ml[z * stride + rowi];
    const float w = exp2f(ml.x - mx);
    L += w * ml.y;
    const float4* src = reinterpret_cast<const float4*>(part_o + (z * stride + rowi) * kT32D + c * 8);
    const float4 x = src[0], y = src[1];
    a0.x += w * x.x; a0.y += w * x.y; a0.z += w * x.z; a0.w += w * x.w;
    a1.x += w * y.x; a1.y += w * y.y; a1.z += w * y.z; a1.w += w * y.w;
  }
  const float inv = 1.f / fmaxf(L, 1e-30f);
  const int bh = (int)(rowi / sq);
  const int r = (int)(rowi - (size_t)bh * sq);
  const int b = bh / heads;
  const int h = bh - b * heads;
  float4* dst = reinterpret_cast<float4*>(o + (((size_t)b * sq + r) * heads + h) * kT32D + c * 8);
  dst[0] = make_float4(a0.x * inv, a0.y * inv, a0.z * inv, a0.w * inv);
  dst[1] = make_float4(a1.x * inv, a1.y * inv, a1.z * inv, a1.w * inv);
  if (lse != nullptr && c == 0) lse[rowi] = kLn2 * (mx + log2f(fmaxf(L, 1e-30f)));
}

// Clusters of the kernel the current device holds at once
// (cudaOccupancyMaxActiveClusters, asked once), or a negative CUDA error.
inline int t32_resident_clusters() {
  static const int clusters = [] {
    const size_t smem = t32_smem_bytes();
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_b2_tf32,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return -(int)e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(1024 * kT32Cluster, 1);
    cfg.blockDim = dim3(kT32Threads);
    cfg.dynamicSmemBytes = smem;
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, flash_fwd_b2_tf32, &cfg);
    return e == cudaSuccess ? n : -(int)e;
  }();
  return clusters;
}

// How the key tiles are cut: `tiles` a split, `splits` splits. Clusters
// all take the same time, so a launch takes ceil(clusters / resident)
// rounds of them; a split into s key ranges makes s times as many
// clusters, each 1/s as long. The split with the fewest rounds (in whole
// key ranges) is taken where it saves 8% or more of the unsplit rounds
// (the partials' write and merge cost 2-3%), each split at least
// kT32MinTiles key tiles. SDXL's VAE: 128 clusters a batch item against
// 30 resident on an H100 SXM: batch 1 takes 3 splits (13/3 rounds against
// 5), batch 2 none (26/3 against 9).
struct T32Plan {
  int tiles;
  int splits;
};

inline T32Plan t32_plan(int bh, int sq, int sk) {
  const int nt = (sk + kT32Keys - 1) / kT32Keys;
  const long long clusters = (long long)bh * (((sq + kT32Rows - 1) / kT32Rows + 1) / 2);
  const int resident = t32_resident_clusters();
  int best = 1;
  if (resident > 0) {
    auto rounds = [&](int s) { return (double)((clusters * s + resident - 1) / resident) / s; };
    double best_rounds = rounds(1);
    for (int s2 = 2; s2 <= kT32MaxSplits && nt / s2 >= kT32MinTiles; ++s2) {
      if (rounds(s2) < best_rounds) {
        best = s2;
        best_rounds = rounds(s2);
      }
    }
    if (best_rounds > 0.92 * rounds(1)) best = 1;
  }
  const int tiles = (nt + best - 1) / best;
  return {tiles, (nt + tiles - 1) / tiles};
}

// Workspace bytes at d = 512: the prepass's K and V^T, and for a split key
// range the partial outputs and (m, l) of every split.
inline size_t t32_workspace_bytes(int batch, int heads, int sq, int sk) {
  const size_t bh = (size_t)batch * heads;
  const T32Plan plan = t32_plan((int)bh, sq, sk);
  size_t bytes = 2 * bh * t32_keys_padded(sk) * kT32D * sizeof(float);
  if (plan.splits > 1) bytes += (size_t)plan.splits * bh * sq * (kT32D * sizeof(float) + sizeof(float2));
  return bytes;
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// An fp32 tensor map of `rank` dims (innermost first; strides in bytes of
// dims 1..rank-1) read in `box` boxes that land in the 128-byte swizzle;
// out-of-bounds elements are zeros.
inline cudaError_t t32_tensor_map(CUtensorMap* map, const void* base, int rank,
                                  const cuuint64_t* dims, const cuuint64_t* strides,
                                  const cuuint32_t* box) {
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
  const cuuint32_t steps[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<void*>(base),
                            dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

int launch_b2_tf32_prepass(const void* k, const void* v, void* work, int batch, int heads, int sk,
                           cudaStream_t s) {
  if (work == nullptr || sk <= 0) return (int)cudaErrorInvalidValue;
  const int skp = t32_keys_padded(sk);
  const int bh = batch * heads;
  float* kr = static_cast<float*>(work);
  float* vt = kr + (size_t)bh * skp * kT32D;
  b2_tf32_prepass<<<dim3(skp / kT32Keys, bh), 256, 0, s>>>(
      static_cast<const float*>(k), static_cast<const float*>(v), kr, vt, heads, sk, skp);
  return (int)cudaGetLastError();
}

int launch_b2_tf32(const void* q, const void* k, const void* v, void* o, void* lse, void* work,
                   int batch, int heads, int sq, int sk, float scale, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  int err = launch_b2_tf32_prepass(k, v, work, batch, heads, sk, s);
  if (err != 0) return err;
  const int skp = t32_keys_padded(sk);
  const int bh = batch * heads;
  float* kr = static_cast<float*>(work);  // the workspace: K rounded, V^T, a split's partials
  float* vt = kr + (size_t)bh * skp * kT32D;
  CUtensorMap tq, tk, tv;
  {  // Q (B, Sq, H, 512) as (32 floats, row, 32-float block, head, batch)
    const cuuint64_t row = (cuuint64_t)heads * kT32D * 4;
    const cuuint64_t dims[5] = {32, (cuuint64_t)sq, kT32D / 32, (cuuint64_t)heads, (cuuint64_t)batch};
    const cuuint64_t strides[4] = {row, 128, kT32D * 4, row * sq};
    const cuuint32_t box[5] = {32, kT32Rows, kT32Half / 32, 1, 1};
    cudaError_t r = t32_tensor_map(&tq, q, 5, dims, strides, box);
    if (r != cudaSuccess) return (int)r;
  }
  {  // K rounded, (B*H, Skp, 512), as (32 floats, key, 32-float block, bh)
    const cuuint64_t dims[4] = {32, (cuuint64_t)skp, kT32D / 32, (cuuint64_t)bh};
    const cuuint64_t strides[3] = {kT32D * 4, 128, (cuuint64_t)skp * kT32D * 4};
    const cuuint32_t box[4] = {32, kT32Keys, kT32Half / 32, 1};
    cudaError_t r = t32_tensor_map(&tk, kr, 4, dims, strides, box);
    if (r != cudaSuccess) return (int)r;
  }
  {  // V^T rounded, (B*H, 512, Skp), as (key, head-dim row, bh)
    const cuuint64_t dims[3] = {(cuuint64_t)skp, kT32D, (cuuint64_t)bh};
    const cuuint64_t strides[2] = {(cuuint64_t)skp * 4, (cuuint64_t)skp * kT32D * 4};
    const cuuint32_t box[3] = {kT32Keys, kT32Half, 1};
    cudaError_t r = t32_tensor_map(&tv, vt, 3, dims, strides, box);
    if (r != cudaSuccess) return (int)r;
  }
  const size_t smem = t32_smem_bytes();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_b2_tf32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const T32Plan plan = t32_plan(bh, sq, sk);
  float* part_o = nullptr;
  float2* part_ml = nullptr;
  if (plan.splits > 1) {
    part_o = vt + (size_t)bh * skp * kT32D;
    part_ml = reinterpret_cast<float2*>(part_o + (size_t)plan.splits * bh * sq * kT32D);
  }
  const int tiles = (sq + kT32Rows - 1) / kT32Rows;
  dim3 grid((tiles + 1) / 2 * kT32Cluster, bh, plan.splits);
  flash_fwd_b2_tf32<<<grid, kT32Threads, smem, s>>>(
      tq, tk, tv, static_cast<float*>(o), static_cast<float*>(lse), part_o, part_ml, heads, sq, sk,
      plan.tiles, scale * kLog2e);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || part_o == nullptr) return (int)e;
  const size_t threads = (size_t)bh * sq * (kT32D / 8);
  b2_tf32_combine<<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(
      part_o, part_ml, static_cast<float*>(o), static_cast<float*>(lse), plan.splits, bh, heads, sq);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the mma.sync route (256 < d < 512; the first version of this build)
// ---------------------------------------------------------------------------
// One block is 64 query rows of one (batch, head), Q resident in shared
// memory (130 KB with its row padding), single 16-key tiles of K and V
// (33 KB each) filled by cp.async in turn: the next K tile loads under the
// softmax and P V of this one, the next V tile under the next logits. 8
// warps: warp w owns query rows 16 (w % 4) .. +15 and head-dim half w / 4
// (a 16 x 256 fp32 accumulator, 128 registers a thread); its logits are the
// partial S over its half, and the two partials of a pair of warps meet
// through 8 KB of shared memory. mma.sync.m16n8k8 .tf32 takes its
// fragments from registers, loaded from any layout, so V needs no
// transposed copy. Fragments (PTX ISA, m16n8k8 .tf32): A a0 = (g, t),
// a1 = (g+8, t), a2 = (g, t+4), a3 = (g+8, t+4); B b0 = (k=t, n=g),
// b1 = (k=t+4, n=g); C as m16n8k16's. The reduction index is relabelled,
// k = t <-> 2t and k = t+4 <-> 2t+1, in both operands: Q and K fragments
// are then float2 loads, and the C layout of S is already P's A operand.
// Row strides are padded against bank conflicts (Q and K by 8 floats, V by
// 4); the logits accumulate in two sets (even and odd k-steps).
constexpr int kF32Dp = 512;              // compile-time head width
constexpr int kF32Half = kF32Dp / 2;     // head-dim columns of one warp of a pair
constexpr int kF32Rows = 64;             // query rows a block
constexpr int kF32Keys = 16;             // keys a tile
constexpr int kF32LdQK = kF32Dp + 8;     // row strides in shared memory, floats
constexpr int kF32LdV = kF32Dp + 4;
constexpr int kF32Threads = 256;
constexpr int kF32NO = kF32Half / 8;     // 8-column tiles of a warp's accumulator

constexpr size_t f32_smem_bytes() {  // Q, a K tile, a V tile, the logits exchange
  return sizeof(float) * ((size_t)(kF32Rows + kF32Keys) * kF32LdQK + (size_t)kF32Keys * kF32LdV +
                          (size_t)(kF32Threads / 32) * 8 * 32);
}

// c += a * b, one m16n8k8 tile, TF32 operands, fp32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copies `rows` rows of d fp32 values (global row stride `gstride`) into a
// shared tile of width kF32Dp and row stride `ld`, zero-filling rows at or
// past `valid` and columns d..kF32Dp; d is a multiple of 8, so a 16-byte
// chunk is wholly inside the row or wholly padding. valid >= 1, so `src`
// itself is a readable address for the zero-filling copies.
__device__ __forceinline__ void load_rows_f32(float* dst, int ld, const float* src,
                                              size_t gstride, int rows, int valid, int d) {
  constexpr int chunks = kF32Dp / 4;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += kF32Threads) {
    const int r = idx / chunks;
    const int c = (idx - r * chunks) * 4;
    const bool ok = r < valid && c < d;
    cp_async16(dst + r * ld + c, ok ? src + (size_t)r * gstride + c : src, ok);
  }
}

__global__ void __launch_bounds__(kF32Threads, 1)
flash_fwd_b2_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 int heads, int sq, int sk, int d, float scale_log2) {
  extern __shared__ __align__(16) float smem_f32[];
  float* sQ = smem_f32;                   // [kF32Rows][kF32LdQK]
  float* sK = sQ + kF32Rows * kF32LdQK;   // [kF32Keys][kF32LdQK]
  float* sV = sK + kF32Keys * kF32LdQK;   // [kF32Keys][kF32LdV]
  float* sX = sV + kF32Keys * kF32LdV;    // [warp][8 logits][32 lanes]

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y - b * heads;
  const int q0 = blockIdx.x * kF32Rows;
  const size_t rs = (size_t)heads * d;  // row stride of (B, S, H, D)
  const float* qb = q + (size_t)b * sq * rs + (size_t)h * d;
  const float* kb = k + (size_t)b * sk * rs + (size_t)h * d;
  const float* vb = v + (size_t)b * sk * rs + (size_t)h * d;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int rg = warp % 4;    // rows 16 rg .. 16 rg + 15 of the block
  const int half = warp / 4;  // head-dim columns 256 half .. 256 half + 255
  const int nt = (sk + kF32Keys - 1) / kF32Keys;

  load_rows_f32(sQ, kF32LdQK, qb + (size_t)q0 * rs, rs, kF32Rows, sq - q0, d);
  load_rows_f32(sK, kF32LdQK, kb, rs, kF32Keys, sk, d);
  cp_async_commit();  // Q and K tile 0
  load_rows_f32(sV, kF32LdV, vb, rs, kF32Keys, sk, d);
  cp_async_commit();  // V tile 0

  float acc[kF32NO][4];
#pragma unroll
  for (int c = 0; c < kF32NO; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  const float* qrow = sQ + (rg * 16 + g) * kF32LdQK + half * kF32Half + 2 * t;
  const float* krow = sK + g * kF32LdQK + half * kF32Half + 2 * t;
  const float* vrow = sV + 2 * t * kF32LdV + half * kF32Half + g;
  float* mine = sX + warp * 8 * 32 + lane;
  const float* other = sX + (warp ^ 4) * 8 * 32 + lane;

  for (int j = 0; j < nt; ++j) {
    cp_async_wait<1>();  // Q and K tile j landed (V tile j may be in flight)
    __syncthreads();

    // this warp's partial logits over its half of the head dim, 16 rows x
    // 16 keys (two 8-key tiles), even and odd k-steps in separate sums
    float s[2][4], s2[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = s2[n][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < kF32Half / 8; kk += 2) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = (kk + u) * 8;
        const float2 x0 = *reinterpret_cast<const float2*>(qrow + c);
        const float2 x1 = *reinterpret_cast<const float2*>(qrow + 8 * kF32LdQK + c);
        const uint32_t a[4] = {to_tf32(x0.x), to_tf32(x1.x), to_tf32(x0.y), to_tf32(x1.y)};
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const float2 y = *reinterpret_cast<const float2*>(krow + n * 8 * kF32LdQK + c);
          mma_tf32(u ? s2[n] : s[n], a, to_tf32(y.x), to_tf32(y.y));
        }
      }
    }
    // the two halves' partials meet: lane `lane` of warps w and w ^ 4 holds
    // the same 8 (row, key) entries
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] += s2[n][e];
        mine[(n * 4 + e) * 32] = s[n][e];
      }
    __syncthreads();  // every warp is done with K tile j; the partials are posted
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] += other[(n * 4 + e) * 32];
    if (j + 1 < nt) {
      load_rows_f32(sK, kF32LdQK, kb + (size_t)(j + 1) * kF32Keys * rs, rs, kF32Keys,
                    sk - (j + 1) * kF32Keys, d);
    }
    cp_async_commit();  // K tile j+1 (an empty group on the last tile)

    float alpha[2];
    online_softmax<2>(s, m, l, alpha, scale_log2, j * kF32Keys, sk, t);
#pragma unroll
    for (int c = 0; c < kF32NO; ++c) {
      acc[c][0] *= alpha[0];
      acc[c][1] *= alpha[0];
      acc[c][2] *= alpha[1];
      acc[c][3] *= alpha[1];
    }

    cp_async_wait<1>();  // V tile j landed (K tile j+1 may be in flight)
    __syncthreads();
    // O[:, this half] += P V: k-step n takes the keys of 8-key tile n; P's
    // columns 2t, 2t+1 are k = t, t+4, and so are V's rows 2t, 2t+1
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const uint32_t a[4] = {to_tf32(s[n][0]), to_tf32(s[n][2]), to_tf32(s[n][1]),
                             to_tf32(s[n][3])};
      const float* vn = vrow + n * 8 * kF32LdV;
#pragma unroll
      for (int c = 0; c < kF32NO; ++c) {
        mma_tf32(acc[c], a, to_tf32(vn[c * 8]), to_tf32(vn[kF32LdV + c * 8]));
      }
    }
    __syncthreads();  // every warp is done with V tile j
    if (j + 1 < nt) {
      load_rows_f32(sV, kF32LdV, vb + (size_t)(j + 1) * kF32Keys * rs, rs, kF32Keys,
                    sk - (j + 1) * kF32Keys, d);
    }
    cp_async_commit();  // V tile j+1 (an empty group on the last tile)
  }
  cp_async_wait<0>();

  const int row0 = q0 + rg * 16 + g;
  const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
  float* ob = o + (size_t)b * sq * rs + (size_t)h * d;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= sq) continue;
#pragma unroll
    for (int c = 0; c < kF32NO; ++c) {
      const int col = half * kF32Half + c * 8 + 2 * t;
      if (col < d) {
        *reinterpret_cast<float2*>(ob + (size_t)row * rs + col) =
            make_float2(acc[c][2 * r] * inv[r], acc[c][2 * r + 1] * inv[r]);
      }
    }
  }
  // both warps of a pair hold the same m and l: the first half writes
  if (lse != nullptr && half == 0) store_lse(lse + (size_t)blockIdx.y * sq, m, l, row0, sq, t);
}

int launch_b2_f32_mma(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
                  int heads, int sq, int sk, int d, float scale, void* stream) {
  if (d > kF32Dp || d % 8 || sq <= 0 || sk <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = f32_smem_bytes();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_b2_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((sq + kF32Rows - 1) / kF32Rows, batch * heads);
  flash_fwd_b2_f32<<<grid, kF32Threads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), heads, sq, sk, d, scale * kLog2e);
  return (int)cudaGetLastError();
}

int launch_b2_f32(const void* q, const void* k, const void* v, void* o, void* lse, void* work,
                  int batch, int heads, int sq, int sk, int d, float scale, void* stream) {
  if (d == kT32D) {
    if (sq <= 0 || sk <= 0) return (int)cudaErrorInvalidValue;
    return launch_b2_tf32(q, k, v, o, lse, work, batch, heads, sq, sk, scale, stream);
  }
  return launch_b2_f32_mma(q, k, v, o, lse, batch, heads, sq, sk, d, scale, stream);
}

}  // namespace icd

// Clusters of B2 fp32's d = 512 kernel the current device holds at once
// (its launch plan splits the key range by it), or a negative CUDA error.
extern "C" int icd_flash_fwd_streamed_f32_clusters(void) { return icd::t32_resident_clusters(); }

// Bytes of the workspace `icd_flash_fwd_streamed_f32(_lse)` needs at this
// shape on the current device (0 at d < 512).
extern "C" size_t icd_flash_fwd_streamed_f32_workspace(int batch, int heads, int sq, int sk, int d) {
  return d == icd::kT32D ? icd::t32_workspace_bytes(batch, heads, sq, sk) : 0;
}

// `work`: icd_flash_fwd_streamed_f32_workspace bytes (16-byte aligned);
// unused at d < 512.
extern "C" int icd_flash_fwd_streamed_f32(const void* q, const void* k, const void* v, void* o,
                                          void* work, int batch, int heads, int sq, int sk, int d,
                                          float scale, void* stream) {
  return icd::launch_b2_f32(q, k, v, o, nullptr, work, batch, heads, sq, sk, d, scale, stream);
}

// The same kernel, also writing lse (B, H, Sq) fp32.
extern "C" int icd_flash_fwd_streamed_f32_lse(const void* q, const void* k, const void* v,
                                              void* o, void* lse, void* work, int batch, int heads,
                                              int sq, int sk, int d, float scale, void* stream) {
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  return icd::launch_b2_f32(q, k, v, o, lse, work, batch, heads, sq, sk, d, scale, stream);
}

// The d = 512 route's prepass alone (for the card test of its layout):
// k, v as above; the first 2 * B * H * Skp * 512 floats of `work` (Skp = Sk
// rounded up to 32) get the rounded K, (B * H, Skp, 512), then V^T,
// (B * H, 512, Skp).
extern "C" int icd_flash_fwd_streamed_f32_prepass(const void* k, const void* v, void* work,
                                                  int batch, int heads, int sq, int sk, int d,
                                                  float scale, void* stream) {
  (void)sq;
  (void)scale;
  if (d != icd::kT32D) return (int)cudaErrorInvalidValue;
  return icd::launch_b2_tf32_prepass(k, v, work, batch, heads, sk, (cudaStream_t)stream);
}
