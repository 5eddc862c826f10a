// Kernel Q2: the quantising pass of the int8 layers, sm_90a.
//
// Symmetric int8 codes and fp32 scales of an activation, in the layout kernel
// Q1 (int8_gemm.cu) reads, with the plain version's IEEE steps
// (`quant.quantize_activation_plain`):
//
//   amax  = max |x| over the row (dense) or the tensor (convolution), with
//           an all-zero amax taken as 1.0; under "int8_static" the
//           calibrated amax, max(amax, 1e-12), read from the device;
//   r     = (1 / amax) * 127                (PyTorch's `127.0 / amax` is
//                                             `reciprocal(amax) * 127`: two
//                                             IEEE roundings, __frcp_rn and
//                                             __fmul_rn)
//   q     = clamp(rint(x * r), -127, 127)   (__fmul_rn: no FMA contraction)
//   scale = amax * f32(1/127)
//
// so the codes and scales equal the plain version's bit for bit (a max is
// exact in any order, so the reduction's order is free).
//
// Replaces no TPU kernel: the JAX package's quantisers are XLA element-wise
// and reduction ops (invertible_cd_tpu/ops/quant.py:176-209), which XLA fuses
// into the product's program. Bound: bytes (x read once, codes and scales
// written once). Forms:
//
//   * icd_quantize_rows: x (rows, K) in bf16 or fp32 -> codes (rows, Kp) and
//     one scale a row (a dense layer's per-token scales). One warp a row,
//     which reads its row twice (amax, then the codes; the second read hits
//     L1), 16 codes a lane a store. icd_quantize_rows_amax: the same with
//     each row's amax read from the device (the whole row's, where the
//     row's features are split over tensor-parallel ranks), one read a row.
//   * icd_quantize_tensor: x (B, C, H, W), NCHW or channels-last in memory ->
//     codes (B, H, W, Cp), NHWC, and one scale (a convolution's per-tensor
//     scale). A dynamic amax needs all of x read before the first code is
//     written, so x is read twice unless it stays on chip; that, and not
//     the arithmetic, is what holds the form from its bound. The design, one
//     kernel launch:
//       - a persistent grid of as many blocks as can be resident at once
//         (BLOCKS_PER_SM an SM, each with SLOTS tile slots of SLOT bytes of
//         shared memory), launched cooperatively;
//       - the amax pass: each block reads a contiguous run of tiles (so the
//         loads it has in flight at once read neighbouring bytes) and keeps
//         them in its slots as far as they fit; where they do not, the last
//         RING slots become a ring the rest stream through;
//       - one grid-wide barrier (cooperative groups: the runtime checks that
//         every block is resident and keeps the barrier's state, so nothing
//         is zeroed between launches), after which every block reduces the
//         blocks' partial maxima;
//       - the codes pass: the streamed tiles again, newest first (the L2
//         holds the most recent), then the kept tiles straight from shared
//         memory. A tensor up to the chip's ~26 MB of slots (SD1.5's UNet
//         inputs at batch 4 but the 960-channel concatenation) is read from
//         memory once.
//     NCHW input is read in tiles of SUB boxes, each 64 channels x 128
//     bytes of positions of one image, by TMA (`cp.async.bulk.tensor`,
//     128-byte swizzle) onto the slot's mbarrier; tiles run channel tile
//     fastest, so a block writes whole rows of codes (all Cp channels of
//     its positions) close together in time. The transpose reads a box
//     column by column (each thread one position's 16 (bf16) or 8 (fp32)
//     channels, in an order rotated by its channel chunk, which with the
//     swizzle keeps the reads free of bank conflicts) and writes 64
//     contiguous code bytes a position. Rows whose stride TMA cannot take
//     (H W x the element size not a multiple of 16 bytes) are copied into
//     the same slot layout by the threads. Channels-last input with C a
//     multiple of 16 is an element-wise map, its codes lying as x does: the
//     same loop on tiles of SLOT bytes of x as it lies, by bulk copies
//     (`cp.async.bulk`); with other C (3, 4 and 8: the codes are padded)
//     each thread keeps its first chunks of 16 channels in shared memory
//     and writes their codes from there. Static: the codes pass alone,
//     every slot a ring stage, with the amax read from its device pointer
//     (no barrier, no host sync).
//   * icd_quantize_tensor_amax: the amax pass alone (the dynamic amax of a
//     tensor split over ranks, reduced over them by the caller): a flat
//     read, a grid barrier, block 0 reducing the partial maxima.
// Kp and Cp are K and C rounded up to a multiple of 16 with zero codes, so
// every gather of Q1 is one 16-byte vector (C = 3, 4 and 8 become 16).
// Rounding: rint(y) for |y| <= 127 is the low byte of y + 1.5 * 2^23 under
// round-to-nearest-even (__fadd_rn), the same integer as rintf.
#include <cuda.h>  // CUtensorMap; cuTensorMapEncodeTiled itself is looked up at run time
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

using icd::smem_u32;

constexpr int THREADS = 256;
constexpr int MAX_PARTIALS = 1024;  // the workspace: one fp32 partial amax a block
constexpr int BOX = 8192;           // bytes a box (one TMA copy, 64 channels x 128 bytes of positions)
constexpr int SUB = 2;              // boxes a tile, side by side along the positions
constexpr int SLOT = SUB * BOX;     // bytes a tile slot
constexpr int SLOTS = 6;            // slots a block
constexpr int RING = 3;             // slots that become a ring where a block's tiles do not all fit
constexpr int BLOCKS_PER_SM = 2;    // resident blocks an SM (shared memory and registers allow)
constexpr int SMEM = SLOTS * SLOT + SLOTS * 8 + 1024;  // + the slots' mbarriers, + alignment
constexpr float ROUND = 12582912.f;  // 1.5 * 2^23

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ int8_t code(float x, float r) {
  const float q = rintf(__fmul_rn(x, r));  // half to even, as torch.round
  return static_cast<int8_t>(fminf(fmaxf(q, -127.f), 127.f));
}

// The code of x as the low byte of the result: rint by the 1.5 * 2^23 add;
// CLAMP for a calibrated amax (below max |x|); a dynamic amax keeps
// |x * r| <= 127 (to an ulp), so its codes need none.
template <bool CLAMP>
__device__ __forceinline__ uint32_t code_bits(float x, float r) {
  float y = __fmul_rn(x, r);
  if (CLAMP) y = fminf(fmaxf(y, -127.f), 127.f);
  return __float_as_uint(__fadd_rn(y, ROUND));
}

// the low bytes of four code_bits, in order, in one word
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

__device__ __forceinline__ float scale_of(float amax) { return __fmul_rn(amax, 1.f / 127.f); }

__device__ __forceinline__ float reciprocal_of(float amax) { return __fmul_rn(__frcp_rn(amax), 127.f); }

// 16 consecutive values x[c0 .. c0 + 15] of a row of `k`, zeros past k;
// 16-byte loads where the row allows them.
template <typename T>
__device__ __forceinline__ void load16(const T* row, int c0, int k, bool vec, float (&v)[16]) {
  if (vec && c0 + 16 <= k) {
    constexpr int PER = 16 / sizeof(T);
#pragma unroll
    for (int u = 0; u < 16 / PER; ++u) {
      const int4 raw = *reinterpret_cast<const int4*>(row + c0 + u * PER);
      const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < PER; ++e) v[u * PER + e] = to_float(t[e]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e) v[e] = c0 + e < k ? to_float(row[c0 + e]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) quantize_rows(const T* __restrict__ x, int8_t* __restrict__ q,
                                                         float* __restrict__ scale,
                                                         const float* __restrict__ amax_in, int64_t rows,
                                                         int k, int kp, bool vec) {
  const int64_t row = (int64_t)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + row * k;
  float amax = 0.f;
  if (amax_in != nullptr) {
    amax = amax_in[row];
  } else {
    for (int c0 = lane * 16; c0 < k; c0 += 32 * 16) {
      float v[16];
      load16(xr, c0, k, vec, v);
#pragma unroll
      for (int e = 0; e < 16; ++e) amax = fmaxf(amax, fabsf(v[e]));
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  }
  if (!(amax > 0.f)) amax = 1.f;  // an all-zero row keeps q = 0
  const float r = reciprocal_of(amax);
  int8_t* qr = q + row * kp;
  for (int c0 = lane * 16; c0 < kp; c0 += 32 * 16) {
    float v[16];
    load16(xr, c0, k, vec, v);
    alignas(16) int8_t out[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) out[e] = code(v[e], r);  // v = 0 past k: code 0
    *reinterpret_cast<int4*>(qr + c0) = *reinterpret_cast<const int4*>(out);
  }
  if (lane == 0) scale[row] = scale_of(amax);
}

// block-wide max of v (every thread gets it); `red` holds THREADS / 32 floats
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int i = 1; i < THREADS / 32; ++i) v = fmaxf(v, red[i]);
  __syncthreads();
  return v;
}

// The barrier of the persistent grid, after every block has written its
// partial amax: the grid is launched cooperatively (the runtime refuses a
// grid whose blocks cannot all be resident), and the barrier's state is the
// runtime's, so nothing needs zeroing between launches.
__device__ __forceinline__ void grid_barrier() { cooperative_groups::this_grid().sync(); }

// The tensor's amax in every block after the barrier: the max of the
// blocks' partials (0 -> 1.0).
__device__ __forceinline__ float reduced_amax(const float* partial, float* red) {
  float v = 0.f;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += THREADS) v = fmaxf(v, __ldcg(partial + i));
  const float amax = block_max(v, red);
  return amax > 0.f ? amax : 1.f;
}

// ---------------------------------------------------------------------------
// the tensor form's tiles: SUB boxes of an NCHW tensor (cb channels x pb
// positions of one image each), or SLOT bytes of a flat one
// ---------------------------------------------------------------------------
struct Geo {
  int flat;                 // 1: channels-last input with C = Cp, tiles of SLOT bytes of x as it lies
  int64_t bytes;            // flat: the bytes of x
  int c, cp, hw;            // channels, padded channels, positions (H W)
  int cb, pb;               // a box's channels and positions (a tile: SUB boxes along the positions)
  int ct, pt;               // channel tiles and position tiles an image
  int64_t tiles;            // batch * ct * pt (flat: bytes / SLOT, rounded up)
  int row_bytes;            // pb * sizeof(T): one channel's row of a box
  int box_bytes;            // cb * row_bytes <= BOX
  int swz;                  // 1: rows of 128 bytes in the 128-byte swizzle (cb = 64)
  int tma;                  // 1: boxes by TMA; 0: copied by the threads
};

// the bytes tile t brings into its slot (a flat tensor's last tile may be
// short; box h of an NCHW tile lies at byte h BOX of the slot)
__device__ __forceinline__ int tile_fill(const Geo& g, int64_t t) {
  if (!g.flat) return SUB * g.box_bytes;
  const int64_t left = g.bytes - t * SLOT;
  return left < SLOT ? (int)left : SLOT;
}

struct TileAt {
  int b, c0, p0;
};

// tile t of an NCHW tensor: channel tile fastest, then position tile, then
// image, so a block's run of tiles writes whole rows of codes (all Cp
// channels of its positions) close together in time
__device__ __forceinline__ TileAt tile_at(const Geo& g, int64_t t) {
  const int ct = (int)(t % g.ct);
  const int64_t rest = t / g.ct;
  return {(int)(rest / g.pt), ct * g.cb, (int)(rest % g.pt) * SUB * g.pb};
}

// byte offset of (channel cl, position byte pbyte) in a slot: rows of
// row_bytes; under the swizzle the 16-byte chunk j of row cl lies at j ^ (cl % 8)
__device__ __forceinline__ int slot_offset(const Geo& g, int cl, int pbyte) {
  const int chunk = g.swz ? (pbyte >> 4) ^ (cl & 7) : pbyte >> 4;
  return cl * g.row_bytes + (chunk << 4) + (pbyte & 15);
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(smem_u32(bar))
      : "memory");
}

// `bytes` of x from byte `src` on, into the slot (a flat tile)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the tile's box copied by the threads into the slot's layout (zeros past C
// and HW), where TMA cannot read the rows
template <typename T>
__device__ void copy_tile(uint8_t* slot, const T* x, const Geo& g, TileAt at) {
  const int n = g.cb * g.pb;
  for (int h = 0; h < SUB; ++h) {
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const int cl = i / g.pb, pl = i - cl * g.pb;
      const int ch = at.c0 + cl, pos = at.p0 + h * g.pb + pl;
      const T v = ch < g.c && pos < g.hw ? x[((int64_t)at.b * g.c + ch) * g.hw + pos] : T(0.f);
      *reinterpret_cast<T*>(slot + h * BOX + slot_offset(g, cl, pl * (int)sizeof(T))) = v;
    }
  }
}

// max |x| over a slot (order-free: the tile's bytes as they lie)
template <typename T>
__device__ __forceinline__ float slot_amax(const uint8_t* slot, int bytes, float m) {
  for (int off = threadIdx.x * 16; off < bytes; off += THREADS * 16) {
    const uint4 w = *reinterpret_cast<const uint4*>(slot + off);
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (sizeof(T) == 2) {
        m = fmaxf(m, fabsf(__uint_as_float(ws[i] << 16)));
        m = fmaxf(m, fabsf(__uint_as_float(ws[i] & 0xffff0000u)));
      } else {
        m = fmaxf(m, fabsf(__uint_as_float(ws[i])));
      }
    }
  }
  return m;
}

// Each thread's share of a tile's codes: one position and V channels
// (bf16: 16, a 16-byte store; fp32: 8, an 8-byte store), the same for every
// tile, so the slot offsets of its V values are worked out once. Under the
// swizzle a thread reads its channels starting from its rotation (chunk cc
// of the position starts at channel rot(cc)): the warp's threads then read
// V distinct 16-byte chunks at each step, with no bank conflict. Its codes
// are rotated back into channel order before the store.
template <typename T>
struct Share {
  static constexpr int V = sizeof(T) == 2 ? 16 : 8;
  int off[V];  // slot offset of the s-th value read
  int rot;     // channel of the first value read, within the share
  int pl, cl;  // position and first channel within the tile; pl < 0: no share
};

template <typename T>
__device__ __forceinline__ Share<T> share_of(const Geo& g) {
  constexpr int V = Share<T>::V;
  Share<T> s;
  if (g.flat) {  // flat tiles take no share
    s.pl = -1, s.cl = 0, s.rot = 0;
#pragma unroll
    for (int k = 0; k < V; ++k) s.off[k] = 0;
    return s;
  }
  const int cv = g.cb / V;  // shares a position
  const int i = threadIdx.x;
  s.pl = i < g.pb * cv ? i / cv : -1;
  const int cc = i % cv;
  s.cl = cc * V;
  s.rot = g.swz ? cc * (8 / cv) : 0;
#pragma unroll
  for (int k = 0; k < V; ++k)
    s.off[k] = slot_offset(g, s.cl + ((k + s.rot) & (V - 1)), (s.pl < 0 ? 0 : s.pl) * (int)sizeof(T));
  return s;
}

__device__ __forceinline__ uint32_t word_select(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3, int i) {
  return i == 0 ? w0 : i == 1 ? w1 : i == 2 ? w2 : w3;
}

template <typename T, bool CLAMP>
__device__ __forceinline__ void share_codes(const uint8_t* slot, const Share<T>& s, const Geo& g, TileAt at,
                                            float r, int8_t* __restrict__ q) {
  constexpr int V = Share<T>::V;
  const int pos = at.p0 + s.pl, ch = at.c0 + s.cl;
  if (s.pl < 0 || pos >= g.hw || ch >= g.cp) return;
  uint32_t b[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    float v;
    if (sizeof(T) == 2)
      v = __uint_as_float((uint32_t)(*reinterpret_cast<const uint16_t*>(slot + s.off[k])) << 16);
    else
      v = *reinterpret_cast<const float*>(slot + s.off[k]);
    b[k] = code_bits<CLAMP>(v, r);
  }
  int8_t* dst = q + ((int64_t)at.b * g.hw + pos) * g.cp + ch;
  if constexpr (V == 16) {
    // byte k holds channel (k + rot) mod 16: rotate left by rot bytes
    const uint32_t x0 = pack4(b[0], b[1], b[2], b[3]), x1 = pack4(b[4], b[5], b[6], b[7]);
    const uint32_t x2 = pack4(b[8], b[9], b[10], b[11]), x3 = pack4(b[12], b[13], b[14], b[15]);
    const int ws = s.rot >> 2, bs = (s.rot & 3) * 8;
    const uint32_t y0 = word_select(x0, x3, x2, x1, ws), y1 = word_select(x1, x0, x3, x2, ws);
    const uint32_t y2 = word_select(x2, x1, x0, x3, ws), y3 = word_select(x3, x2, x1, x0, ws);
    uint4 out;
    out.x = __funnelshift_l(y3, y0, bs);
    out.y = __funnelshift_l(y0, y1, bs);
    out.z = __funnelshift_l(y1, y2, bs);
    out.w = __funnelshift_l(y2, y3, bs);
    *reinterpret_cast<uint4*>(dst) = out;
  } else {
    uint64_t x = (uint64_t)pack4(b[0], b[1], b[2], b[3]) | ((uint64_t)pack4(b[4], b[5], b[6], b[7]) << 32);
    const int n = s.rot * 8;
    if (n) x = (x << n) | (x >> (64 - n));
    *reinterpret_cast<uint2*>(dst) = make_uint2((uint32_t)x, (uint32_t)(x >> 32));
  }
}

// A flat tile's codes: x as it lies is channels-last with C = Cp, so the
// codes lie as x does; each thread 32 bytes of x at a time (bf16: 16 values,
// a 16-byte store; fp32: 8, an 8-byte store).
template <typename T, bool CLAMP>
__device__ __forceinline__ void flat_codes32(const uint8_t* slot, int off, int64_t start, float r,
                                             int8_t* __restrict__ q) {
  constexpr int V = sizeof(T) == 2 ? 16 : 8;
  const uint4 w0 = *reinterpret_cast<const uint4*>(slot + off);
  const uint4 w1 = *reinterpret_cast<const uint4*>(slot + off + 16);
  const uint32_t ws[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
  uint32_t b[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float v = sizeof(T) == 2 ? __uint_as_float(k & 1 ? ws[k >> 1] & 0xffff0000u : ws[k >> 1] << 16)
                                   : __uint_as_float(ws[k]);
    b[k] = code_bits<CLAMP>(v, r);
  }
  int8_t* dst = q + (start + off) / (int)sizeof(T);
  if constexpr (V == 16)
    *reinterpret_cast<uint4*>(dst) = make_uint4(pack4(b[0], b[1], b[2], b[3]), pack4(b[4], b[5], b[6], b[7]),
                                                pack4(b[8], b[9], b[10], b[11]),
                                                pack4(b[12], b[13], b[14], b[15]));
  else
    *reinterpret_cast<uint2*>(dst) = make_uint2(pack4(b[0], b[1], b[2], b[3]), pack4(b[4], b[5], b[6], b[7]));
}

template <typename T, bool CLAMP>
__device__ __forceinline__ void flat_codes(const uint8_t* slot, int bytes, int64_t start, float r,
                                           int8_t* __restrict__ q) {
  for (int off = threadIdx.x * 32; off < bytes; off += THREADS * 32)
    flat_codes32<T, CLAMP>(slot, off, start, r, q);
}

// The persistent pass; STATIC: the codes pass alone, with *amax_in.
template <typename T, bool STATIC>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    quantize_tiles(const __grid_constant__ CUtensorMap map, const T* __restrict__ x, const Geo g,
                   int8_t* __restrict__ q, float* __restrict__ scale, const float* __restrict__ amax_in,
                   float* __restrict__ partial) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ float red[THREADS / 32];
  uint8_t* slots = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(slots + SLOTS * SLOT);
  const int G = gridDim.x, blk = blockIdx.x;
  // this block's tiles: a contiguous run, so the loads it has in flight at
  // once read neighbouring bytes of every row
  const int64_t first = blk * g.tiles / G, n = (blk + 1) * g.tiles / G - first;
  // slots [0, kept) keep their tile; [kept, kept + ring) are a ring
  const int kept = STATIC ? 0 : (n <= SLOTS ? (int)n : SLOTS - RING);
  const int ring = STATIC ? SLOTS : (n <= SLOTS ? 0 : RING);
  if (g.tma && threadIdx.x == 0) {
    for (int i = 0; i < SLOTS; ++i) icd::mbar_init(&full[i], 1);
    icd::fence_mbar_init();
  }
  __syncthreads();
  auto slot_ptr = [&](int i) { return slots + i * SLOT; };
  // the load of this block's tile k into slot i (TMA: issued by thread 0;
  // a copy by the threads waits until the tile is needed)
  auto issue = [&](int i, int64_t k) {
    if (g.tma && threadIdx.x == 0) {
      const int64_t t = first + k;
      icd::mbar_expect_tx(&full[i], tile_fill(g, t));
      if (g.flat) {
        bulk_load(slot_ptr(i), reinterpret_cast<const uint8_t*>(x) + t * SLOT, tile_fill(g, t), &full[i]);
      } else {
        const TileAt at = tile_at(g, t);
        for (int h = 0; h < SUB; ++h)
          tma_load_3d(slot_ptr(i) + h * BOX, &map, at.p0 + h * g.pb, at.c0, at.b, &full[i]);
      }
    }
  };
  auto ready = [&](int i, int64_t k, uint32_t parity) {
    if (g.tma) {
      icd::mbar_wait(&full[i], parity);
    } else {
      copy_tile(slot_ptr(i), x, g, tile_at(g, first + k));
      __syncthreads();
    }
  };
  const Share<T> share = share_of<T>(g);
  auto codes = [&](int i, int64_t k, float r) {
    if (g.flat) {
      flat_codes<T, STATIC>(slot_ptr(i), tile_fill(g, first + k), (first + k) * SLOT, r, q);
    } else {
      TileAt at = tile_at(g, first + k);
      for (int h = 0; h < SUB; ++h, at.p0 += g.pb)
        share_codes<T, STATIC>(slot_ptr(i) + h * BOX, share, g, at, r, q);
    }
  };
  auto amax_tile = [&](int i, int64_t k, float m) {
    if (g.flat) return slot_amax<T>(slot_ptr(i), tile_fill(g, first + k), m);
    for (int h = 0; h < SUB; ++h) m = slot_amax<T>(slot_ptr(i) + h * BOX, g.box_bytes, m);
    return m;
  };
  const int64_t streamed = n - kept;  // tiles through the ring in each pass
  float amax;
  if (STATIC) {
    amax = fmaxf(*amax_in, 1e-12f);
  } else {
    // ---- the amax pass ----
    for (int i = 0; i < kept; ++i) issue(i, i);
    for (int64_t j = 0; j < streamed && j < ring; ++j) issue(kept + (int)j, kept + j);
    float m = 0.f;
    for (int i = 0; i < kept; ++i) {
      ready(i, i, 0);
      m = amax_tile(i, i, m);
    }
    for (int64_t j = 0; j < streamed; ++j) {
      const int i = kept + (int)(j % ring);
      ready(i, kept + j, (uint32_t)(j / ring) & 1);
      m = amax_tile(i, kept + j, m);
      __syncthreads();  // the slot is read: it may take the next tile
      if (j + ring < streamed) issue(i, kept + j + ring);
    }
    m = block_max(m, red);
    if (threadIdx.x == 0) partial[blk] = m;
    grid_barrier();
    amax = reduced_amax(partial, red);
  }
  const float r = reciprocal_of(amax);
  if (blk == 0 && threadIdx.x == 0) *scale = scale_of(amax);
  // ---- the codes pass: the streamed tiles newest first, their ring uses
  // continuing the amax pass's ----
  const int64_t used = STATIC ? 0 : streamed;
  for (int64_t j = 0; j < streamed && j < ring; ++j) issue(kept + (int)((used + j) % ring), n - 1 - j);
  for (int64_t j = 0; j < streamed; ++j) {
    const int64_t u = used + j;
    const int i = kept + (int)(u % ring);
    ready(i, n - 1 - j, (uint32_t)(u / ring) & 1);
    codes(i, n - 1 - j, r);
    __syncthreads();
    if (j + ring < streamed) issue(i, n - 1 - j - ring);
  }
  // ---- then the kept tiles, from shared memory ----
  for (int i = 0; i < kept; ++i) codes(i, i, r);
}

// ---------------------------------------------------------------------------
// channels-last input: chunks of 16 channels of one pixel, each thread's
// first chunks kept in shared memory
// ---------------------------------------------------------------------------
template <typename T>
struct Raw16 {
  static constexpr int WORDS = 16 * sizeof(T) / 16;  // int4s of 16 values
  uint4 w[WORDS];
};

template <typename T>
__device__ __forceinline__ void load_raw16(const T* row, int c0, int k, bool vec, Raw16<T>& raw) {
  if (vec && c0 + 16 <= k) {
#pragma unroll
    for (int u = 0; u < Raw16<T>::WORDS; ++u)
      raw.w[u] = *reinterpret_cast<const uint4*>(row + c0 + u * (16 / sizeof(T)));
  } else {
    T* t = reinterpret_cast<T*>(raw.w);
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      if (c0 + e < k)
        t[e] = row[c0 + e];
      else
        t[e] = T(0.f);
    }
  }
}

template <typename T>
__device__ __forceinline__ float raw_value(const Raw16<T>& raw, int e) {
  return to_float(reinterpret_cast<const T*>(raw.w)[e]);
}

template <typename T, bool CLAMP>
__device__ __forceinline__ void raw_codes(const Raw16<T>& raw, float r, int8_t* dst) {
  uint32_t b[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) b[e] = code_bits<CLAMP>(raw_value(raw, e), r);
  *reinterpret_cast<uint4*>(dst) = make_uint4(pack4(b[0], b[1], b[2], b[3]), pack4(b[4], b[5], b[6], b[7]),
                                              pack4(b[8], b[9], b[10], b[11]),
                                              pack4(b[12], b[13], b[14], b[15]));
}

template <typename T, bool STATIC>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    quantize_nhwc(const T* __restrict__ x, int64_t pixels, int c, int cp, bool vec, int8_t* __restrict__ q,
                  float* __restrict__ scale, const float* __restrict__ amax_in, float* __restrict__ partial) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ float red[THREADS / 32];
  constexpr int UNROLL = 4;
  constexpr int KEEP = SLOTS * SLOT / (THREADS * (int)sizeof(Raw16<T>));  // chunks a thread keeps
  Raw16<T>* kept_chunks = reinterpret_cast<Raw16<T>*>(smem_raw);  // chunk k of thread t at k THREADS + t
  const int chunks = cp / 16;
  const int64_t units = pixels * chunks;
  const int64_t gt = (int64_t)blockIdx.x * THREADS + threadIdx.x, stride = (int64_t)gridDim.x * THREADS;
  const int64_t n = units > gt ? (units - 1 - gt) / stride + 1 : 0;  // this thread's chunks
  auto load = [&](int64_t k, Raw16<T>& raw) {
    const int64_t u = gt + k * stride;
    const int64_t pix = u / chunks;
    load_raw16(x + pix * c, (int)(u - pix * chunks) * 16, c, vec, raw);
  };
  auto dst = [&](int64_t k) {
    const int64_t u = gt + k * stride;
    const int64_t pix = u / chunks;
    return q + pix * cp + (u - pix * chunks) * 16;
  };
  float amax;
  int64_t keep = 0;
  if (STATIC) {
    amax = fmaxf(*amax_in, 1e-12f);
  } else {
    keep = n < KEEP ? n : KEEP;
    float m = 0.f;
    for (int64_t k0 = 0; k0 < n; k0 += UNROLL) {
      Raw16<T> raw[UNROLL];
#pragma unroll
      for (int j = 0; j < UNROLL; ++j)
        if (k0 + j < n) load(k0 + j, raw[j]);
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) {
        if (k0 + j >= n) break;
#pragma unroll
        for (int e = 0; e < 16; ++e) m = fmaxf(m, fabsf(raw_value(raw[j], e)));
        if (k0 + j < keep) kept_chunks[(k0 + j) * THREADS + threadIdx.x] = raw[j];
      }
    }
    m = block_max(m, red);
    if (threadIdx.x == 0) partial[blockIdx.x] = m;
    grid_barrier();
    amax = reduced_amax(partial, red);
  }
  const float r = reciprocal_of(amax);
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale = scale_of(amax);
  // the chunks not kept, newest first, then the kept ones from shared memory
  for (int64_t k0 = n - 1; k0 >= keep; k0 -= UNROLL) {
    Raw16<T> raw[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j)
      if (k0 - j >= keep) load(k0 - j, raw[j]);
#pragma unroll
    for (int j = 0; j < UNROLL; ++j)
      if (k0 - j >= keep) raw_codes<T, STATIC>(raw[j], r, dst(k0 - j));
  }
  for (int64_t k = 0; k < keep; ++k)
    raw_codes<T, STATIC>(kept_chunks[k * THREADS + threadIdx.x], r, dst(k));
}

// ---------------------------------------------------------------------------
// the amax pass alone
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS) amax_flat(const T* __restrict__ x, int64_t n, bool vec,
                                                     float* __restrict__ partial, float* __restrict__ out) {
  __shared__ float red[THREADS / 32];
  constexpr int PER = 16 / sizeof(T);
  constexpr int UNROLL = 4;
  float m = 0.f;
  const int64_t gt = (int64_t)blockIdx.x * THREADS + threadIdx.x, stride = (int64_t)gridDim.x * THREADS;
  if (vec) {  // n % PER == 0 and x 16-byte aligned
    const int64_t nv = n / PER;
    for (int64_t i0 = gt; i0 < nv; i0 += UNROLL * stride) {
      uint4 w[UNROLL];
#pragma unroll
      for (int j = 0; j < UNROLL; ++j)
        if (i0 + j * stride < nv) w[j] = __ldcs(reinterpret_cast<const uint4*>(x) + i0 + j * stride);
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) {
        if (i0 + j * stride >= nv) break;
        const T* t = reinterpret_cast<const T*>(&w[j]);
#pragma unroll
        for (int e = 0; e < PER; ++e) m = fmaxf(m, fabsf(to_float(t[e])));
      }
    }
  } else {
    for (int64_t i = gt; i < n; i += stride) m = fmaxf(m, fabsf(to_float(x[i])));
  }
  m = block_max(m, red);
  if (threadIdx.x == 0) partial[blockIdx.x] = m;
  grid_barrier();
  if (blockIdx.x != 0) return;
  const float amax = reduced_amax(partial, red);
  if (threadIdx.x == 0) *out = amax;
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_fn() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
  if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) != cudaSuccess ||
      found != cudaDriverEntryPointSuccess)
    return nullptr;
  return reinterpret_cast<EncodeTiledFn>(fn);
}

// x (batch, c, hw) as a 3-D map of boxes {pb positions, cb channels, 1
// image}; reads past C or HW come back as zeros
cudaError_t x_tensor_map(CUtensorMap* map, const void* x, int elem, int batch, const Geo& g) {
  static EncodeTiledFn encode = encode_fn();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)g.hw, (cuuint64_t)g.c, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)g.hw * elem, (cuuint64_t)g.hw * elem * g.c};
  const cuuint32_t box[3] = {(cuuint32_t)g.pb, (cuuint32_t)g.cb, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUresult r =
      encode(map, elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(x), dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
             g.swz ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0 && cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    count[dev] = 132;
  return count[dev];
}

// blocks of `kernel` resident at once (with `smem` bytes of dynamic shared
// memory each), capped at `work` and at the workspace's partials
template <typename K>
int persistent_blocks(K kernel, int smem, int64_t work, cudaError_t* err) {
  int per_sm = 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (*err != cudaSuccess) return 0;
  if (per_sm < 1) {
    *err = cudaErrorInvalidConfiguration;
    return 0;
  }
  int64_t blocks = (int64_t)per_sm * sm_count();
  if (blocks > MAX_PARTIALS) blocks = MAX_PARTIALS;
  if (blocks > work) blocks = work;
  return (int)(blocks < 1 ? 1 : blocks);
}

template <typename K>
cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
}

template <typename T>
int rows_launch(const void* x, void* q, void* scale, const void* amax, int64_t rows, int k, int kp,
                cudaStream_t stream) {
  const bool vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) && (k % (16 / sizeof(T)) == 0);
  const int64_t blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  quantize_rows<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q), static_cast<float*>(scale),
      static_cast<const float*>(amax), rows, k, kp, vec);
  return (int)cudaGetLastError();
}

// A persistent kernel with a grid barrier goes through the cooperative
// launch (the runtime checks that every block can be resident); the static
// form, which has none, through a plain one.
template <typename... P>
int launch(void (*kernel)(P...), int blocks, int smem, bool cooperative, cudaStream_t stream, void** args) {
  if (cooperative)
    return (int)cudaLaunchCooperativeKernel((const void*)kernel, blocks, THREADS, args, smem, stream);
  return (int)cudaLaunchKernel((const void*)kernel, blocks, THREADS, args, smem, stream);
}

template <typename T, bool STATIC>
int tiles_launch(const T* x, int batch, Geo g, int8_t* q, float* scale, const float* amax, float* partial,
                 cudaStream_t stream) {
  static const cudaError_t attr = allow_smem(quantize_tiles<T, STATIC>);
  if (attr != cudaSuccess) return (int)attr;
  cudaError_t e;
  const int blocks = persistent_blocks(quantize_tiles<T, STATIC>, SMEM, g.tiles, &e);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));  // a placeholder where no box is read (flat tiles, or copies)
  if (g.tma && !g.flat) {
    e = x_tensor_map(&map, x, (int)sizeof(T), batch, g);
    if (e != cudaSuccess) return (int)e;
  }
  void* args[] = {&map, &x, &g, &q, &scale, &amax, &partial};
  return launch(quantize_tiles<T, STATIC>, blocks, SMEM, !STATIC, stream, args);
}

template <typename T, bool STATIC>
int nhwc_launch(const T* x, int64_t pixels, int c, int cp, int8_t* q, float* scale, const float* amax,
                float* partial, cudaStream_t stream) {
  static const cudaError_t attr = allow_smem(quantize_nhwc<T, STATIC>);
  if (attr != cudaSuccess) return (int)attr;
  cudaError_t e;
  const int blocks =
      persistent_blocks(quantize_nhwc<T, STATIC>, SMEM, (pixels * (cp / 16) + THREADS - 1) / THREADS, &e);
  if (e != cudaSuccess) return (int)e;
  bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && c % (16 / sizeof(T)) == 0;
  void* args[] = {&x, &pixels, &c, &cp, &vec, &q, &scale, &amax, &partial};
  return launch(quantize_nhwc<T, STATIC>, blocks, SMEM, !STATIC, stream, args);
}

// the tile geometry of an NCHW tensor: boxes of 64 channels x 128 bytes of
// positions (in the 128-byte swizzle) where Cp >= 64; below, Cp channels and
// as many positions (a power of two up to 256) as keep a box within BOX
// bytes; a tile is SUB boxes side by side along the positions
template <typename T>
bool nchw_geometry(const void* x, int c, int64_t hw, int cp, int batch, Geo& g) {
  if (hw >= (1LL << 31)) return false;
  g.flat = 0, g.bytes = 0;
  g.c = c, g.cp = cp, g.hw = (int)hw;
  g.cb = cp < 64 ? cp : 64;
  g.pb = 256;
  while (g.cb * g.pb * (int)sizeof(T) > BOX) g.pb /= 2;
  g.swz = g.cb == 64 && g.pb * (int)sizeof(T) == 128;
  g.row_bytes = g.pb * (int)sizeof(T);
  g.box_bytes = g.cb * g.row_bytes;
  g.ct = (cp + g.cb - 1) / g.cb;
  g.pt = (int)((hw + SUB * g.pb - 1) / (SUB * g.pb));
  g.tiles = (int64_t)batch * g.ct * g.pt;
  // TMA reads rows whose stride is a multiple of 16 bytes, from a 16-byte aligned base
  g.tma = reinterpret_cast<uintptr_t>(x) % 16 == 0 && (hw * (int64_t)sizeof(T)) % 16 == 0;
  return true;
}

template <typename T>
int tensor_launch(const void* xv, int channels_last, void* qv, void* scalev, const void* amaxv,
                  void* workspace, int batch, int c, int h, int w, int cp, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  int8_t* q = static_cast<int8_t*>(qv);
  float* scale = static_cast<float*>(scalev);
  const float* amax = static_cast<const float*>(amaxv);
  float* partial = static_cast<float*>(workspace);
  const int64_t hw = (int64_t)h * w;
  Geo g;
  if (channels_last && (c % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)) {
    const int64_t pixels = (int64_t)batch * hw;  // codes padded past C: the chunk path
    return amax == nullptr ? nhwc_launch<T, false>(x, pixels, c, cp, q, scale, amax, partial, stream)
                           : nhwc_launch<T, true>(x, pixels, c, cp, q, scale, amax, partial, stream);
  }
  if (channels_last) {  // C = Cp: the codes lie as x does, tiles of SLOT bytes of it
    memset(&g, 0, sizeof(g));
    g.flat = 1, g.tma = 1;
    g.bytes = (int64_t)batch * c * hw * (int64_t)sizeof(T);
    g.tiles = (g.bytes + SLOT - 1) / SLOT;
  } else if (!nchw_geometry<T>(xv, c, hw, cp, batch, g)) {
    return (int)cudaErrorInvalidValue;
  }
  return amax == nullptr ? tiles_launch<T, false>(x, batch, g, q, scale, amax, partial, stream)
                         : tiles_launch<T, true>(x, batch, g, q, scale, amax, partial, stream);
}

template <typename T>
int amax_launch(const void* xv, int64_t n, void* outv, void* workspace, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  float* partial = static_cast<float*>(workspace);
  float* out = static_cast<float*>(outv);
  cudaError_t e;
  const int blocks = persistent_blocks(amax_flat<T>, 0, (n + THREADS * 16 - 1) / (THREADS * 16), &e);
  if (e != cudaSuccess) return (int)e;
  bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && n % (16 / sizeof(T)) == 0;
  void* args[] = {&x, &n, &vec, &partial, &out};
  return launch(amax_flat<T>, blocks, 0, true, stream, args);
}

}  // namespace

// x_kind: 1 fp32, 2 bf16. Codes (rows, kp), kp a multiple of 16 >= k; one scale a row.
extern "C" int icd_quantize_rows(const void* x, int x_kind, void* q, void* scale, long long rows, int k,
                                 int kp, cudaStream_t stream) {
  if (rows <= 0 || k <= 0 || kp < k || kp % 16 != 0) return (int)cudaErrorInvalidValue;
  if (x_kind == 1) return rows_launch<float>(x, q, scale, nullptr, rows, k, kp, stream);
  if (x_kind == 2) return rows_launch<__nv_bfloat16>(x, q, scale, nullptr, rows, k, kp, stream);
  return (int)cudaErrorInvalidValue;
}

// As icd_quantize_rows, each row quantised with amax[row] (fp32 on the device,
// rows of them; 0 taken as 1.0, as the dynamic amax of an all-zero row).
extern "C" int icd_quantize_rows_amax(const void* x, int x_kind, void* q, void* scale, const void* amax,
                                      long long rows, int k, int kp, cudaStream_t stream) {
  if (rows <= 0 || k <= 0 || kp < k || kp % 16 != 0 || amax == nullptr) return (int)cudaErrorInvalidValue;
  if (x_kind == 1) return rows_launch<float>(x, q, scale, amax, rows, k, kp, stream);
  if (x_kind == 2) return rows_launch<__nv_bfloat16>(x, q, scale, amax, rows, k, kp, stream);
  return (int)cudaErrorInvalidValue;
}

// x (batch, c, h, w), NCHW (channels_last 0) or channels-last (1) in memory;
// codes (batch, h, w, cp) and one scale. `amax`: the calibrated amax (one fp32
// on the device) or null for a dynamic amax; `workspace`:
// icd_quantize_workspace_floats() fp32 (the blocks' partial amaxes; unused
// when `amax` is given). One kernel launch.
extern "C" int icd_quantize_tensor(const void* x, int x_kind, int channels_last, void* q, void* scale,
                                   const void* amax, void* workspace, int batch, int c, int h, int w, int cp,
                                   cudaStream_t stream) {
  if (batch <= 0 || c <= 0 || h <= 0 || w <= 0 || cp < c || cp % 16 != 0) return (int)cudaErrorInvalidValue;
  if (amax == nullptr && workspace == nullptr) return (int)cudaErrorInvalidValue;
  if (x_kind == 1)
    return tensor_launch<float>(x, channels_last, q, scale, amax, workspace, batch, c, h, w, cp, stream);
  if (x_kind == 2)
    return tensor_launch<__nv_bfloat16>(x, channels_last, q, scale, amax, workspace, batch, c, h, w, cp,
                                        stream);
  return (int)cudaErrorInvalidValue;
}

// The dynamic amax of n elements of x (any dense layout): max |x| into `out`
// (one fp32 on the device), 1.0 for an all-zero x; `workspace` as above.
extern "C" int icd_quantize_tensor_amax(const void* x, int x_kind, void* out, void* workspace, long long n,
                                        cudaStream_t stream) {
  if (n <= 0 || out == nullptr || workspace == nullptr) return (int)cudaErrorInvalidValue;
  if (x_kind == 1) return amax_launch<float>(x, n, out, workspace, stream);
  if (x_kind == 2) return amax_launch<__nv_bfloat16>(x, n, out, workspace, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int icd_quantize_workspace_floats() { return MAX_PARTIALS; }
