// Pieces shared by the flash-attention kernels, forward B1 (flash_fwd.cu) and
// B2 (flash_fwd_streamed.cu) and backward B3 (flash_bwd_dq.cu) and B4
// (flash_bwd_dkdv.cu): bf16 tensor-core products, tile loads, the fp32
// online-softmax update, the row stores and the backward's split plan.
//
// All kernels take bf16 q (B, Sq, H, D) and k/v (B, Sk, H, D), contiguous,
// the layout the model's projections produce (no head transpose); o, dO and
// the gradients have the layout of the tensor they belong to, and the row
// logsumexp is fp32 (B, H, Sq) in natural log. The mma.sync routes' products
// (the wgmma ones are in hopper.cuh) use `mma.sync.m16n8k16` (bf16 in, fp32
// accumulate) with the operand layouts of the PTX ISA:
//   A (16x16, row-major):  a0 = (g, 2t..2t+1)   a1 = (g+8, 2t..)
//                          a2 = (g, 2t+8..)     a3 = (g+8, 2t+8..)
//   B (16x8, k-major):     b0 = (k=2t.., n=g)   b1 = (k=2t+8.., n=g)
//   C (16x8, fp32):        c0,c1 = (g, 2t..2t+1)   c2,c3 = (g+8, 2t..)
// where g = lane / 4 and t = lane % 4. So a thread owns rows g and g+8 of
// every accumulator tile, the softmax state of those two rows lives in its
// registers, and the probabilities of two adjacent 8-key tiles are already
// the A operand of the P V product.
//
// The head dim is padded with zeros in shared memory only (to the kernel's
// compile-time width); padded Q/K columns add nothing to the logits, padded
// V columns give output columns that are never stored. Keys past Sk get
// -1e30 logits and zero V, so 0 * garbage never reaches P V.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace icd {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// The dot product of two 8-element bf16 vectors (16 bytes each) in fp32.
// By value: a reference to memory would read the pairs by 4-byte loads.
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float sum = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 xf = __bfloat1622float2(x[e]);
    const float2 yf = __bfloat1622float2(y[e]);
    sum += xf.x * yf.x + xf.y * yf.y;
  }
  return sum;
}

// c += a * b, one m16n8k16 tile.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A operand (16 rows x 16 columns at column k0) from a row-major bf16 tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int ld,
                                       int k0, int g, int t) {
  a[0] = ld32(tile + g * ld + k0 + 2 * t);
  a[1] = ld32(tile + (g + 8) * ld + k0 + 2 * t);
  a[2] = ld32(tile + g * ld + k0 + 8 + 2 * t);
  a[3] = ld32(tile + (g + 8) * ld + k0 + 8 + 2 * t);
}

// B operand (16 x 8, k-major) read transposed out of a row-major tile whose
// rows are the k index: lanes 0..15 pass the address of row k0 + lane at
// column n0 (8 bf16 = 16 bytes, 16-byte aligned); ldmatrix hands thread
// (g, t) the pairs (k = 2t..2t+1, n = g) and (k = 2t+8.., n = g). Lanes
// 16..31 pass any valid address.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1, const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(addr));
}

// Copies `rows` rows of d bf16 values (global row stride `gstride`) into a
// row-major shared tile of width dp (stride ld), zero-filling rows at or
// past `valid` and columns d..dp. d is a multiple of 8, so each 16-byte
// chunk is wholly inside the row or wholly padding. Consecutive threads take
// consecutive chunks of a row (coalesced reads).
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src,
                                          size_t gstride, int rows, int valid,
                                          int d, int dp) {
  const int chunks = dp / 8;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += blockDim.x) {
    const int r = idx / chunks;
    const int c = (idx - r * chunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid && c < d) val = *reinterpret_cast<const uint4*>(src + (size_t)r * gstride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// The same rows stored transposed, dst[col][row] (stride ldt), so that the
// P V product reads its B operand (k = key, n = head column) as 32-bit
// pairs of consecutive keys. Consecutive threads take consecutive rows, so
// their 2-byte stores land in consecutive shared-memory words.
__device__ __forceinline__ void load_rows_transposed(bf16* dst, int ldt, const bf16* src,
                                                     size_t gstride, int rows, int valid,
                                                     int d, int dp) {
  const int chunks = dp / 8;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += blockDim.x) {
    const int r = idx % rows;
    const int c = (idx / rows) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid && c < d) val = *reinterpret_cast<const uint4*>(src + (size_t)r * gstride + c);
    const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(c + i) * ldt + r] = e[i];
  }
}

// Online-softmax update for one warp's 16 rows over NT 8-key tiles of
// logits `s` (in place: logits in, fp32 probabilities out). `m`/`l` are the
// running max and sum of rows g (index 0) and g+8 (index 1), in the base-2
// domain (logits are pre-multiplied by log2(e)/sqrt(d)). Keys at or past
// `sk` (key index = k0 + n*8 + 2t + e) are masked, unless `Mask` is false
// (a caller's tile wholly below sk). Returns the factors the accumulator
// rows must be rescaled by.
template <int NT, bool Mask = true>
__device__ __forceinline__ void online_softmax(float (&s)[NT][4], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], float scale_log2,
                                               int k0, int sk, int t) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + n * 8 + 2 * t + (e & 1);
      const float x = !Mask || key < sk ? s[n][e] * scale_log2 : kNegInf;
      s[n][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(s[n][e] - m[e >> 1]);
      s[n][e] = p;
      sum[e >> 1] += p;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    l[r] = l[r] * alpha[r] + sum[r];
  }
}

// A operand of P V for keys 16*kk .. 16*kk+15: the probabilities of 8-key
// tiles 2kk and 2kk+1, rounded to bf16.
template <int NT>
__device__ __forceinline__ void probs_as_a(uint32_t (&a)[4], const float (&s)[NT][4], int kk) {
  a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
  a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
  a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
}

// Multiplies rows g and g+8 of the accumulator tiles by `mul` and stores the
// rows below `limit` and the columns below d; `col0` is the first column of
// tile 0, `row0` the global row of g.
template <int NT>
__device__ __forceinline__ void store_rows_scaled(bf16* o, size_t row_stride,
                                                  const float (&acc)[NT][4], const float (&mul)[2],
                                                  int row0, int limit, int col0, int d, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= limit) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = col0 + n * 8 + 2 * t;
      if (col < d) {
        *reinterpret_cast<uint32_t*>(o + (size_t)row * row_stride + col) =
            pack_bf16(acc[n][2 * r] * mul[r], acc[n][2 * r + 1] * mul[r]);
      }
    }
  }
}

// Divides rows g and g+8 of the accumulator tiles by max(l, 1e-30) and
// stores the columns below d; `col0` is the first column of tile 0, `row0`
// the global query row of g.
template <int NT>
__device__ __forceinline__ void store_rows(bf16* o, size_t row_stride, const float (&acc)[NT][4],
                                           const float (&l)[2], int row0, int sq, int col0,
                                           int d, int t) {
  const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
  store_rows_scaled<NT>(o, row_stride, acc, inv, row0, sq, col0, d, t);
}

// Writes the natural-log row logsumexp ln2 * (m + log2(l)) of rows g and g+8
// (`m`/`l` in the base-2 domain of online_softmax) to `lse`, the (Sq,) fp32
// row of this (batch, head). One thread of each quad writes; rows at or past
// sq are not written.
__device__ __forceinline__ void store_lse(float* lse, const float (&m)[2], const float (&l)[2],
                                          int row0, int sq, int t) {
  if (t != 0) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < sq) lse[row] = kLn2 * (m[r] + log2f(fmaxf(l[r], 1e-30f)));
  }
}

// An accumulator tile leaves through shared memory: rows g and g+8 of the
// fp32 tiles, times `mul`, into a row-major tile of T (bf16 or float) with
// row stride ld (DP + 8: conflict-free for these writes) by stage_out, then
// copy_rows_out stores it in 16-byte pieces along the rows (a thread's
// scattered 4-byte stores, d / 4 a row pair, held the issue for
// thousands of cycles).
template <typename T, int NT>
__device__ __forceinline__ void stage_out(T* s, int ld, const float (&acc)[NT][4], float mul,
                                           int row0, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      T* p = s + (row0 + 8 * r) * ld + n * 8 + 2 * t;
      if constexpr (sizeof(T) == 2) {
        *reinterpret_cast<uint32_t*>(p) = pack_bf16(acc[n][2 * r] * mul, acc[n][2 * r + 1] * mul);
      } else {
        *reinterpret_cast<float2*>(p) = make_float2(acc[n][2 * r] * mul, acc[n][2 * r + 1] * mul);
      }
    }
  }
}

// Rows [0, rows) of a staged tile (row stride ld), columns [0, d), to
// out + r * row_stride, for rows below `valid`; thread `tid` of `nthreads`.
template <typename T>
__device__ __forceinline__ void copy_rows_out(T* out, size_t row_stride, const T* s, int ld,
                                              int rows, int valid, int d, int tid, int nthreads) {
  constexpr int E = 16 / sizeof(T);  // elements a 16-byte piece
  const int pieces = d / E;
  for (int idx = tid; idx < rows * pieces; idx += nthreads) {
    const int r = idx / pieces;
    const int c = (idx - r * pieces) * E;
    if (r < valid) {
      *reinterpret_cast<uint4*>(out + (size_t)r * row_stride + c) =
          *reinterpret_cast<const uint4*>(s + r * ld + c);
    }
  }
}

// Launches `kernel` with programmatic stream serialization: it may start
// while the kernel before it on `stream` runs, and must call griddep_wait
// (hopper.cuh) before it reads anything that kernel writes. Only for a
// kernel whose predecessor is its own launcher's (B3's and B4's passes).
template <typename... Exp, typename... Act>
cudaError_t launch_after(void (*kernel)(Exp...), dim3 grid, dim3 block, size_t smem,
                         cudaStream_t stream, Act&&... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Act&&>(args)...);
}

// How a block's loop of `nt` tiles is cut when the grid has `blocks`
// blocks: `tiles` a split, `splits` blocks a loop, so that the grid is
// about one block an SM of the current device (one split where it is that
// already). B3 splits its key tiles, B4 its query tiles; each split writes
// fp32 partial sums that a second pass adds in split order.
struct SplitPlan {
  int tiles;
  int splits;
};

inline SplitPlan split_plan(long long blocks, int nt) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long spread = (nt * blocks + sms - 1) / sms;
  const int tiles = spread > 1 ? (int)spread : 1;
  return {tiles, (nt + tiles - 1) / tiles};
}

}  // namespace icd
