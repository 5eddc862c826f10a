// Kernel B2 on fp32 input: flash-attention forward for large head dims
// (256 < d <= 512), fp32 Q, K, V and O.
//
// Replaces `_fwd_kernel_streamed` in invertible_cd_tpu/ops/flash_attention.py
// on the inputs the JAX package gives it in fp32 (its docstring: "fp32
// inputs (SDXL's fp32 VAE at 16k tokens)"): SDXL's VAE runs in fp32 by
// default, and its mid-block attends with one d = 512 head over 128^2 =
// 16384 tokens, in the encoder at batch 1 and the decoder at batch 1 and 2.
// The JAX kernel's products there are fp32-input products with fp32
// accumulation; this kernel's are TF32 tensor-core products
// (mma.sync.m16n8k8 .tf32, operands rounded to nearest by cvt.rna) with fp32
// accumulation, and fp32 everywhere else: the softmax (exp2f, not the MUFU
// approximation), the running max and sums, the output. The bf16 build of
// B2 (flash_fwd_streamed.cu, SDXL's `vae_dtype=bf16` opt-in and SD1.5's VAE)
// is a separate source, so its code and numbers stay as they are.
//
// What bounds it on an H100 SXM (700 W): operations. One image at 16384
// tokens does 4 * 16384^2 * 512 = 5.50e11 FLOP: 1.11 ms at TF32's 494.7
// TFLOP/s dense (8.2 ms at FFMA's 66.9); its 2.7e8 exponentials take
// 0.07 ms; Q, K, V and O are 134 MB, 0.04 ms at 3.35 TB/s.
//
// Design, a simple kernel first (the bf16 build's TMA ring, clusters and
// wgmma are later work here):
//   * shared memory sets the shape. At d = 512 a 64-row fp32 tile is 128 KB,
//     so Q and a 64-key K tile alone overflow the 227 KB a block may hold.
//     One block is 64 query rows of one (batch, head), Q resident (130 KB
//     with its row padding), with single 16-key tiles of K and V (33 KB
//     each): 203 KB, one block an SM, 256 blocks at batch 1 (two waves on
//     132 SMs, so no split of the key range is needed);
//   * 8 warps: warp w owns query rows 16 (w % 4) .. +15 and head-dim half
//     w / 4. Its 16 x 256 fp32 output columns are 128 accumulator registers
//     a thread, as in the bf16 build; its logits are the partial S = Q K^T
//     over its 256 columns of the head dim, and the two partials of a pair
//     of warps meet through 8 KB of shared memory (IEEE addition commutes,
//     so both warps hold the same S, m, l and P);
//   * TF32 wgmma takes both operands K-major only, and V as stored ((S, 512)
//     row-major) is MN-major for P V; mma.sync takes its fragments from
//     registers, loaded by each thread from any layout, so V needs no
//     transposed copy. Fragments (PTX ISA, m16n8k8 .tf32): A a0 = (g, t),
//     a1 = (g+8, t), a2 = (g, t+4), a3 = (g+8, t+4); B b0 = (k=t, n=g),
//     b1 = (k=t+4, n=g); C as m16n8k16's (g = lane / 4, t = lane % 4). The
//     reduction index is relabelled, k = t <-> 2t and k = t+4 <-> 2t+1, in
//     both operands: Q and K fragments are then float2 loads, and the C
//     layout of S (columns 2t, 2t+1) is already P's A operand for P V;
//   * row strides padded against bank conflicts: Q and K by 8 floats (the
//     float2 loads of a half-warp, rows g and columns 2t, cover 32 banks), V
//     by 4 (the scalar loads of rows 2t and columns g cover 32 banks);
//   * K and V tiles are filled by cp.async in turn: the next K tile loads
//     under the softmax and P V of this one, the next V tile under the
//     logits of the next, so one buffer of each suffices;
//   * the logits accumulate in two sets (even and odd k-steps), so each warp
//     keeps four independent chains of products in flight.
// Rows past Sq are zero-filled and never stored; keys past Sk are
// zero-filled and get -1e30 logits. The second entry point also writes the
// fp32 row logsumexp (natural log, (B, H, Sq)), as the bf16 build's does.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace icd {

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

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
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

int launch_b2_f32(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
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

}  // namespace icd

extern "C" int icd_flash_fwd_streamed_f32(const void* q, const void* k, const void* v, void* o,
                                          int batch, int heads, int sq, int sk, int d,
                                          float scale, void* stream) {
  return icd::launch_b2_f32(q, k, v, o, nullptr, batch, heads, sq, sk, d, scale, stream);
}

// The same kernel, also writing lse (B, H, Sq) fp32.
extern "C" int icd_flash_fwd_streamed_f32_lse(const void* q, const void* k, const void* v,
                                              void* o, void* lse, int batch, int heads, int sq,
                                              int sk, int d, float scale, void* stream) {
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  return icd::launch_b2_f32(q, k, v, o, lse, batch, heads, sq, sk, d, scale, stream);
}
