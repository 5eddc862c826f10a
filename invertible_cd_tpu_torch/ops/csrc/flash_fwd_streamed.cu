// Kernel B2: flash-attention forward for large head dims (256 < d <= 512).
//
// Replaces `_fwd_kernel_streamed` in invertible_cd_tpu/ops/flash_attention.py
// (launched by `_flash_forward_streamed` through `_flash_op_streamed`): the
// SD1.5 VAE mid-block's single d = 512 head over 4096 tokens. On the TPU the
// key axis was a sequential grid dimension with m, l and acc persisting in
// VMEM scratch; here one block loops over the key tiles itself, since
// Hopper blocks run in no order and share nothing between them.
//
// What bounds it on an H100: operations. One image does 4*4096^2*512 =
// 34 GFLOP on 17 MB of Q/K/V/O, about 2000 operations per byte.
//
// The design problem is the accumulator: 16 query rows x 512 fp32 columns
// is 256 registers per thread of a warp, past the 255 limit, and a 64-row
// tile (128 KB) does not fit shared memory beside Q, K and V either.
// Chosen: split the 512 columns over the 4 warps of a row group, 128 each,
// so every warp keeps a 16 x 128 fp32 accumulator in registers (64 per
// thread). The logits need all 512 columns, so each of the 4 warps
// computes a partial Q K^T over its 128 columns and the row group adds the
// 4 partials through shared memory (in a fixed order, so all 4 warps hold
// bit-identical logits, softmax state and probabilities); each warp then
// multiplies the probabilities by its 128 columns of V. Splitting d across
// blocks instead was rejected: each block would recompute the full
// 4096 x 4096 logits.
// Tiles: 64 query rows (4 row groups x 4 column warps = 16 warps) and 32
// keys; shared memory holds Q (66 KB), K (33 KB), V transposed (41 KB) and
// the partial logits (32 KB): 170 KB, one block per SM. Products are
// mma.sync.m16n8k16 in bf16 with fp32 accumulation; the softmax state is
// fp32, as in B1 (flash_common.cuh). The second entry point also writes the
// row logsumexp for the backward (which is plain PyTorch, as the reference's
// `_streamed_backward_xla` is plain XLA).
#include "flash_common.cuh"

namespace icd {

constexpr int kB2Dp = 512;              // compile-time head width
constexpr int kB2Splits = 4;            // column warps per row group
constexpr int kB2Groups = 4;            // row groups of 16 rows
constexpr int kB2Rows = 16 * kB2Groups; // query rows per block
constexpr int kB2Keys = 32;             // keys per tile
constexpr int kB2Warps = kB2Splits * kB2Groups;
constexpr int kB2Cols = kB2Dp / kB2Splits;  // accumulator columns per warp

constexpr size_t b2_smem_bytes() {
  return sizeof(bf16) * ((size_t)(kB2Rows + kB2Keys) * (kB2Dp + 8) + (size_t)kB2Dp * (kB2Keys + 8))
         + sizeof(float) * (size_t)kB2Warps * 16 * 32;
}

__global__ void __launch_bounds__(kB2Warps * 32, 1)
flash_fwd_b2(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
             int heads, int sq, int sk, int d, float scale_log2) {
  constexpr int LDI = kB2Dp + 8;
  constexpr int LDT = kB2Keys + 8;
  constexpr int NS = kB2Keys / 8;   // 8-key logit tiles
  constexpr int NO = kB2Cols / 8;   // 8-column accumulator tiles per warp

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kB2Rows * LDI;
  bf16* sVt = sK + kB2Keys * LDI;
  float* sS = reinterpret_cast<float*>(sVt + kB2Dp * LDT);  // [warp][16 values][32 lanes]

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y - b * heads;
  const int q0 = blockIdx.x * kB2Rows;
  const size_t rs = (size_t)heads * d;
  const bf16* kb = k + (size_t)b * sk * rs + (size_t)h * d;
  const bf16* vb = v + (size_t)b * sk * rs + (size_t)h * d;
  bf16* ob = o + (size_t)b * sq * rs + (size_t)h * d;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int group = warp / kB2Splits;
  const int c0 = (warp % kB2Splits) * kB2Cols;  // this warp's first column
  const bf16* qw = sQ + group * 16 * LDI;

  load_rows(sQ, LDI, q + ((size_t)b * sq + q0) * rs + (size_t)h * d, rs, kB2Rows, sq - q0, d, kB2Dp);

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < sk; k0 += kB2Keys) {
    __syncthreads();  // the previous tile and its partial logits are consumed
    load_rows(sK, LDI, kb + (size_t)k0 * rs, rs, kB2Keys, sk - k0, d, kB2Dp);
    load_rows_transposed(sVt, LDT, vb + (size_t)k0 * rs, rs, kB2Keys, sk - k0, d, kB2Dp);
    __syncthreads();

    // partial logits over this warp's 128 columns
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kB2Cols; kk += 16) {
      uint32_t a[4];
      load_a(a, qw, LDI, c0 + kk, g, t);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const bf16* kp = sK + (n * 8 + g) * LDI + c0 + kk + 2 * t;
        mma_16816(s[n], a, ld32(kp), ld32(kp + 8));
      }
    }
    float* mine = sS + warp * 16 * 32;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[(n * 4 + e) * 32 + lane] = s[n][e];
    // the 4 warps of this row group meet on barrier 1 + group
    asm volatile("bar.sync %0, %1;" ::"r"(1 + group), "r"(kB2Splits * 32) : "memory");
    const float* part = sS + group * kB2Splits * 16 * 32;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = 0.f;
#pragma unroll
        for (int j = 0; j < kB2Splits; ++j) x += part[(j * 16 + n * 4 + e) * 32 + lane];
        s[n][e] = x;
      }

    float alpha[2];
    online_softmax<NS>(s, m, l, alpha, scale_log2, k0, sk, t);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

#pragma unroll
    for (int kk = 0; kk < kB2Keys / 16; ++kk) {
      uint32_t a[4];
      probs_as_a<NS>(a, s, kk);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const bf16* vp = sVt + (c0 + n * 8 + g) * LDT + kk * 16 + 2 * t;
        mma_16816(acc[n], a, ld32(vp), ld32(vp + 8));
      }
    }
  }

  store_rows<NO>(ob, rs, acc, l, q0 + group * 16 + g, sq, c0, d, t);
  // the 4 column warps of a row group hold identical m and l: the first writes
  if (lse != nullptr && c0 == 0)
    store_lse(lse + (size_t)blockIdx.y * sq, m, l, q0 + group * 16 + g, sq, t);
}

int launch_b2(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
              int heads, int sq, int sk, int d, float scale, void* stream) {
  if (d > kB2Dp) return (int)cudaErrorInvalidValue;
  const size_t smem = b2_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_b2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + kB2Rows - 1) / kB2Rows, batch * heads);
  flash_fwd_b2<<<grid, kB2Warps * 32, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), heads, sq, sk, d, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace icd

extern "C" int icd_flash_fwd_streamed(const void* q, const void* k, const void* v,
                                      void* o, int batch, int heads, int sq, int sk,
                                      int d, float scale, void* stream) {
  return icd::launch_b2(q, k, v, o, nullptr, batch, heads, sq, sk, d, scale, stream);
}

// The same kernel, also writing lse (B, H, Sq) fp32.
extern "C" int icd_flash_fwd_streamed_lse(const void* q, const void* k, const void* v,
                                          void* o, void* lse, int batch, int heads, int sq,
                                          int sk, int d, float scale, void* stream) {
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  return icd::launch_b2(q, k, v, o, lse, batch, heads, sq, sk, d, scale, stream);
}
