// Kernel Q1: int8 implicit GEMM with a fused dequantising epilogue, sm_90a.
//
//   out[m, n] = cast_out( float(sum_k A[m, k] * B[n, k]) * (s_row[m] * s_col[n]) )
//
// A is gathered from an NHWC int8 activation (B, H, W, C) by implicit-GEMM
// addressing: m = (b, oh, ow), k = (kh, kw, c) in that order, stride and
// zero padding per axis; B is the int8 weight [N][kh * kw * C], K-contiguous.
// A dense layer is the case H = W = kh = kw = 1, C = its input features.
// s_row is one scale per row (dense: per token) or one broadcast scalar
// (conv: per tensor); s_col one per output feature. The int32 accumulator is
// exact; the epilogue multiplies the two scales first, then the accumulator,
// in fp32 (the JAX package's `acc.astype(f32) * (sl * sr)`), and rounds to
// the output type (fp32, or bf16 to nearest even). The output is [M][N]
// row-major, i.e. NHWC. `icd_int8_gemm_acc` skips the epilogue and writes
// the int32 accumulators.
//
// Replaces no TPU kernel: the JAX package computes these products with XLA's
// int8 `dot_general` / `conv_general_dilated` at int32 (ops/quant.py), and
// PyTorch has no int8 convolution on CUDA. Bound: int8 tensor-core operations
// (1979 TOP/s dense) for the UNet's and the VAE's wide layers, bytes for the
// M = batch dense layers and the C = 3/4, N = 3/4 convolutions.
//
// Design (simple and right first): 128 x 128 output tiles, 8 warps as
// 2 (M) x 4 (N), each warp 64 x 32 of `mma.sync.m16n8k32.s8.s8.s32`; K in
// steps of 64 bytes through a double-buffered shared-memory ring filled from
// registers (the next step's global loads are in flight during this step's
// products). Rows are padded to 80 bytes, so the fragment loads are free of
// bank conflicts. 16-byte vector gathers where C % 16 == 0 (every UNet and
// VAE layer but the C = 3/4/8 ones; then a 16-byte run of k lies in one
// kernel tap) and byte gathers otherwise; the K, M and N tails are zero-filled
// in the addressing. All element offsets are 64-bit. wgmma on s8, TMA and a
// fused quantising prologue are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;
constexpr int LDS = BK + 16;  // bytes per shared row
constexpr int THREADS = 256;

struct Params {
  const int8_t* a;
  const int8_t* b;
  const float* s_row;
  const float* s_col;
  void* out;
  int h, w, c, n, kh, kw, sh, sw, ph, pw, ho, wo;
  int64_t m;  // batch * ho * wo
  int k;      // kh * kw * c
  int row_scale_stride;  // 0: one scale; 1: one per row
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

union Vec16 {
  int4 v;
  int8_t b[16];
};

// OUT: 0 int32 accumulators, 1 fp32, 2 bf16
template <int OUT>
__global__ void __launch_bounds__(THREADS) int8_gemm_kernel(const Params p) {
  __shared__ __align__(16) int8_t sa[2][BM * LDS];
  __shared__ __align__(16) int8_t sb[2][BN * LDS];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // loader: row `lr` of both tiles, bytes [lh * 32, lh * 32 + 32) of each K step
  const int lr = tid >> 1, lh = tid & 1;
  const int64_t am = m0 + lr;
  const bool a_row = am < p.m;
  int ih0 = 0, iw0 = 0;
  int64_t a_img = 0;
  if (a_row) {
    int64_t t = am;
    const int ow = (int)(t % p.wo);
    t /= p.wo;
    const int oh = (int)(t % p.ho);
    t /= p.ho;
    a_img = t * p.h * p.w * p.c;
    ih0 = oh * p.sh - p.ph;
    iw0 = ow * p.sw - p.pw;
  }
  const int bn = n0 + lr;
  const bool b_row = bn < p.n;
  const int8_t* brow = p.b + (int64_t)bn * p.k;
  const bool a_vec = (p.c % 16) == 0;
  const bool b_vec = (p.k % 16) == 0;

  auto a_byte = [&](int k) -> int8_t {
    const int tap = k / p.c, cc = k - tap * p.c;
    const int ky = tap / p.kw, kx = tap - ky * p.kw;
    const int ih = ih0 + ky, iw = iw0 + kx;
    if (ih < 0 || ih >= p.h || iw < 0 || iw >= p.w) return 0;
    return p.a[a_img + ((int64_t)ih * p.w + iw) * p.c + cc];
  };

  auto load = [&](int k0, int4 (&ra)[2], int4 (&rb)[2]) {
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int k = k0 + lh * 32 + v * 16;
      Vec16 x;
      x.v = make_int4(0, 0, 0, 0);
      if (a_row && k < p.k) {
        if (a_vec) {  // k .. k + 15 lie in one tap, contiguous in memory
          const int tap = k / p.c, cc = k - tap * p.c;
          const int ky = tap / p.kw, kx = tap - ky * p.kw;
          const int ih = ih0 + ky, iw = iw0 + kx;
          if (ih >= 0 && ih < p.h && iw >= 0 && iw < p.w)
            x.v = *reinterpret_cast<const int4*>(p.a + a_img + ((int64_t)ih * p.w + iw) * p.c + cc);
        } else {
#pragma unroll
          for (int j = 0; j < 16; ++j)
            if (k + j < p.k) x.b[j] = a_byte(k + j);
        }
      }
      ra[v] = x.v;
      Vec16 y;
      y.v = make_int4(0, 0, 0, 0);
      if (b_row && k < p.k) {
        if (b_vec) {
          y.v = *reinterpret_cast<const int4*>(brow + k);
        } else {
#pragma unroll
          for (int j = 0; j < 16; ++j)
            if (k + j < p.k) y.b[j] = brow[k + j];
        }
      }
      rb[v] = y.v;
    }
  };

  auto store = [&](int buf, const int4 (&ra)[2], const int4 (&rb)[2]) {
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      *reinterpret_cast<int4*>(&sa[buf][lr * LDS + lh * 32 + v * 16]) = ra[v];
      *reinterpret_cast<int4*>(&sb[buf][lr * LDS + lh * 32 + v * 16]) = rb[v];
    }
  };

  const int warp_m = warp >> 2, warp_n = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  int4 ra[2], rb[2];
  load(0, ra, rb);
  store(0, ra, rb);
  __syncthreads();
  const int nk = (p.k + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load((kt + 1) * BK, ra, rb);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* base = &sa[buf][(warp_m * 64 + mi * 16 + g) * LDS + kk + t4 * 4];
        af[mi][0] = *reinterpret_cast<const uint32_t*>(base);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(base + 8 * LDS);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(base + 8 * LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* base = &sb[buf][(warp_n * 32 + ni * 8 + g) * LDS + kk + t4 * 4];
        bf[ni][0] = *reinterpret_cast<const uint32_t*>(base);
        bf[ni][1] = *reinterpret_cast<const uint32_t*>(base + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
    if (kt + 1 < nk) store(buf ^ 1, ra, rb);
    __syncthreads();
  }

  // epilogue: c0, c1 at (row g, cols 2 t4, 2 t4 + 1); c2, c3 at row g + 8
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t row = m0 + warp_m * 64 + mi * 16 + g + half * 8;
      if (row >= p.m) continue;
      float sr = 0.f;
      if (OUT != 0) sr = p.s_row[row * p.row_scale_stride];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = n0 + warp_n * 32 + ni * 8 + t4 * 2 + j;
          if (col >= p.n) continue;
          const int v = acc[mi][ni][half * 2 + j];
          const int64_t idx = row * p.n + col;
          if (OUT == 0) {
            static_cast<int*>(p.out)[idx] = v;
          } else {
            const float y = __fmul_rn(__int2float_rn(v), __fmul_rn(sr, p.s_col[col]));
            if (OUT == 1)
              static_cast<float*>(p.out)[idx] = y;
            else
              static_cast<__nv_bfloat16*>(p.out)[idx] = __float2bfloat16_rn(y);
          }
        }
      }
    }
  }
}

int launch(int out_kind, const void* a, const void* b, const void* s_row, const void* s_col, void* out,
           int batch, int h, int w, int c, int n, int kh, int kw, int sh, int sw, int ph, int pw,
           int row_scale_stride, cudaStream_t stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || c <= 0 || n <= 0 || kh <= 0 || kw <= 0 || sh <= 0 || sw <= 0 ||
      ph < 0 || pw < 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.a = static_cast<const int8_t*>(a);
  p.b = static_cast<const int8_t*>(b);
  p.s_row = static_cast<const float*>(s_row);
  p.s_col = static_cast<const float*>(s_col);
  p.out = out;
  p.h = h;
  p.w = w;
  p.c = c;
  p.n = n;
  p.kh = kh;
  p.kw = kw;
  p.sh = sh;
  p.sw = sw;
  p.ph = ph;
  p.pw = pw;
  p.ho = (h + 2 * ph - kh) / sh + 1;
  p.wo = (w + 2 * pw - kw) / sw + 1;
  if (p.ho <= 0 || p.wo <= 0) return (int)cudaErrorInvalidValue;
  p.m = (int64_t)batch * p.ho * p.wo;
  const int64_t k = (int64_t)kh * kw * c;
  if (k >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  p.k = (int)k;
  p.row_scale_stride = row_scale_stride;
  const int64_t mt = (p.m + BM - 1) / BM;
  const int64_t nt = (n + BN - 1) / BN;
  if (mt >= (1LL << 31) || nt > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)mt, (unsigned)nt);
  if (out_kind == 0)
    int8_gemm_kernel<0><<<grid, THREADS, 0, stream>>>(p);
  else if (out_kind == 1)
    int8_gemm_kernel<1><<<grid, THREADS, 0, stream>>>(p);
  else if (out_kind == 2)
    int8_gemm_kernel<2><<<grid, THREADS, 0, stream>>>(p);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// out_kind: 1 fp32, 2 bf16. row_scale_stride: 0 (one s_row scale) or 1.
extern "C" int icd_int8_gemm(const void* a, const void* b, const void* s_row, const void* s_col, void* out,
                             int batch, int h, int w, int c, int n, int kh, int kw, int sh, int sw, int ph,
                             int pw, int row_scale_stride, int out_kind, cudaStream_t stream) {
  if (out_kind != 1 && out_kind != 2) return (int)cudaErrorInvalidValue;
  if (row_scale_stride != 0 && row_scale_stride != 1) return (int)cudaErrorInvalidValue;
  return launch(out_kind, a, b, s_row, s_col, out, batch, h, w, c, n, kh, kw, sh, sw, ph, pw, row_scale_stride,
                stream);
}

extern "C" int icd_int8_gemm_acc(const void* a, const void* b, void* out, int batch, int h, int w, int c, int n,
                                 int kh, int kw, int sh, int sw, int ph, int pw, cudaStream_t stream) {
  return launch(0, a, b, nullptr, nullptr, out, batch, h, w, c, n, kh, kw, sh, sw, ph, pw, 0, stream);
}
