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
// so the codes and scales equal the plain version's bit for bit. Forms:
//   * icd_quantize_rows: x (rows, K) in bf16 or fp32 -> codes (rows, Kp) and
//     one scale a row (a dense layer's per-token scales). One warp a row,
//     which reads its row twice (amax, then the codes; the second read hits
//     L1), 16 codes a lane a store. icd_quantize_rows_amax: the same with
//     each row's amax read from the device (the whole row's, where the
//     row's features are split over tensor-parallel ranks), one read a row.
//   * icd_quantize_tensor: x (B, C, H, W), NCHW or channels-last in memory ->
//     codes (B, H, W, Cp), NHWC, and one scale (a convolution's per-tensor
//     scale). Dynamic: pass 1 writes one partial amax a block to the
//     workspace, pass 2 reduces them in every block, then quantises and
//     writes NHWC directly: NCHW input through a 64 x 64 shared-memory
//     transpose, channels-last input straight. Static: pass 2 alone, with
//     the amax read from its device pointer (no host sync).
// Kp and Cp are K and C rounded up to a multiple of 16 with zero codes, so
// every gather of Q1 is one 16-byte vector (C = 3, 4 and 8 become 16).
//
// Replaces no TPU kernel: the JAX package's quantisers are XLA element-wise
// and reduction ops (invertible_cd_tpu/ops/quant.py:176-209), which XLA fuses
// into the product's program. Bound: bytes (x read once, codes and scales
// written once); eager PyTorch spent about a dozen launches on fp32
// temporaries for the same pass, plus two permute copies to NHWC.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_PARTIALS = 1024;  // the workspace: one fp32 partial amax a pass-1 block
constexpr int PASS2_BLOCKS = 1056;  // 8 blocks of the grid-stride pass 2 an SM

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ int8_t code(float x, float r) {
  const float q = rintf(__fmul_rn(x, r));  // half to even, as torch.round
  return static_cast<int8_t>(fminf(fmaxf(q, -127.f), 127.f));
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

// pass 1 (dynamic): partial[blockIdx.x] = max |x| over a grid-stride share
template <typename T>
__global__ void __launch_bounds__(THREADS) amax_partial(const T* __restrict__ x, int64_t n, bool vec,
                                                        float* __restrict__ partial) {
  __shared__ float red[THREADS / 32];
  float amax = 0.f;
  constexpr int PER = 16 / sizeof(T);
  if (vec) {  // n % PER == 0 and x 16-byte aligned
    const int64_t nv = n / PER;
    for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < nv; i += (int64_t)gridDim.x * THREADS) {
      const int4 raw = reinterpret_cast<const int4*>(x)[i];
      const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < PER; ++e) amax = fmaxf(amax, fabsf(to_float(t[e])));
    }
  } else {
    for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < n; i += (int64_t)gridDim.x * THREADS)
      amax = fmaxf(amax, fabsf(to_float(x[i])));
  }
  amax = block_max(amax, red);
  if (threadIdx.x == 0) partial[blockIdx.x] = amax;
}

// the tensor's amax in every block of pass 2: the calibrated one (floored at
// 1e-12), or the max of pass 1's partials (0 -> 1.0); block 0 writes the scale
__device__ __forceinline__ float tensor_amax(const float* partial, int n_partial, const float* amax_in,
                                             float* scale, float* red) {
  float amax;
  if (amax_in != nullptr) {
    amax = fmaxf(*amax_in, 1e-12f);
  } else {
    float v = 0.f;
    for (int i = threadIdx.x; i < n_partial; i += THREADS) v = fmaxf(v, partial[i]);
    amax = block_max(v, red);
    if (!(amax > 0.f)) amax = 1.f;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale = scale_of(amax);
  return amax;
}

// pass 2, NCHW input: 64 positions x 64 channels a tile, read along the
// positions, written along the channels (16-byte stores)
template <typename T>
__global__ void __launch_bounds__(THREADS) quantize_nchw(const T* __restrict__ x, int8_t* __restrict__ q,
                                                         float* __restrict__ scale,
                                                         const float* __restrict__ partial, int n_partial,
                                                         const float* __restrict__ amax_in, int batch, int c,
                                                         int hw, int cp) {
  __shared__ float red[THREADS / 32];
  __shared__ __align__(16) int8_t tile[64][80];
  const float r = reciprocal_of(tensor_amax(partial, n_partial, amax_in, scale, red));
  const int pos_tiles = (hw + 63) / 64, ch_tiles = (cp + 63) / 64;
  const int64_t tiles = (int64_t)batch * pos_tiles * ch_tiles;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int pt = (int)(t % pos_tiles);
    const int64_t rest = t / pos_tiles;
    const int ct = (int)(rest % ch_tiles);
    const int b = (int)(rest / ch_tiles);
    const int p0 = pt * 64, c0 = ct * 64;
    const T* xb = x + (int64_t)b * c * hw;
    for (int i = threadIdx.x; i < 64 * 64; i += THREADS) {
      const int cl = i >> 6, pl = i & 63;  // consecutive threads: consecutive positions of a channel
      const int ch = c0 + cl, pos = p0 + pl;
      tile[pl][cl] = (ch < c && pos < hw) ? code(to_float(xb[(int64_t)ch * hw + pos]), r) : (int8_t)0;
    }
    __syncthreads();
    const int pl = threadIdx.x >> 2, ck = (threadIdx.x & 3) * 16;
    const int pos = p0 + pl, ch = c0 + ck;
    if (pos < hw && ch < cp)
      *reinterpret_cast<int4*>(q + ((int64_t)b * hw + pos) * cp + ch) =
          *reinterpret_cast<const int4*>(&tile[pl][ck]);
    __syncthreads();
  }
}

// pass 2, channels-last input: one 16-channel chunk of one pixel a thread
template <typename T>
__global__ void __launch_bounds__(THREADS) quantize_nhwc(const T* __restrict__ x, int8_t* __restrict__ q,
                                                         float* __restrict__ scale,
                                                         const float* __restrict__ partial, int n_partial,
                                                         const float* __restrict__ amax_in, int64_t pixels,
                                                         int c, int cp, bool vec) {
  __shared__ float red[THREADS / 32];
  const float r = reciprocal_of(tensor_amax(partial, n_partial, amax_in, scale, red));
  const int chunks = cp / 16;
  const int64_t n = pixels * chunks;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < n; i += (int64_t)gridDim.x * THREADS) {
    const int64_t pix = i / chunks;
    const int ck = (int)(i - pix * chunks) * 16;
    float v[16];
    load16(x + pix * c, ck, c, vec, v);
    alignas(16) int8_t out[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) out[e] = code(v[e], r);
    *reinterpret_cast<int4*>(q + pix * cp + ck) = *reinterpret_cast<const int4*>(out);
  }
}

inline int blocks_for(int64_t work, int per_block, int cap) {
  const int64_t b = (work + per_block - 1) / per_block;
  return (int)(b < 1 ? 1 : (b > cap ? cap : b));
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

template <typename T>
int tensor_launch(const void* xv, int channels_last, void* qv, void* scalev, const void* amax,
                  void* workspace, int batch, int c, int h, int w, int cp, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  int8_t* q = static_cast<int8_t*>(qv);
  float* scale = static_cast<float*>(scalev);
  float* partial = static_cast<float*>(workspace);
  const int64_t hw = (int64_t)h * w;
  const int64_t n = (int64_t)batch * c * hw;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  int n_partial = 0;
  if (amax == nullptr) {
    n_partial = blocks_for(n, THREADS * 16, MAX_PARTIALS);
    amax_partial<T><<<n_partial, THREADS, 0, stream>>>(x, n, aligned && n % (16 / sizeof(T)) == 0, partial);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const float* amax_in = static_cast<const float*>(amax);
  if (channels_last) {
    const int64_t chunks = (int64_t)batch * hw * (cp / 16);
    quantize_nhwc<T><<<blocks_for(chunks, THREADS, PASS2_BLOCKS), THREADS, 0, stream>>>(
        x, q, scale, partial, n_partial, amax_in, (int64_t)batch * hw, c, cp,
        aligned && c % (16 / sizeof(T)) == 0);
  } else {
    if (hw >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    const int64_t tiles = (int64_t)batch * ((hw + 63) / 64) * ((cp + 63) / 64);
    quantize_nchw<T><<<blocks_for(tiles, 1, PASS2_BLOCKS), THREADS, 0, stream>>>(
        x, q, scale, partial, n_partial, amax_in, batch, c, (int)hw, cp);
  }
  return (int)cudaGetLastError();
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
// on the device) or null for a dynamic amax; `workspace`: 1024 fp32 (pass 1's
// partials; unused when `amax` is given). Dynamic: two launches, static: one.
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

extern "C" int icd_quantize_workspace_floats() { return MAX_PARTIALS; }
