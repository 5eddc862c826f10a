// Kernel B4: flash-attention backward, the key and value gradients, head
// dims <= 256.
//
// Replaces `_dkdv_kernel` in invertible_cd_tpu/ops/flash_attention.py
// (launched by `_flash_backward`, the backward of `_flash_op`), at the shapes
// of B1 and B3.
//
// Per 64 keys of one (batch, head), looping over 64-query tiles:
//   S^T  = K Q^T                P^T  = exp(scale * S^T - lse[query])
//   dP^T = V dO^T               dS^T = P^T * (dP^T - delta[query])
//   dV   = sum over tiles of P^T dO
//   dK   = scale * sum over tiles of dS^T Q
//
// What bounds it on an H100: operations, four products of 2*Sq*Sk*d each
// (8*Sq*Sk*d per head against 6 for B3), far above the card's ~295 operations
// per byte at the 4096- and 1024-token shapes.
//
// Design. A block owns its 64 keys and loops over all query tiles itself, so
// every dK/dV row has one writer: no atomics, and the result is the same bit
// for bit from run to run, as on the TPU, where the key tile was a grid
// step. Each of the 4 warps owns 16 keys. The tile is computed transposed
// (keys as rows): then P^T and dS^T come out of mma.sync.m16n8k16 in the
// accumulator layout that is already the A operand of the next product (what
// `probs_as_a` does forward), and dO and Q, staged row-major, are read as
// that product's B operand with ldmatrix.trans; no tile is stored twice.
// delta = rowsum(dO * O) is computed here per query tile from the staged dO
// and O tiles (two threads per row), as the TPU kernel does; nothing is
// handed over from B3.
// Registers: the two fp32 accumulators are 2 x 16 x DP per warp, DP per
// thread (160 at the widest main-path width), so at DP > 80 the 64-query
// tile is worked through in two 32-query halves, which halves the S^T and
// dP^T registers; nvcc's spill report is printed with the build.
// Query rows at or past Sq get P = 0 (their lse was never written, so it is
// not read) and zero Q/dO/O rows; keys at or past Sk have zero K/V rows,
// P = 0, and their dK/dV rows are never stored. The head dim is a
// compile-time width (48/80/160/256) padded with zeros in shared memory; the
// scale is the true 1/sqrt(d).
#include "flash_common.cuh"

namespace icd {

constexpr int kB4Keys = 64;  // keys per block
constexpr int kB4Rows = 64;  // query rows per tile

template <int DP>
constexpr size_t b4_smem_bytes() {
  return sizeof(bf16) * (size_t)(2 * kB4Keys + 3 * kB4Rows) * (DP + 8) +
         sizeof(float) * 2 * kB4Rows;
}

// QCH: queries worked through at a time (a divisor of kB4Rows, multiple of 16)
template <int DP, int QCH>
__global__ void __launch_bounds__(128)
flash_bwd_dkdv_b4(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ o,
                  const bf16* __restrict__ dout, const float* __restrict__ lse,
                  bf16* __restrict__ dk, bf16* __restrict__ dv, int heads, int sq, int sk,
                  int d, float scale, float scale_log2) {
  static_assert(DP % 16 == 0 && kB4Rows % QCH == 0 && QCH % 16 == 0, "tile shapes");
  constexpr int LDI = DP + 8;  // row stride of every tile (elements)
  constexpr int NQ = QCH / 8;  // 8-query tiles of S^T and dP^T per warp
  constexpr int NO = DP / 8;   // 8-column tiles of the dK and dV accumulators

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kB4Keys * LDI;
  bf16* sQ = sV + kB4Keys * LDI;
  bf16* sdO = sQ + kB4Rows * LDI;
  bf16* sO = sdO + kB4Rows * LDI;
  float* sLse = reinterpret_cast<float*>(sO + kB4Rows * LDI);  // base-2 domain
  float* sDelta = sLse + kB4Rows;

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y - b * heads;
  const int k0 = blockIdx.x * kB4Keys;
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

  load_rows(sK, LDI, k + koff, rs, kB4Keys, sk - k0, d, DP);
  load_rows(sV, LDI, v + koff, rs, kB4Keys, sk - k0, d, DP);

  float dkacc[NO][4];
  float dvacc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    dkacc[n][0] = dkacc[n][1] = dkacc[n][2] = dkacc[n][3] = 0.f;
    dvacc[n][0] = dvacc[n][1] = dvacc[n][2] = dvacc[n][3] = 0.f;
  }

  for (int q0 = 0; q0 < sq; q0 += kB4Rows) {
    __syncthreads();  // the previous query tile is consumed
    const size_t qoff = qbase + (size_t)q0 * rs;
    load_rows(sQ, LDI, q + qoff, rs, kB4Rows, sq - q0, d, DP);
    load_rows(sdO, LDI, dout + qoff, rs, kB4Rows, sq - q0, d, DP);
    load_rows(sO, LDI, o + qoff, rs, kB4Rows, sq - q0, d, DP);
    if (threadIdx.x < kB4Rows) {
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

    for (int qc = 0; qc < kB4Rows && q0 + qc < sq; qc += QCH) {
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

template <int DP, int QCH>
int launch_b4(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const void* lse, void* dk, void* dv, int batch, int heads, int sq, int sk, int d,
              float scale, void* stream) {
  const size_t smem = b4_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_b4<DP, QCH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sk + kB4Keys - 1) / kB4Keys, batch * heads);
  flash_bwd_dkdv_b4<DP, QCH><<<grid, 128, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<bf16*>(dk), static_cast<bf16*>(dv), heads,
      sq, sk, d, scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace icd

extern "C" int icd_flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* o,
                                  const void* dout, const void* lse, void* dk, void* dv,
                                  int batch, int heads, int sq, int sk, int d, float scale,
                                  void* stream) {
  using namespace icd;
#define ICD_B4_CASE(DP, QCH)                                                                  \
  if (d <= DP)                                                                                \
    return launch_b4<DP, QCH>(q, k, v, o, dout, lse, dk, dv, batch, heads, sq, sk, d, scale, \
                              stream);
  ICD_B4_CASE(48, 64)
  ICD_B4_CASE(80, 64)
  ICD_B4_CASE(160, 32)
  ICD_B4_CASE(256, 32)
#undef ICD_B4_CASE
  return (int)cudaErrorInvalidValue;
}
