// Kernel Q1: int8 implicit GEMM with a fused dequantising and bias epilogue, sm_90a.
//
//   out[m, n] = cast_out( float(sum_k A[m, k] * B[n, k]) * (s_row[m] * s_col[n]) ) (+ bias[n])
//
// A is gathered from an NHWC int8 activation (B, H, W, C) by implicit-GEMM
// addressing: m = (b, oh, ow), k = (kh, kw, c) in that order, stride and
// zero padding per axis; B is the int8 weight [N][kh * kw * C], K-contiguous
// (a Q-layer's cached weight codes). C is a multiple of 16 (kernel Q2 and the
// weight-code cache pad it with zero codes), so every 16-byte run of k lies
// in one kernel tap. A dense layer is the case H = W = kh = kw = 1. s_row is
// one scale a row (dense: per token) or one scalar on the device (conv: per
// tensor, written by Q2); s_col one a output feature. The int32 accumulator
// is exact; the epilogue multiplies the two scales first, then the
// accumulator, in fp32 (the JAX package's `acc.astype(f32) * (sl * sr)`),
// rounds to the output type (fp32, or bf16 to nearest even) and adds the
// bias the way the eager layer did: in the output type, i.e. for bf16
// bf16(float(bf16(y)) + float(bias)). The output is [M][N] row-major (NHWC).
// `icd_int8_gemm_acc` skips the epilogue and writes the int32 accumulators.
//
// Replaces no TPU kernel: the JAX package computes these products with XLA's
// int8 `dot_general` / `conv_general_dilated` at int32
// (invertible_cd_tpu/ops/quant.py:245-248, 327-333), and PyTorch has no int8
// convolution on CUDA. Bound: int8 tensor-core operations (1979 TOP/s dense)
// for the UNet's and the VAE's wide convolutions; bytes for the M = batch
// dense layers and the C or N = 3/4/8 convolutions.
//
// Design (Hopper): a block = 128 rows x BN columns at a time, three warpgroups.
//   * Warpgroups 0 and 1 are consumers: each owns 64 rows and issues
//     `wgmma.mma_async.m64nBNk32.s32.s8.s8` with both operands K-major in
//     shared memory in the 128-byte swizzle (descriptor layout type 1,
//     8-row groups 1024 bytes apart; a 32-byte k-step advances the start
//     address inside the swizzle row). BN follows N: 256 where N % 256 == 0
//     (the VAE's 256 and 512, the UNet's 1280), 160 where N % 160 == 0
//     (320 and 640 = 2 and 4 x 160), 32 for N <= 32, else 128 or 160.
//   * Warpgroup 2 is the producer (`setmaxnreg` lowers it to 40 registers,
//     the consumers rise to 232). Each K step of 128 bytes fills one stage
//     of a ring of 4-6 stages (as many as fit): thread 0 asks TMA for B's
//     [BN][128] box (a 2-D tensor map with the 128-byte swizzle; TMA
//     zero-fills the K and N tails) on the stage's `full` mbarrier; all 128
//     threads gather A's [128][128] by `cp.async.cg` 16-byte copies
//     (zero-fill for padding and the M and K tails) straight into the
//     swizzled layout. A thread's copies of step s are waited for stages - 2
//     steps later, fenced to the async proxy and arrived on step s's `full`
//     barrier, so a stage is complete when its 128 gathers and its TMA
//     bytes have landed. The consumers release a stage on its `empty`
//     barrier once the products that read it have retired (one wgmma group
//     stays in flight).
//   * Persistent: one block an SM walks over the tiles (the N tiles of one
//     row block next to each other, so they share A's rows in L2); the
//     producer runs on into the next tile while the consumers finish this
//     one, so a short-K tile's prologue and epilogue overlap the next
//     tile's loads.
//   * Epilogue: the tile's column scales and bias are staged in shared
//     memory while its products run (global loads there sat on the
//     epilogue's critical path). bf16 (every SD1.5 layer): each consumer
//     warp writes its 16 rows 32 columns at a time into one of two swizzled
//     staging buffers and hands them to a TMA store, which runs on while
//     the warp goes on and clips the M and N tails. fp32 (SDXL's VAE), the
//     int32 accumulators, N = 3/4 and a split's atomic sums: two
//     neighbouring columns a store from registers. The ring stays free for
//     the next tile.
//   * Few tiles (the UNet's 8^2 and 16^2 levels at batch 4, the M = batch
//     dense layers): the K steps are split over several tiles so the card
//     fills; the splits add their int32 sums atomically into a zeroed
//     workspace (integer sums are exact in any order, so the result is
//     deterministic), and a second pass applies the epilogue. All of it
//     counts as one launch.
// All element offsets into A are 32-bit (the wrapper keeps A below 2^31
// bytes and H, W below 2^14).
#include <cuda.h>  // CUtensorMap; cuTensorMapEncodeTiled itself is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using icd::smem_u32;

constexpr int BM = 128;            // rows a block: two consumer warpgroups of 64
constexpr int BK = 128;            // bytes of K a stage: one 128-byte swizzle row
// ring stages: as many as 227 KB of shared memory hold (A's 16 KB and B's
// BN x 128 bytes a stage)
template <int BN>
__host__ __device__ constexpr int stages() {
  return BN == 256 ? 4 : BN == 160 ? 5 : 6;
}

// the bf16 epilogue's staging: two buffers a consumer warp, each 16 rows x
// 32 columns of bf16 in the 64-byte swizzle its TMA store reads
constexpr int STG_BUF = 1024;
constexpr int STG_WARP = 2 * STG_BUF;
constexpr int THREADS = 384;       // warpgroups 0, 1: consumers; 2: producer
constexpr int CONSUMERS = 256;
constexpr int A_STAGE = BM * BK;   // 16 KB
constexpr int KIND_ATOMIC = 3;     // out_kind of a split: int32 sums added into `out`

struct Params {
  const int8_t* a;
  const float* s_row;
  const float* s_col;
  const void* bias;   // in the output type, or null
  void* out;
  int h, w, c, n, kw, sh, sw, ph, pw, ho, wo;
  int m;              // batch * ho * wo
  int k;              // kh * kw * c
  int nk;             // K steps in all
  int steps;          // K steps a split
  int bn, nt, splits, tiles;  // tile width, N tiles, K splits, tiles = M tiles x nt x splits
  int out_kind;       // 0 int32, 1 fp32, 2 bf16, 3 int32 added atomically
  int row_scale_stride;  // 0: one s_row scale; 1: one a row
  int tma_out;        // 1: the bf16 output by TMA stores (its rows are 16-byte aligned)
};

template <int BN>
constexpr int smem_bytes() {
  return stages<BN>() * (A_STAGE + BN * BK) + 8 * STG_WARP + 2 * stages<BN>() * 8 + 16 * BN +
         1024;  // + staging, + barriers, + two tiles' column scales and bias, + alignment
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

// the box at (c0, c1) of `map` from shared memory at `src`, in this
// thread's bulk async-group
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// descriptor of a K-major operand in the 128-byte swizzle: 8-row groups
// 1024 bytes apart (SBO), LBO unused (1), layout type 1
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// d (64 x 32, s32) += A (64 x 32 s8, shared, K-major) * B (32 x 32 s8, shared, K-major)^T
__device__ __forceinline__ void wgmma_s8(int (&d)[16], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 128, s32) += A (64 x 32 s8, shared, K-major) * B (128 x 32 s8, shared, K-major)^T
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 160, s32) += A (64 x 32 s8, shared, K-major) * B (160 x 32 s8, shared, K-major)^T
__device__ __forceinline__ void wgmma_s8(int (&d)[80], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, %80, %81, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 256, s32) += A (64 x 32 s8, shared, K-major) * B (256 x 32 s8, shared, K-major)^T
__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ float dequant(int v, float sr, float sc) {
  return __fmul_rn(__int2float_rn(v), __fmul_rn(sr, sc));
}

// one fp32 or bf16 output element at flat index idx (row-major [M][N]),
// column col, from its int32 sum (the split launches' epilogue pass)
__device__ __forceinline__ void store_one(const Params& p, int64_t idx, int col, int v, float sr) {
  if (p.out_kind == 1) {
    float y = dequant(v, sr, p.s_col[col]);
    if (p.bias != nullptr) y = __fadd_rn(y, static_cast<const float*>(p.bias)[col]);
    static_cast<float*>(p.out)[idx] = y;
  } else {
    __nv_bfloat16 y = __float2bfloat16_rn(dequant(v, sr, p.s_col[col]));
    if (p.bias != nullptr)
      y = __float2bfloat16_rn(
          __fadd_rn(__bfloat162float(y), __bfloat162float(static_cast<const __nv_bfloat16*>(p.bias)[col])));
    static_cast<__nv_bfloat16*>(p.out)[idx] = y;
  }
}

// one consumer warp's share of an output tile (rows row0 and row0 + 8 of
// each thread: the wgmma accumulator layout, columns cb + 8 jn and + 1);
// `cv` holds the tile's column scales and (after them) its bias as fp32.
// bf16 TMA path: 32 columns at a time into one of the warp's two staging
// buffers (swizzled, so the writes meet no bank conflict), then one TMA
// store of the 16 x 32 box, which clips the M and N tails; `chunk` counts
// the warp's stores, so a buffer is refilled only once the store before
// last has read it. Otherwise (fp32, the int32 accumulators, a split's
// atomic sums, or bf16 rows not 16-byte aligned): stores of two
// neighbouring columns from registers (a quad of threads: 32 bytes of a row).
template <int BN>
__device__ __forceinline__ void store_tile(const Params& p, const int (&acc)[BN / 2], int row0, int cb,
                                           const float* cv, const CUtensorMap* tmap_out, uint8_t* stg,
                                           int& chunk) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int c_tile = 2 * t;  // this thread's first column within the tile
  float sr[2] = {0.f, 0.f};
  if (p.out_kind == 1 || p.out_kind == 2) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      sr[h] = row < p.m ? p.s_row[(int64_t)row * p.row_scale_stride] : 0.f;
    }
  }
  const bool has_bias = p.bias != nullptr;
  if (p.tma_out) {
#pragma unroll
    for (int q = 0; q < BN / 32; ++q) {
      uint8_t* buf = stg + (chunk & 1) * STG_BUF;
      if (chunk >= 2) {  // the store that last read this buffer is done with it
        if (lane == 0) asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        __syncwarp();
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int jn = 4 * q + jj, c = c_tile + 8 * jn;
        const float sc0 = cv[c], sc1 = cv[c + 1], b0 = cv[BN + c], b1 = cv[BN + c + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int lr = g + 8 * h;
          __nv_bfloat16 y0 = __float2bfloat16_rn(dequant(acc[4 * jn + 2 * h], sr[h], sc0));
          __nv_bfloat16 y1 = __float2bfloat16_rn(dequant(acc[4 * jn + 2 * h + 1], sr[h], sc1));
          if (has_bias) {
            y0 = __float2bfloat16_rn(__fadd_rn(__bfloat162float(y0), b0));
            y1 = __float2bfloat16_rn(__fadd_rn(__bfloat162float(y1), b1));
          }
          __nv_bfloat162 pair;
          pair.x = y0;
          pair.y = y1;
          // 64-byte rows in the 64-byte swizzle: 16-byte chunk jj, 4 bytes at 4 t
          *reinterpret_cast<__nv_bfloat162*>(buf + lr * 64 + ((jj ^ ((lr >> 1) & 3)) << 4) + 4 * t) = pair;
        }
      }
      icd::fence_proxy_async();  // the staged values, visible to the TMA unit
      __syncwarp();
      if (lane == 0) tma_store_2d(tmap_out, buf, cb - c_tile + 32 * q, row0 - g);
      ++chunk;
    }
    return;
  }
  const bool pairs = (p.n & 1) == 0;  // (row * N + col) even: a pair is one aligned store
#pragma unroll
  for (int jn = 0; jn < BN / 8; ++jn) {
    const int col = cb + 8 * jn, c = c_tile + 8 * jn;
    if (col >= p.n) continue;
    const bool two = col + 1 < p.n;
    const float sc0 = cv[c], sc1 = cv[c + 1], b0 = cv[BN + c], b1 = cv[BN + c + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= p.m) continue;
      const int64_t o = (int64_t)row * p.n + col;
      const int v0 = acc[4 * jn + 2 * h], v1 = acc[4 * jn + 2 * h + 1];
      if (p.out_kind == 0 || p.out_kind == KIND_ATOMIC) {
        int* out = static_cast<int*>(p.out);
        if (p.out_kind == KIND_ATOMIC) {
          atomicAdd(out + o, v0);
          if (two) atomicAdd(out + o + 1, v1);
        } else if (pairs && two) {
          *reinterpret_cast<int2*>(out + o) = make_int2(v0, v1);
        } else {
          out[o] = v0;
          if (two) out[o + 1] = v1;
        }
      } else if (p.out_kind == 1) {
        float* out = static_cast<float*>(p.out);
        float y0 = dequant(v0, sr[h], sc0), y1 = dequant(v1, sr[h], sc1);
        if (has_bias) {
          y0 = __fadd_rn(y0, b0);
          y1 = __fadd_rn(y1, b1);
        }
        if (pairs && two) {
          *reinterpret_cast<float2*>(out + o) = make_float2(y0, y1);
        } else {
          out[o] = y0;
          if (two) out[o + 1] = y1;
        }
      } else {
        __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
        __nv_bfloat16 y0 = __float2bfloat16_rn(dequant(v0, sr[h], sc0));
        __nv_bfloat16 y1 = __float2bfloat16_rn(dequant(v1, sr[h], sc1));
        if (has_bias) {
          y0 = __float2bfloat16_rn(__fadd_rn(__bfloat162float(y0), b0));
          y1 = __float2bfloat16_rn(__fadd_rn(__bfloat162float(y1), b1));
        }
        out[o] = y0;
        if (two) out[o + 1] = y1;
      }
    }
  }
}

// tile t of the launch -> its rows, columns and K steps (splits fastest,
// then the N tiles, so neighbouring blocks share A's rows in L2)
__device__ __forceinline__ void tile_of(const Params& p, int t, int& m0, int& n0, int& s_begin, int& s_end) {
  const int z = t % p.splits;
  t /= p.splits;
  n0 = (t % p.nt) * p.bn;
  m0 = (t / p.nt) * BM;
  s_begin = z * p.steps;
  s_end = min(p.nk, s_begin + p.steps);
}

template <int STAGES>
__device__ __forceinline__ void advance(int& stage, uint32_t& phase) {
  if (++stage == STAGES) {
    stage = 0;
    phase ^= 1;
  }
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
    int8_gemm_kernel(const __grid_constant__ CUtensorMap tmap_b, const __grid_constant__ CUtensorMap tmap_out,
                     const Params p) {
  constexpr int STAGES = stages<BN>();
  constexpr int LAG = STAGES - 2;  // K steps a gathering thread keeps in flight past the one it issues
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint8_t* sa = smem;                               // STAGES x [128][128], swizzled
  uint8_t* sb = smem + STAGES * A_STAGE;            // STAGES x [BN][128], swizzled
  uint8_t* staging = sb + STAGES * BN * BK;         // 8 x STG_WARP, 1024-byte aligned
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 8 * STG_WARP);
  uint64_t* empty = full + STAGES;
  float* colv = reinterpret_cast<float*>(empty + STAGES);  // [2 tiles][scale BN, bias BN]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      icd::mbar_init(&full[s], 129);  // 128 gathering threads + the TMA thread's expect_tx
      icd::mbar_init(&empty[s], 8);   // one arrival a consumer warp
    }
    icd::fence_mbar_init();
  }
  __syncthreads();

  if (warp >= 8) {
    // ---------------- producer warpgroup: every K step of every tile ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int pt = tid - CONSUMERS;
    if (pt == 0) {
      asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(&tmap_b)) : "memory");
      if (p.tma_out)
        asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(&tmap_out)) : "memory");
    }
    const int j = pt & 7;    // this thread's 16-byte chunk of each 128-byte K step
    const int r0 = pt >> 3;  // its rows: r0 + 16 i, i < 8 (all with r % 8 == r0 % 8)
    uint8_t* my_a = sa + r0 * BK + ((j ^ (r0 & 7)) << 4);
    int stage = 0, issued = 0, arrived = 0, arrive_stage = 0;
    uint32_t phase = 0, arrive_phase = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      int m0, n0, s_begin, s_end;
      tile_of(p, t, m0, n0, s_begin, s_end);
      int base[8], pos[8];  // per row: offset of pixel (b, ih0, iw0), and (ih0, iw0) packed
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = m0 + r0 + 16 * i;
        if (m < p.m) {
          const int ow = m % p.wo, tt = m / p.wo;
          const int oh = tt % p.ho, b = tt / p.ho;
          const int ih0 = oh * p.sh - p.ph, iw0 = ow * p.sw - p.pw;
          base[i] = ((b * p.h + ih0) * p.w + iw0) * p.c;
          pos[i] = (int)(((unsigned)ih0 << 16) | ((unsigned)iw0 & 0xFFFFu));
        } else {
          base[i] = 0;
          pos[i] = (int)(0xC000u << 16);  // ih0 = -16384: never inside the image
        }
      }
      for (int s = s_begin; s < s_end; ++s) {
        icd::mbar_wait(&empty[stage], phase ^ 1);
        if (pt == 0) {
          icd::mbar_expect_tx(&full[stage], BN * BK);
          tma_load_2d(sb + stage * BN * BK, &tmap_b, s * BK, n0, &full[stage]);
        }
        const int k = s * BK + 16 * j;
        const bool kin = k < p.k;
        int ky = 0, kx = 0, off = 0;
        if (kin) {
          const int tap = k / p.c, cc = k - tap * p.c;
          ky = tap / p.kw;
          kx = tap - ky * p.kw;
          off = (ky * p.w + kx) * p.c + cc;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int ih = (pos[i] >> 16) + ky, iw = ((int)((unsigned)pos[i] << 16) >> 16) + kx;
          const bool ok = kin && ih >= 0 && ih < p.h && iw >= 0 && iw < p.w;
          icd::cp_async16(my_a + stage * A_STAGE + i * 16 * BK, p.a + (ok ? base[i] + off : 0), ok);
        }
        icd::cp_async_commit();
        advance<STAGES>(stage, phase);
        if (++issued > LAG) {  // step issued - 1 - LAG has landed: hand it to the async proxy
          icd::cp_async_wait<LAG>();
          icd::fence_proxy_async();
          mbar_arrive(&full[arrive_stage]);
          advance<STAGES>(arrive_stage, arrive_phase);
          ++arrived;
        }
      }
    }
    icd::cp_async_wait<0>();
    icd::fence_proxy_async();
    for (; arrived < issued; ++arrived) {
      mbar_arrive(&full[arrive_stage]);
      advance<STAGES>(arrive_stage, arrive_phase);
    }
  } else {
    // ---------------- consumer warpgroups: the products and the epilogue of every tile ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = warp >> 2;
    const uint32_t a0 = smem_u32(sa) + wg * 64 * BK;
    const uint32_t b0 = smem_u32(sb);
    int stage = 0, chunk = 0, parity = 0;
    uint32_t phase = 0;
    const bool dequantise = p.out_kind == 1 || p.out_kind == 2;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x, parity ^= 1) {
      int m0, n0, s_begin, s_end;
      tile_of(p, t, m0, n0, s_begin, s_end);
      // the tile's column scales and bias into shared memory (two tiles'
      // worth: a slow warp may still read the last tile's)
      float* cv = colv + parity * 2 * BN;
      for (int i = tid; i < BN; i += CONSUMERS) {
        const int col = n0 + i;
        const bool in = dequantise && col < p.n;
        cv[i] = in ? p.s_col[col] : 0.f;
        cv[BN + i] = in && p.bias != nullptr
                         ? (p.out_kind == 2 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.bias)[col])
                                            : static_cast<const float*>(p.bias)[col])
                         : 0.f;
      }
      int acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      int prev = -1;
      for (int s = s_begin; s < s_end; ++s) {
        icd::mbar_wait(&full[stage], phase);
        fence_acc(acc);
        icd::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
          wgmma_s8(acc, desc_sw128(a0 + stage * A_STAGE + kk * 32), desc_sw128(b0 + stage * BN * BK + kk * 32), 1);
        icd::wgmma_commit();
        fence_acc(acc);
        if (prev >= 0) {  // the previous step's products have retired: its stage is free
          icd::wgmma_wait<1>();
          fence_acc(acc);
          if (lane == 0) mbar_arrive(&empty[prev]);
        }
        prev = stage;
        advance<STAGES>(stage, phase);
      }
      icd::wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(&empty[prev]);
      // the epilogue runs while the producer fills the ring with the next tile
      asm volatile("bar.sync 1, 256;\n" ::: "memory");  // the tile's column values are in
      store_tile<BN>(p, acc, m0 + wg * 64 + (warp & 3) * 16 + (lane >> 2), n0 + 2 * (lane & 3), cv, &tmap_out,
                     staging + warp * STG_WARP, chunk);
    }
    if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");  // the last stores are done
  }
}

// the split launches' epilogue: int32 sums in `sums` -> the output
__global__ void __launch_bounds__(256) int8_gemm_epilogue(const int* __restrict__ sums, const Params p) {
  const int64_t total = (int64_t)p.m * p.n;
  for (int64_t i = (int64_t)blockIdx.x * 256 + threadIdx.x; i < total; i += (int64_t)gridDim.x * 256) {
    const int64_t row = i / p.n;
    const int col = (int)(i - row * p.n);
    store_one(p, i, col, sums[i], p.s_row[row * p.row_scale_stride]);
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// B [N][K] int8 as a 2-D map of [BN][128] boxes in the 128-byte swizzle;
// reads past N or K come back as zeros
EncodeTiledFn encode_fn() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
  if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) != cudaSuccess ||
      found != cudaDriverEntryPointSuccess)
    return nullptr;
  return reinterpret_cast<EncodeTiledFn>(fn);
}

cudaError_t b_tensor_map(CUtensorMap* map, const void* b, int n, int k, int bn) {
  static EncodeTiledFn encode = encode_fn();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)k};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)bn};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(b), dims, strides, box,
                            steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the bf16 output [M][N] as a 2-D map of 16-row x 32-column boxes in the
// 64-byte swizzle the epilogue stages them in
cudaError_t out_tensor_map(CUtensorMap* map, void* out, int m, int n) {
  static EncodeTiledFn encode = encode_fn();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)m};
  const cuuint64_t strides[1] = {(cuuint64_t)n * 2};
  const cuuint32_t box[2] = {32, 16};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, out, dims, strides, box, steps,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

int pick_bn(int n) {
  if (n <= 32) return 32;
  if (n % 256 == 0) return 256;
  if (n % 160 == 0) return 160;
  if (n <= 128) return 128;
  int best = 256, waste = (n + 255) / 256 * 256 - n;  // else the least padding, wider on a tie
  const int others[2] = {160, 128};
  for (int i = 0; i < 2; ++i) {
    const int w = (n + others[i] - 1) / others[i] * others[i] - n;
    if (w < waste) best = others[i], waste = w;
  }
  return best;
}

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0 && cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    count[dev] = 132;
  return count[dev];
}

struct Plan {
  int bn, mt, nt, nk, steps, splits, blocks;
};

// the tiles, and a split of the K steps where the tiles leave SMs idle
// (one wave, at least 2 K steps a split)
bool make_plan(Params& p, int batch, int h, int w, int c, int n, int kh, int kw, int sh, int sw, int ph, int pw,
               Plan& plan) {
  if (batch <= 0 || h <= 0 || w <= 0 || c <= 0 || n <= 0 || kh <= 0 || kw <= 0 || sh <= 0 || sw <= 0 || ph < 0 ||
      pw < 0 || c % 16 != 0 || h >= 16384 || w >= 16384)
    return false;
  if ((int64_t)batch * h * w * c >= (1LL << 31)) return false;
  const int64_t k = (int64_t)kh * kw * c;
  if (k >= (1LL << 31)) return false;
  p.h = h, p.w = w, p.c = c, p.n = n, p.kw = kw, p.sh = sh, p.sw = sw, p.ph = ph, p.pw = pw;
  p.ho = (h + 2 * ph - kh) / sh + 1;
  p.wo = (w + 2 * pw - kw) / sw + 1;
  if (p.ho <= 0 || p.wo <= 0) return false;
  const int64_t m = (int64_t)batch * p.ho * p.wo;
  if (m >= (1LL << 31)) return false;
  p.m = (int)m;
  p.k = (int)k;
  plan.bn = pick_bn(n);
  plan.mt = (p.m + BM - 1) / BM;
  plan.nt = (n + plan.bn - 1) / plan.bn;
  plan.nk = (p.k + BK - 1) / BK;
  const int64_t tiles = (int64_t)plan.mt * plan.nt;
  const int sms = sm_count();
  int splits = 1;
  if (2 * tiles <= sms && plan.nk >= 4) {  // one wave of at most `sms` blocks
    const int want = (int)(sms / tiles);
    splits = want < plan.nk / 2 ? want : plan.nk / 2;
  }
  plan.steps = (plan.nk + splits - 1) / splits;
  plan.splits = (plan.nk + plan.steps - 1) / plan.steps;  // no empty split
  p.nk = plan.nk;
  p.steps = plan.steps;
  p.bn = plan.bn;
  p.nt = plan.nt;
  p.splits = plan.splits;
  const int64_t all = tiles * plan.splits;
  if (all >= (1LL << 31)) return false;
  p.tiles = (int)all;
  plan.blocks = all < sms ? (int)all : sms;  // persistent: one block an SM at most
  return true;
}

template <int BN>
int launch_bn(const CUtensorMap& map, const CUtensorMap& out_map, const Params& p, const Plan& plan,
              cudaStream_t stream) {
  constexpr int smem = smem_bytes<BN>();
  static const cudaError_t attr =
      cudaFuncSetAttribute(int8_gemm_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  int8_gemm_kernel<BN><<<plan.blocks, THREADS, smem, stream>>>(map, out_map, p);
  return (int)cudaGetLastError();
}

int launch(Params& p, const void* b, const Plan& plan, void* sums, cudaStream_t stream) {
  CUtensorMap map;
  cudaError_t e = b_tensor_map(&map, b, p.n, p.k, plan.bn);
  if (e != cudaSuccess) return (int)e;
  const int final_kind = p.out_kind;
  void* final_out = p.out;
  if (plan.splits > 1) {  // the splits add into zeroed int32 sums: the output itself, or the workspace
    if (final_kind != 0 && sums == nullptr) return (int)cudaErrorInvalidValue;
    void* target = final_kind == 0 ? final_out : sums;
    e = cudaMemsetAsync(target, 0, (size_t)p.m * p.n * sizeof(int), stream);
    if (e != cudaSuccess) return (int)e;
    p.out = target;
    p.out_kind = KIND_ATOMIC;
  }
  CUtensorMap out_map = map;  // a placeholder where the output goes by plain stores
  p.tma_out = p.out_kind == 2 && p.n % 8 == 0 && reinterpret_cast<uintptr_t>(p.out) % 16 == 0;
  if (p.tma_out) {
    e = out_tensor_map(&out_map, p.out, p.m, p.n);
    if (e != cudaSuccess) return (int)e;
  }
  int rc;
  switch (plan.bn) {
    case 32: rc = launch_bn<32>(map, out_map, p, plan, stream); break;
    case 128: rc = launch_bn<128>(map, out_map, p, plan, stream); break;
    case 160: rc = launch_bn<160>(map, out_map, p, plan, stream); break;
    default: rc = launch_bn<256>(map, out_map, p, plan, stream); break;
  }
  if (rc != 0 || plan.splits == 1 || final_kind == 0) return rc;
  p.out = final_out;
  p.out_kind = final_kind;
  const int64_t total = (int64_t)p.m * p.n;
  const int64_t blocks = (total + 255) / 256;
  int8_gemm_epilogue<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(static_cast<const int*>(sums), p);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of workspace `icd_int8_gemm` needs at this shape (0 unless the K
// steps are split; `icd_int8_gemm_acc` needs none), or -1 for a shape Q1
// does not take.
extern "C" long long icd_int8_gemm_workspace(int batch, int h, int w, int c, int n, int kh, int kw, int sh, int sw,
                                             int ph, int pw) {
  Params p;
  Plan plan;
  if (!make_plan(p, batch, h, w, c, n, kh, kw, sh, sw, ph, pw, plan)) return -1;
  return plan.splits > 1 ? (long long)p.m * p.n * (long long)sizeof(int) : 0;
}

// out_kind: 1 fp32, 2 bf16; bias (in the output type) may be null.
// row_scale_stride: 0 (one s_row scale) or 1.
extern "C" int icd_int8_gemm(const void* a, const void* b, const void* s_row, const void* s_col, const void* bias,
                             void* out, void* workspace, int batch, int h, int w, int c, int n, int kh, int kw,
                             int sh, int sw, int ph, int pw, int row_scale_stride, int out_kind,
                             cudaStream_t stream) {
  if (out_kind != 1 && out_kind != 2) return (int)cudaErrorInvalidValue;
  if (row_scale_stride != 0 && row_scale_stride != 1) return (int)cudaErrorInvalidValue;
  Params p;
  Plan plan;
  if (!make_plan(p, batch, h, w, c, n, kh, kw, sh, sw, ph, pw, plan)) return (int)cudaErrorInvalidValue;
  p.a = static_cast<const int8_t*>(a);
  p.s_row = static_cast<const float*>(s_row);
  p.s_col = static_cast<const float*>(s_col);
  p.bias = bias;
  p.out = out;
  p.out_kind = out_kind;
  p.row_scale_stride = row_scale_stride;
  return launch(p, b, plan, workspace, stream);
}

extern "C" int icd_int8_gemm_acc(const void* a, const void* b, void* out, int batch, int h, int w, int c, int n,
                                 int kh, int kw, int sh, int sw, int ph, int pw, cudaStream_t stream) {
  Params p;
  Plan plan;
  if (!make_plan(p, batch, h, w, c, n, kh, kw, sh, sw, ph, pw, plan)) return (int)cudaErrorInvalidValue;
  p.a = static_cast<const int8_t*>(a);
  p.s_row = nullptr;
  p.s_col = nullptr;
  p.bias = nullptr;
  p.out = out;
  p.out_kind = 0;
  p.row_scale_stride = 0;
  return launch(p, b, plan, nullptr, stream);
}
