// Kernel B1: flash-attention forward for head dims <= 256.
//
// Replaces `_fwd_kernel` in invertible_cd_tpu/ops/flash_attention.py
// (launched by `_flash_forward` through `_flash_op`): every UNet self- and
// cross-attention of the SD1.5 main path, at Sq = Sk = 4096/1024/256/64 with
// d = 40/80/160/160, and Sk = 77 for cross-attention; and of SDXL's, at
// Sq = Sk = 4096 (10 heads) and 1024 (20 heads), every head d = 64, with
// Sk = 77 for cross-attention.
//
// Bounds on an H100 SXM (700 W) at the hottest shape, Sq = Sk = 4096, d = 40,
// batch 4 x 8 heads: 8.59e10 FLOPs take 0.087 ms at 989 TFLOP/s; 5.37e8
// exponentials (one per logit) take 0.138 ms at 3.9e12/s (the MUFU unit, 16
// a clock per SM); 10.5 MB of q, k, v, o take 0.003 ms at 3.35 TB/s; SDPA's
// forward took 0.364 ms. So below d = 64 the exponentials, not the tensor
// cores, set the floor, and the design has to keep the MUFU busy while the
// products and loads run beside it. The earlier design (4 warps x 16 rows,
// mma.sync, K and V staged synchronously, V transposed by scalar stores,
// kept in flash_mma.cuh for DP = 256) took 0.979 ms at that shape. The
// Hopper design is the tile loop of flash_wgmma.cuh (two warpgroups of 64
// query rows, wgmma for Q K^T and P V with V read MN-major, a 3-stage
// cp.async K/V ring, 64-key tiles), which B5's softmax variants share; B1
// passes it its softmax (B1Softmax there): base 2 with the scale folded
// into one FFMA a logit, p = exp2(s * c - m * c) with c = log2(e) /
// sqrt(d), one fp32 ex2.approx.ftz each (the lse entry point needs fp32).
// An explicit ping-pong of the two warpgroups of a block over named
// barriers measured slower. The second entry point also writes the fp32 row
// logsumexp (natural log, (B, H, Sq)) that the backward kernels B3 and B4
// recompute the probabilities from; the inference entry point writes
// nothing more, as the reference's `_flash_op` does.
//
// Head dims above 160 (DP = 256: off every path of the port, where the
// accumulator alone would take 128 registers a thread) take the earlier
// mma.sync loop of flash_mma.cuh as a static route by head dim.
#include "flash_common.cuh"
#include "flash_mma.cuh"
#include "flash_wgmma.cuh"

namespace icd {

// ---- Hopper route, padded head dims 48, 64, 80 and 160: the shared wgmma
// loop (flash_wgmma.cuh) with B1's softmax. SDXL's d = 64 runs at DP 64,
// unpadded; measured on an H100 SXM it gives the same bits and the same
// time as DP 80's zero columns (0.21 ms at 4096^2, 10 heads): the loop is
// held by its product -> softmax -> product chain there, not its products ----
template <int DP>
int launch_b1(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
              int heads, int sq, int sk, int d, float scale, void* stream) {
  return launch_fwd_wgmma<DP, B1Softmax>(q, k, v, o, lse, batch, heads, sq, sk, d,
                                         scale * kLog2e, stream);
}

// ---- the mma.sync route, padded head dim 256 only ----
// B1's softmax on the mma.sync loop (flash_mma.cuh): base 2, the
// logits times scale * log2(e), m and l in the base-2 units store_lse takes.
struct B1MmaSoftmax {
  static constexpr bool kRescale = true;
  template <int NS>
  __device__ static void tile(float (&s)[NS][4], uint32_t (&p)[NS][2], float (&m)[2],
                              float (&l)[2], float (&alpha)[2], float scale_log2, int k0, int sk,
                              int t) {
    online_softmax<NS>(s, m, l, alpha, scale_log2, k0, sk, t);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      p[n][0] = pack_bf16(s[n][0], s[n][1]);
      p[n][1] = pack_bf16(s[n][2], s[n][3]);
    }
  }
};

int dispatch_b1(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
                int heads, int sq, int sk, int d, float scale, void* stream) {
  if (d <= 48) return launch_b1<48>(q, k, v, o, lse, batch, heads, sq, sk, d, scale, stream);
  if (d <= 64) return launch_b1<64>(q, k, v, o, lse, batch, heads, sq, sk, d, scale, stream);
  if (d <= 80) return launch_b1<80>(q, k, v, o, lse, batch, heads, sq, sk, d, scale, stream);
  if (d <= 160) return launch_b1<160>(q, k, v, o, lse, batch, heads, sq, sk, d, scale, stream);
  if (d <= 256) {
    return launch_fwd_mma<256, B1MmaSoftmax>(q, k, v, o, lse, batch, heads, sq, sk, d,
                                            scale * kLog2e, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace icd

extern "C" int icd_flash_fwd(const void* q, const void* k, const void* v, void* o,
                             int batch, int heads, int sq, int sk, int d,
                             float scale, void* stream) {
  return icd::dispatch_b1(q, k, v, o, nullptr, batch, heads, sq, sk, d, scale, stream);
}

// The same kernel, also writing lse (B, H, Sq) fp32.
extern "C" int icd_flash_fwd_lse(const void* q, const void* k, const void* v, void* o,
                                 void* lse, int batch, int heads, int sq, int sk, int d,
                                 float scale, void* stream) {
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  return icd::dispatch_b1(q, k, v, o, lse, batch, heads, sq, sk, d, scale, stream);
}
