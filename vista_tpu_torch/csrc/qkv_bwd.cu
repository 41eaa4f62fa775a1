// seg_gemm: out (M, N) = sum over s of A_s (M, Kseg) B[:, s Kseg:(s+1) Kseg]^T,
// fp32 accumulation, stored in fp32 or bf16. The K loop walks the segments
// A_0, A_1, ... (each a row-major (M, Kseg) block, seg_stride elements apart)
// as one reduction of depth segs * Kseg, against B (N, segs * Kseg).
//
// Replaces, from the JAX package, the products that
//   - vista_tpu/ops/fused_qkv.py _qkv_bwd_kernel (_qkv_bwd_pallas) and
//   - vista_tpu/ops/fused_temporal_attn.py _bwd_kernel (_bwd_pallas)
// compute in their own bodies:
//   - dxn = gq Wq + gk Wk + gv Wv (segs = 3, fp32 out): the cotangent of K2's
//     split output arrives as one (3, M, inner) tensor, so the three products
//     are one GEMM of depth 3 * inner and dxn never needs a second pass;
//   - the out-projection's input gradient do = gy Wo (segs = 1, bf16 out),
//     the first half of K3's backward.
// It is also the feed-forward backward's dxn = dH W1 (csrc/ff_bwd.cu step 2:
// segs = 1, fp32 out), so the port has one GEMM with an fp32 store.
// The TPU kernels keep the weights and three fp32 dW accumulators in VMEM
// over a sequential token grid. A Hopper block has 227 KB of shared memory
// (one 1280 x 1280 bf16 weight is 3.3 MB) and blocks run in no order, so the
// backward of K2 split (ops/linear.py ln_linear_split_bwd) is this GEMM
// between kernels shared with csrc/ff_bwd.cu: xn recomputed by
// csrc/layer_norm.cu, dx, dgamma, dbeta by vk_ln_bwd (with the residual's
// cotangent added), dW = g_i^T xn by the split-K vk_wgrad whose fp32
// partials vk_sum_splits adds in a fixed order. No atomics: deterministic.
//
// Bound on the H100 (c = inner at every UNet width): dxn is 2 * M * 3c * c
// operations against M * (3c * 2 + c * 4) bytes, 0.6 c operations per byte;
// do is 2 * M * c * c against M * 4c bytes, c / 2 per byte. Against the
// card's 295 operations per byte both are byte-bound at c = 320 and
// tensor-core bound from c = 640. mma.sync 128x128x32 tiles (common.cuh);
// wgmma and TMA are later work.
#include "common.cuh"

namespace vk {

template <bool F32_OUT>
__global__ void __launch_bounds__(GEMM_THREADS)
seg_gemm_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                void* __restrict__ out, int M, int Kseg, int segs, int N,
                long seg_stride) {
  __shared__ __align__(16) GemmSmem sm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int K = Kseg * segs;
  // k runs over the whole depth; a slice of BK = 32 never straddles two
  // segments because Kseg % 32 == 0.
  auto load_a = [&](int row, int k) -> uint4 {
    const int m = m0 + row;
    if (m >= M) return make_uint4(0, 0, 0, 0);
    const int s = k / Kseg;
    return *reinterpret_cast<const uint4*>(a + s * seg_stride + (size_t)m * Kseg +
                                           (k - s * Kseg));
  };
  auto load_b = [&](int row, int k) -> uint4 {
    const int n = n0 + row;
    if (n >= N) return make_uint4(0, 0, 0, 0);
    return *reinterpret_cast<const uint4*>(b + (size_t)n * K + k);
  };
  float acc[4][4][4];
  gemm_mainloop(K, load_a, load_b, sm, acc);
  const int g = lane >> 2, t = lane & 3, wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 64 + i * 16 + g + half * 8;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + j * 8 + t * 2;
        if (n >= N) continue;
        const size_t o = (size_t)m * N + n;
        const float v0 = acc[i][j][half * 2], v1 = acc[i][j][half * 2 + 1];
        if (F32_OUT)
          *reinterpret_cast<float2*>(static_cast<float*>(out) + o) = make_float2(v0, v1);
        else
          *reinterpret_cast<uint32_t*>(static_cast<bf16*>(out) + o) = pack_bf16(v0, v1);
      }
    }
}

}  // namespace vk

// a: segs blocks of (M, Kseg) bf16, seg_stride elements apart; b (N, segs *
// Kseg) bf16; out (M, N), fp32 when out_f32 else bf16. Kseg % 32 == 0, N even.
extern "C" int vk_seg_gemm(const void* a, const void* b, void* out, int M,
                           int Kseg, int segs, int N, long seg_stride,
                           int out_f32, void* stream) {
  dim3 grid((M + vk::BM - 1) / vk::BM, (N + vk::BN - 1) / vk::BN);
  if (out_f32)
    vk::seg_gemm_kernel<true><<<grid, vk::GEMM_THREADS, 0, (cudaStream_t)stream>>>(
        (const vk::bf16*)a, (const vk::bf16*)b, out, M, Kseg, segs, N, seg_stride);
  else
    vk::seg_gemm_kernel<false><<<grid, vk::GEMM_THREADS, 0, (cudaStream_t)stream>>>(
        (const vk::bf16*)a, (const vk::bf16*)b, out, M, Kseg, segs, N, seg_stride);
  return (int)cudaGetLastError();
}
