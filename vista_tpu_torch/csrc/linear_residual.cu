// K3 linear_residual: out = residual + A * W^T + bias, with the residual
// and bias added to the fp32 accumulator and one rounding to bf16.
//
// Replaces, from the JAX package:
//   - vista_tpu/ops/fused_ff.py _ff_kernel, second half (proj_out + bias +
//     fp32 residual);
//   - vista_tpu/ops/fused_temporal_attn.py _kernel, the out-projection +
//     bias + residual;
//   - and serves ``o @ wo + bo + x`` of pre_ln_self_attention
//     (vista_tpu/models/attention.py), which the JAX package left to XLA.
//
// Bound on the H100: tensor-core throughput for K = 4c (the FF) and, at
// c = 320 with K = c, close to balanced with the bytes of A, residual and
// output. The epilogue fusion saves one full read + write of the (M, c)
// activation per call against a GEMM followed by an add.
#include "common.cuh"

namespace vk {

__global__ void __launch_bounds__(GEMM_THREADS)
linear_residual_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                       const float* __restrict__ bias,
                       const bf16* __restrict__ res, bf16* __restrict__ out,
                       int M, int K, int N) {
  __shared__ __align__(16) GemmSmem sm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  auto load_a = [&](int row, int k) -> uint4 {
    const int m = m0 + row;
    if (m >= M) return make_uint4(0, 0, 0, 0);
    return *reinterpret_cast<const uint4*>(a + (size_t)m * K + k);
  };
  auto load_b = [&](int row, int k) -> uint4 {
    const int n = n0 + row;
    if (n >= N) return make_uint4(0, 0, 0, 0);
    return *reinterpret_cast<const uint4*>(w + (size_t)n * K + k);
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
        const float2 r = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(res + o));
        const float v0 = r.x + acc[i][j][half * 2] + bias[n];
        const float v1 = r.y + acc[i][j][half * 2 + 1] + bias[n + 1];
        *reinterpret_cast<uint32_t*>(out + o) = pack_bf16(v0, v1);
      }
    }
}

}  // namespace vk

// a (M, K) bf16, w (N, K) bf16, bias (N) fp32, res and out (M, N) bf16.
// K % 32 == 0, N even.
extern "C" int vk_linear_residual(const void* a, const void* w,
                                  const void* bias, const void* res, void* out,
                                  int M, int K, int N, void* stream) {
  dim3 grid((M + vk::BM - 1) / vk::BM, (N + vk::BN - 1) / vk::BN);
  vk::linear_residual_kernel<<<grid, vk::GEMM_THREADS, 0,
                               (cudaStream_t)stream>>>(
      (const vk::bf16*)a, (const vk::bf16*)w, (const float*)bias,
      (const vk::bf16*)res, (vk::bf16*)out, M, K, N);
  return (int)cudaGetLastError();
}
