// K2 ln_linear: row LayerNorm prologue (fp32 statistics) feeding a bf16
// tensor-core GEMM against a torch-layout weight W (N, K).
//
// Replaces, from the JAX package:
//   - vista_tpu/ops/fused_qkv.py  _qkv_kernel (fused_ln_qkv): epilogue "split"
//     writes q, k, v as three contiguous (M, N/3) tensors;
//   - vista_tpu/ops/fused_ff.py   _ff_kernel, first half (LN -> proj_in ->
//     GEGLU): epilogue "geglu" writes a * gelu(g) + bias, (M, N);
//   - vista_tpu/ops/fused_temporal_attn.py _kernel, the LN + q/k/v part.
//
// On the H100 the GEMM is compute-bound at the UNet widths (K = c = 320..1280,
// N = 3c or 8c, M = 50 * h * w rows), so the design aims at keeping the
// tensor cores fed: 128x128 block tiles, LN applied while the A tile is
// staged (the normalised activations never reach device memory), and the
// GEGLU pair (a, g) computed in the same block so that the 2x-wide proj_in
// output is never written. The LN statistics are a second read of the
// block's rows, which stays in L2. Later work: wgmma + TMA pipelines.
//
// LayerNorm matches the JAX kernels: mean and E[x^2] - mean^2 in fp32,
// normalised value rounded to bf16 before the product. GELU is the exact
// erf form (the TPU kernel used tanh only because Mosaic has no erf).
#include "common.cuh"

namespace vk {

enum { LN_SPLIT = 0, LN_GEGLU = 1 };

__global__ void __launch_bounds__(GEMM_THREADS)
ln_linear_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                 const float* __restrict__ beta, const bf16* __restrict__ w,
                 const float* __restrict__ bias, bf16* __restrict__ out,
                 int M, int K, int N, int mode, int seg, float eps) {
  __shared__ __align__(16) GemmSmem sm;
  __shared__ float s_mean[BM], s_rstd[BM];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * BM;

  // LayerNorm statistics of this block's rows: one warp per row.
  for (int r = warp; r < BM; r += GEMM_THREADS / 32) {
    const int m = m0 + r;
    float s = 0.f, ss = 0.f;
    if (m < M) {
      const bf16* xr = x + (size_t)m * K;
      for (int k = lane * 8; k < K; k += 256) {
        float f[8];
        unpack8(*reinterpret_cast<const uint4*>(xr + k), f);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          s += f[e];
          ss += f[e] * f[e];
        }
      }
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    if (lane == 0) {
      const float mean = s / K;
      const float var = fmaxf(ss / K - mean * mean, 0.f);
      s_mean[r] = mean;
      s_rstd[r] = rsqrtf(var + eps);
    }
  }
  __syncthreads();

  auto load_a = [&](int row, int k) -> uint4 {
    const int m = m0 + row;
    if (m >= M) return make_uint4(0, 0, 0, 0);
    float f[8];
    unpack8(*reinterpret_cast<const uint4*>(x + (size_t)m * K + k), f);
    const float mean = s_mean[row], rstd = s_rstd[row];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      f[e] = (f[e] - mean) * rstd * gamma[k + e] + beta[k + e];
    return pack8(f);
  };

  float acc[4][4][4];
  if (mode == LN_SPLIT) {
    const int n0 = blockIdx.y * BN;
    auto load_b = [&](int row, int k) -> uint4 {
      const int n = n0 + row;
      if (n >= N) return make_uint4(0, 0, 0, 0);
      return *reinterpret_cast<const uint4*>(w + (size_t)n * K + k);
    };
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
          const int part = n / seg, col = n - part * seg;
          const size_t o = ((size_t)part * M + m) * seg + col;
          float v0 = acc[i][j][half * 2], v1 = acc[i][j][half * 2 + 1];
          if (bias) {
            v0 += bias[n];
            v1 += bias[n + 1];
          }
          *reinterpret_cast<uint32_t*>(out + o) = pack_bf16(v0, v1);
        }
      }
  } else {
    // GEGLU: W has 2N rows, [value; gate]. This block owns output columns
    // [o0, o0 + 64). Tile column c = 32 * wn + l holds value row
    // o0 + 16 * wn + (l % 16) for l < 16 and the matching gate row for
    // l >= 16, so a thread finds a and g of one output in acc[i][j] and
    // acc[i][j + 2].
    const int o0 = blockIdx.y * (BN / 2);
    auto load_b = [&](int row, int k) -> uint4 {
      const int wn_ = row >> 5, l = row & 31;
      const int o = o0 + wn_ * 16 + (l & 15);
      const int src = l < 16 ? o : N + o;
      return *reinterpret_cast<const uint4*>(w + (size_t)src * K + k);
    };
    gemm_mainloop(K, load_a, load_b, sm, acc);

    const int g = lane >> 2, t = lane & 3, wm = warp >> 2, wn = warp & 3;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm * 64 + i * 16 + g + half * 8;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int o = o0 + wn * 16 + j * 8 + t * 2;
          float v[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float a = acc[i][j][half * 2 + q] + bias[o + q];
            const float gt = acc[i][j + 2][half * 2 + q] + bias[N + o + q];
            v[q] = a * (0.5f * gt * (1.f + erff(gt * 0.7071067811865476f)));
          }
          *reinterpret_cast<uint32_t*>(out + (size_t)m * N + o) =
              pack_bf16(v[0], v[1]);
        }
      }
  }
}

}  // namespace vk

// x (M, K) bf16; gamma, beta (K) fp32; w (N, K) bf16 for "split", (2N, K)
// for "geglu"; bias fp32 (N or 2N) or null for "split", required for
// "geglu"; out (N/seg, M, seg) bf16 for "split", (M, N) for "geglu".
// K % 32 == 0; split: seg even; geglu: N % 64 == 0.
extern "C" int vk_ln_linear(const void* x, const void* gamma, const void* beta,
                            const void* w, const void* bias, void* out, int M,
                            int K, int N, int mode, int seg, float eps,
                            void* stream) {
  const int cols = mode == vk::LN_SPLIT ? vk::BN : vk::BN / 2;
  dim3 grid((M + vk::BM - 1) / vk::BM, (N + cols - 1) / cols);
  vk::ln_linear_kernel<<<grid, vk::GEMM_THREADS, 0, (cudaStream_t)stream>>>(
      (const vk::bf16*)x, (const float*)gamma, (const float*)beta,
      (const vk::bf16*)w, (const float*)bias, (vk::bf16*)out, M, K, N, mode,
      seg, eps);
  return (int)cudaGetLastError();
}
