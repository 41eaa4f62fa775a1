// K4 gn_silu_conv3: the 3-tap convolution over frames of a (b, t, s, c)
// video, with the GroupNorm affine + SiLU applied as the input is staged:
//
//   y[f, p] = sum_tap SiLU(x[f+tap-1, p] * scale[f+tap-1] + shift[f+tap-1])
//                     . W[tap] + bias
//   epilogue "emb": out = y + emb[f]
//   epilogue "res": out = residual + res_scale * y
//
// Replaces vista_tpu/ops/temporal_conv.py _gn_conv3_kernel (entries
// fused_gn_silu_conv3_emb and fused_gn_silu_conv3_res). scale/shift are the
// GroupNorm statistics folded per (frame, channel) by the caller.
//
// Written as one GEMM with M = b*t*s rows and K = 3 * cin: the A tile for tap
// ``tap`` of output row (f, p) is the normalised row (f + tap - 1, p), read
// straight from x. Taps that fall outside the video are skipped: their rows
// are zero in shared memory and nothing is read for them (the TPU kernel
// padded x with a zero frame at each edge instead). On the H100 this is a
// tensor-core-bound GEMM (6 * M * cin * cout flops against ~3 reads of x,
// mostly from L2); the normalised input never reaches device memory.
//
// conv3 (the entry vk_conv3): the same kernel without the GroupNorm + SiLU
// prologue, and with an optional bias and no epilogue: the plain 3-tap
// frame conv, replacing vista_tpu/ops/temporal_conv.py _conv3_kernel
// (temporal_conv3). It runs the backward of K4: dx is this conv of the
// cotangent with flipped, transposed taps, and the ``res`` epilogue's
// res_scale gradient needs y recomputed. Its own launch and counter.
#include "common.cuh"

namespace vk {

template <bool PROLOGUE>
__global__ void __launch_bounds__(GEMM_THREADS)
gn_silu_conv3_kernel(const bf16* __restrict__ x,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift,
                     const bf16* __restrict__ w, const float* __restrict__ bias,
                     const float* __restrict__ emb,
                     const bf16* __restrict__ res,
                     const float* __restrict__ res_scale,
                     bf16* __restrict__ out, int M, int S, int T, int K,
                     int N) {
  __shared__ __align__(16) GemmSmem sm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int K3 = 3 * K;

  auto load_a = [&](int row, int kk) -> uint4 {
    const int m = m0 + row;
    const int tap = kk / K, k = kk - tap * K;
    if (m >= M) return make_uint4(0, 0, 0, 0);
    const int f = m / S;
    const int src_t = f % T + tap - 1;
    if (src_t < 0 || src_t >= T) return make_uint4(0, 0, 0, 0);
    const int fs = f + tap - 1;
    const int p = m - f * S;
    const uint4 raw =
        *reinterpret_cast<const uint4*>(x + ((size_t)fs * S + p) * K + k);
    if (!PROLOGUE) return raw;
    float v[8];
    unpack8(raw, v);
    const float* sc = scale + (size_t)fs * K + k;
    const float* sh = shift + (size_t)fs * K + k;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float a = v[e] * sc[e] + sh[e];
      v[e] = a / (1.f + __expf(-a));
    }
    return pack8(v);
  };
  auto load_b = [&](int row, int kk) -> uint4 {
    const int n = n0 + row;
    if (n >= N) return make_uint4(0, 0, 0, 0);
    return *reinterpret_cast<const uint4*>(w + (size_t)n * K3 + kk);
  };
  float acc[4][4][4];
  gemm_mainloop(K3, load_a, load_b, sm, acc);

  const float rs = res_scale ? *res_scale : 0.f;
  const int g = lane >> 2, t = lane & 3, wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 64 + i * 16 + g + half * 8;
      if (m >= M) continue;
      const int f = m / S;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + j * 8 + t * 2;
        if (n >= N) continue;
        float v0 = acc[i][j][half * 2] + (bias ? bias[n] : 0.f);
        float v1 = acc[i][j][half * 2 + 1] + (bias ? bias[n + 1] : 0.f);
        if (emb) {
          v0 += emb[(size_t)f * N + n];
          v1 += emb[(size_t)f * N + n + 1];
        }
        const size_t o = (size_t)m * N + n;
        if (res) {
          const float2 r = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(res + o));
          v0 = r.x + rs * v0;
          v1 = r.y + rs * v1;
        }
        *reinterpret_cast<uint32_t*>(out + o) = pack_bf16(v0, v1);
      }
    }
}

}  // namespace vk

// x (b*t*s, cin) bf16; scale, shift (b*t, cin) fp32; w (cout, 3, cin) bf16;
// bias (cout) fp32; emb (b*t, cout) fp32 or null; res (b*t*s, cout) bf16 or
// null, with res_scale a one-element fp32 device buffer; out (b*t*s, cout).
// cin % 32 == 0, cout even.
extern "C" int vk_gn_silu_conv3(const void* x, const void* scale,
                                const void* shift, const void* w,
                                const void* bias, const void* emb,
                                const void* res, const void* res_scale,
                                void* out, int M, int S, int T, int K, int N,
                                void* stream) {
  dim3 grid((M + vk::BM - 1) / vk::BM, (N + vk::BN - 1) / vk::BN);
  vk::gn_silu_conv3_kernel<true><<<grid, vk::GEMM_THREADS, 0,
                             (cudaStream_t)stream>>>(
      (const vk::bf16*)x, (const float*)scale, (const float*)shift,
      (const vk::bf16*)w, (const float*)bias, (const float*)emb,
      (const vk::bf16*)res, (const float*)res_scale, (vk::bf16*)out, M, S, T,
      K, N);
  return (int)cudaGetLastError();
}

// x (b*t*s, cin) bf16; w (cout, 3, cin) bf16; bias (cout) fp32 or null;
// out (b*t*s, cout) bf16. cin % 32 == 0, cout even.
extern "C" int vk_conv3(const void* x, const void* w, const void* bias,
                        void* out, int M, int S, int T, int K, int N,
                        void* stream) {
  dim3 grid((M + vk::BM - 1) / vk::BM, (N + vk::BN - 1) / vk::BN);
  vk::gn_silu_conv3_kernel<false><<<grid, vk::GEMM_THREADS, 0,
                                    (cudaStream_t)stream>>>(
      (const vk::bf16*)x, nullptr, nullptr, (const vk::bf16*)w,
      (const float*)bias, nullptr, nullptr, nullptr, (vk::bf16*)out, M, S, T,
      K, N);
  return (int)cudaGetLastError();
}
