// layer_norm: row LayerNorm, bf16 in and out, fp32 statistics in the
// E[x^2] - E[x]^2 form (eps inside the rsqrt), affine in fp32.
//
// Replaces vista_tpu/ops/norms.py _ln_kernel (layer_norm): under LoRA the
// norm1 of every spatial and temporal self-attention, whose output feeds the
// q/k/v products and their adapters.
//
// One warp per row, 8 rows per block; a lane reads 16 bytes at a time with
// neighbouring lanes on neighbouring addresses. The row (c <= 1280, 5 chunks
// of 8 per lane) stays in registers between the statistics and the write,
// so x is read once and the output written once: bound by device-memory
// bytes (2 * 2 bytes per element against ~8 flops), as the TPU kernel was.
#include "common.cuh"

namespace vk {

constexpr int LNF_CHUNKS = 5;

__global__ void __launch_bounds__(256)
layer_norm_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, bf16* __restrict__ out,
                  int M, int C, float eps) {
  const int lane = threadIdx.x & 31;
  const long r = (long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (r >= M) return;
  const int chunks = C / 8;
  const bf16* xr = x + r * C;
  float v[LNF_CHUNKS][8];
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int c = 0; c < LNF_CHUNKS; ++c) {
    const int ch = lane + 32 * c;
    if (ch >= chunks) break;
    unpack8(*reinterpret_cast<const uint4*>(xr + ch * 8), v[c]);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s += v[c][e];
      ss += v[c][e] * v[c][e];
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mean = s / C;
  const float rstd = rsqrtf(fmaxf(ss / C - mean * mean, 0.f) + eps);
#pragma unroll
  for (int c = 0; c < LNF_CHUNKS; ++c) {
    const int ch = lane + 32 * c;
    if (ch >= chunks) break;
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      o[e] = (v[c][e] - mean) * rstd * gamma[ch * 8 + e] + beta[ch * 8 + e];
    *reinterpret_cast<uint4*>(out + r * C + ch * 8) = pack8(o);
  }
}

}  // namespace vk

// x, out (M, C) bf16; gamma, beta (C) fp32. C % 8 == 0, C <= 1280.
extern "C" int vk_layer_norm(const void* x, const void* gamma, const void* beta,
                             void* out, int M, int C, float eps, void* stream) {
  vk::layer_norm_kernel<<<(M + 7) / 8, 256, 0, (cudaStream_t)stream>>>(
      (const vk::bf16*)x, (const float*)gamma, (const float*)beta,
      (vk::bf16*)out, M, C, eps);
  return (int)cudaGetLastError();
}
