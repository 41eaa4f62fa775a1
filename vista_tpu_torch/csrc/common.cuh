// Shared pieces of the hand-written Hopper kernels: bf16 tensor-core MMA
// (mma.sync m16n8k16, fp32 accumulate) for the Sk <= 64 attention routes,
// fragment loads from shared memory, bf16 packing, and the erf GELU and its
// derivative. The GEMMs run on TMA + wgmma (csrc/hopper.cuh, gemm_tma.cuh).
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16x16 row-major: a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   B 16x8 "col":      b0 (k 2t..2t+1, n g)  b1 (k 2t+8.., n g)
//   C 16x8 fp32:       c0,c1 (g, 2t..2t+1)   c2,c3 (g+8, 2t..2t+1)
// B operands are read from tiles stored as (N, K) row-major, so a B
// fragment is one 32-bit load.
#pragma once

#include <math.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vk {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two floats -> one register of two bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// d += a * b on the tensor cores.
__device__ __forceinline__ void mma_16816(float d[4], const uint32_t a[4],
                                          const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Eight bf16 values travel as one 16-byte uint4.
__device__ __forceinline__ void unpack8(const uint4& v, float f[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float2 p = __bfloat1622float2(h[e]);
    f[2 * e] = p.x;
    f[2 * e + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float f[8]) {
  uint4 v;
  v.x = pack_bf16(f[0], f[1]);
  v.y = pack_bf16(f[2], f[3]);
  v.z = pack_bf16(f[4], f[5]);
  v.w = pack_bf16(f[6], f[7]);
  return v;
}

// GELU with erf evaluated by Abramowitz-Stegun 7.1.26: |error in erf| <
// 1.5e-7, so |error in gelu(x)| < 1e-7 |x|, fp32 accuracy (the tanh form is
// off by up to 1e-3). One reciprocal and one exponential instead of erff's
// branches: K2's GEGLU epilogue and ff_bwd_dh evaluate it M x N times.
__device__ __forceinline__ float erf_tail(float z) {  // 1 - erf(z) = p(z) exp(-z^2), z >= 0
  const float t = __fdividef(1.f, fmaf(0.3275911f, z, 1.f));
  return t * fmaf(t, fmaf(t, fmaf(t, fmaf(t, 1.061405429f, -1.453152027f),
                                  1.421413741f), -0.284496736f), 0.254829592f);
}

__device__ __forceinline__ float gelu_erf(float x) {
  const float z = fabsf(x) * 0.7071067811865476f;
  const float e = 1.f - erf_tail(z) * __expf(-z * z);
  return 0.5f * x * (1.f + copysignf(e, x));
}

// gelu(x), and gelu'(x) = Phi(x) + x phi(x) into `grad`: the erf's
// exp(-z^2) = exp(-x^2 / 2) is phi's too, so one exponential serves both.
__device__ __forceinline__ float gelu_erf_with_grad(float x, float& grad) {
  const float z = fabsf(x) * 0.7071067811865476f;
  const float ex = __expf(-z * z);
  const float cdf = 0.5f * (1.f + copysignf(1.f - erf_tail(z) * ex, x));
  grad = fmaf(x * 0.3989422804014327f, ex, cdf);
  return x * cdf;
}

}  // namespace vk
