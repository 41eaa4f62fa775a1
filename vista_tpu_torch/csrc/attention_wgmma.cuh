// The pieces that the TMA + wgmma attention kernels share: the forward
// (csrc/attention.cu, attention_wgmma_kernel) and the backward's dK/dV and
// dQ kernels (csrc/attention_bwd.cu). Head width 64: one head of a packed
// (B, rows, H*64) bf16 tensor is a 128-byte row, so a tile of rows is one
// 128B-swizzled TMA box (csrc/hopper.cuh).
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace vk {

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A (64 x 128) fp32 accumulator as the bf16 A fragments of a product over
// its 128 columns: slice kk holds columns 16 kk .. 16 kk + 15.
__device__ __forceinline__ void acc_to_frags(const float (&a)[64], uint32_t (&f)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    f[kk][0] = pack_bf16(a[8 * kk], a[8 * kk + 1]);
    f[kk][1] = pack_bf16(a[8 * kk + 2], a[8 * kk + 3]);
    f[kk][2] = pack_bf16(a[8 * kk + 4], a[8 * kk + 5]);
    f[kk][3] = pack_bf16(a[8 * kk + 6], a[8 * kk + 7]);
  }
}

// d (64 x 128) = a (64 x 64) b^T (128 x 64): both 128B-swizzled, K-major.
__device__ __forceinline__ void wb_scores(float (&d)[64], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n128k16_ss<0, 0>(d, desc_sw128(a) + 2 * kk, desc_sw128(b) + 2 * kk, kk);
}

// d (64 x 64) += f (64 x 128, A fragments) b (128 x 64, MN-major as stored).
__device__ __forceinline__ void wb_accumulate(float (&d)[32], const uint32_t (&f)[8][4],
                                              uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma_m64n64k16_rs<1>(d, f[kk], desc_sw128_mn(b + kk * 2048), 1);
}

}  // namespace vk

// 3-d map of a packed (B, rows, H*64) bf16 tensor in boxes of 64 columns
// (one head) x `box_rows` rows of one batch row; rows past the end arrive
// as zeros on a load and are dropped on a store.
static inline bool attn_map(CUtensorMap* map, const void* p, int rows, int B, int H,
                            int box_rows) {
  const uint64_t dims[3] = {(uint64_t)H * 64, (uint64_t)rows, (uint64_t)B};
  const uint64_t strides[2] = {(uint64_t)H * 64 * 2, (uint64_t)rows * H * 64 * 2};
  const uint32_t box[3] = {64u, (uint32_t)box_rows, 1u};
  return vk::make_tmap_bf16(map, p, 3, dims, strides, box);
}
