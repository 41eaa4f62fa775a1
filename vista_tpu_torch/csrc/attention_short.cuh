// The short-sequence route of K1's forward (csrc/attention.cu,
// attention_short_kernel) and of attention_bwd (csrc/attention_bwd.cu,
// attn_bwd_short_kernel): at most 64 queries and 64 keys, which is the
// temporal t = 25 attention at every level and the 45-key mid site of
// 320x576. Head width 64; q, k, v, o, dO are packed (B, S, H*64) bf16.
//
// The work is all bytes: at (18432, 25, 5x64) the products take 0.015 ms on
// the tensor cores against 0.352 ms for the bytes, so the design's job is to
// keep HBM busy, and the layout serves that:
//   - A box is one head of 64 / SB whole sequences of SB = 32 (S <= 32) or
//     64 frames, 64 rows of 128 bytes, loaded by TMA through a 3-d map over
//     (H*64, S, B) with the 128-byte swizzle. Rows S..SB-1 of a sequence and
//     sequences past B arrive as zeros without crossing HBM, so the padding
//     of t = 25 to 32 costs no bytes and a box never reads the next
//     sequence's rows.
//   - A persistent grid (SH_BLOCKS_PER_SM blocks per SM) walks the units
//     (group of 64 / SB sequences, head), head fastest: block i takes units
//     i, i + grid, ..., so the blocks running side by side sweep each
//     640-to-2560-byte row of q, k, v whole while it is in L2.
//   - One producer warp keeps a ring of stages full (full and empty
//     mbarriers); a stage holds one unit's boxes, so the next units' loads
//     run under this one's products and stores.
//   - Four consumer warps own 16 rows of the box each: warp w takes rows
//     16 w .. 16 w + 15, i.e. rows r0 = 16 w % SB .. r0 + 15 of sequence
//     j = 16 w / SB. Every score row is whole in one warp (at most 64 keys),
//     so the softmax needs no online rescaling and no other warp.
//   - Products are mma.sync m16n8k16 (bf16 in, fp32 accumulate) on ldmatrix
//     fragments read straight from the swizzled boxes. They are a few
//     percent of the time, and mma.sync lets each warp own one sequence's
//     rows; wgmma takes 64-row tiles, which would pack two t = 25 sequences
//     into one tile behind a block-diagonal mask and tie four warps together.
//   - Outputs leave by TMA stores of 16-row boxes, one per warp, whose rows
//     past S and sequences past B are dropped.
#pragma once

#include "attention_wgmma.cuh"

namespace vk {

constexpr int SH_ROWS = 64;             // rows of a box: 64 / SB sequences of SB frames
constexpr int SH_BOX = SH_ROWS * 128;   // one tensor's box for one head, 8 KB
constexpr int SH_WARPS = 4;             // consumer warps, 16 rows of the box each
constexpr int SH_THREADS = SH_WARPS * 32 + 32;  // and one producer warp
constexpr int SH_BLOCKS_PER_SM = 2;
constexpr int SH_OUT_BOX = 16 * 128;    // one warp's output box: 16 rows
// forward: a ring of (Q, K, V) stages and a staging box per warp for O
constexpr int SH_FWD_STAGES = 4;
constexpr int SH_FWD_STAGE = 3 * SH_BOX;
constexpr int SH_FWD_SMEM = 1024 + SH_FWD_STAGES * SH_FWD_STAGE + SH_WARPS * SH_OUT_BOX +
                            8 * 2 * SH_FWD_STAGES;
// backward: a ring of (Q, K, V, O, dO) stages; P and dS of one unit in bf16,
// rows of SB + 8 values (a 16-byte pad: ldmatrix without bank conflicts),
// room for SB = 64
constexpr int SH_BWD_STAGES = 2;
constexpr int SH_BWD_STAGE = 5 * SH_BOX;
constexpr int SH_BWD_PDS = 2 * SH_ROWS * (64 + 8) * 2;
constexpr int SH_BWD_SMEM = 1024 + SH_BWD_STAGES * SH_BWD_STAGE + SH_BWD_PDS +
                            8 * 2 * SH_BWD_STAGES;

// Frames of a box for s queries and keys (at most 64).
__host__ __device__ constexpr int sh_frames(int s) { return s > 32 ? 64 : 32; }

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The mma.sync A fragments of rows R0 .. R0 + 15 of a swizzled box (64
// columns: four k-steps of 16).
__device__ __forceinline__ void sh_a_frags(uint32_t box, int R0, uint32_t (&f)[4][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    ldmatrix_x4(box + sw128(R0 + (lane & 15), 2 * ks + (lane >> 4)), f[ks]);
}

// acc (16 x SB) += A (16 x 64, fragments) T^T, T the rows J0 .. J0 + SB - 1
// of a swizzled box (one sequence's keys x 64 dims): n-tile nt holds keys
// 8 nt .. 8 nt + 7.
template <int SB>
__device__ __forceinline__ void sh_scores(float (&acc)[SB / 8][4], const uint32_t (&a)[4][4],
                                          uint32_t box, int J0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < SB / 8; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t b[4];
      ldmatrix_x4(box + sw128(J0 + 8 * nt + (lane & 7), 4 * half + (lane >> 3)), b);
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      mma_16816(acc[nt], a[2 * half], b0);
      mma_16816(acc[nt], a[2 * half + 1], b1);
    }
}

// acc (16 x 64) += A (16 x SB, bf16 fragments: k-step kk holds columns
// 16 kk ..) T, T the rows J0 .. J0 + SB - 1 of a swizzled box read
// transposed (the depth runs along the box's rows).
template <int SB>
__device__ __forceinline__ void sh_accumulate(float (&acc)[8][4], const uint32_t (&a)[SB / 16][4],
                                              uint32_t box, int J0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < SB / 16; ++kk)
#pragma unroll
    for (int dp = 0; dp < 4; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(box + sw128(J0 + 16 * kk + (lane & 15), 2 * dp + (lane >> 4)), b);
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      mma_16816(acc[2 * dp], a[kk], b0);
      mma_16816(acc[2 * dp + 1], a[kk], b1);
    }
}

// An fp32 accumulator (16 x 2 KT) as the bf16 A fragments of a product over
// its columns.
template <int KT>
__device__ __forceinline__ void sh_pack(const float (&c)[2 * KT][4], uint32_t (&a)[KT][4]) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// The A fragments of T^T (16 x SB), T stored row-major in bf16 with a row
// stride of `stride` bytes: T's rows Q0 .. Q0 + SB - 1 are the depth, its
// columns K0 .. K0 + 15 the fragment's rows.
template <int SB>
__device__ __forceinline__ void sh_at_frags(uint32_t base, int stride, int Q0, int K0,
                                            uint32_t (&a)[SB / 16][4]) {
  const int lane = threadIdx.x & 31, mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < SB / 16; ++kk)
    ldmatrix_x4_trans(base + (Q0 + 16 * kk + (mi >> 1) * 8 + (lane & 7)) * stride +
                          (K0 + (mi & 1) * 8) * 2,
                      a[kk]);
}

// acc (16 x 64) times mul[u] (row g + 8 u) as bf16 into rows R0 .. R0 + 15
// of a swizzled box, as a TMA store reads it.
__device__ __forceinline__ void sh_store_rows(uint8_t* box, int R0, const float (&acc)[8][4],
                                              const float (&mul)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
      *reinterpret_cast<uint32_t*>(box + sw128(R0 + g + 8 * u, dt) + 4 * t) =
          pack_bf16(acc[dt][2 * u] * mul[u], acc[dt][2 * u + 1] * mul[u]);
}

}  // namespace vk

// 3-d map of a packed (B, rows, H*64) bf16 tensor in boxes of one head x
// `box_rows` rows x `box_seqs` sequences.
static inline bool short_map(CUtensorMap* map, const void* p, int rows, int B, int H,
                             int box_rows, int box_seqs) {
  const uint64_t dims[3] = {(uint64_t)H * 64, (uint64_t)rows, (uint64_t)B};
  const uint64_t strides[2] = {(uint64_t)H * 64 * 2, (uint64_t)rows * H * 64 * 2};
  const uint32_t box[3] = {64u, (uint32_t)box_rows, (uint32_t)box_seqs};
  return vk::make_tmap_bf16(map, p, 3, dims, strides, box);
}
