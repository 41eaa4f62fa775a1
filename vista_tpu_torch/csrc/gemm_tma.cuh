// The TMA + wgmma GEMM skeleton that vk_wgrad (csrc/ff_bwd.cu), vk_seg_gemm
// (csrc/qkv_bwd.cu), K3 linear_residual (csrc/linear_residual.cu),
// ff_bwd_dh (csrc/ff_bwd.cu) and K4's conv (csrc/gn_silu_conv3.cu) share: a persistent block of three warpgroups
// walks work items, each a 128-row fp32 output tile summed over a run of
// 64-deep stages that TMA brings into a ring of shared-memory stages.
//
//   - The producer warpgroup gives its registers to the consumers
//     (setmaxnreg 40 vs 232); one of its threads keeps the ring full under
//     full/empty mbarriers, running on from one item into the next, so the
//     next item's loads overlap this item's epilogue.
//   - Two consumer warpgroups own 64 output rows each. The accumulator type
//     says which products one 16-deep slice issues: TgAcc holds a 64 x 320
//     tile as one m64n256 and one m64n64 product, both operands read from
//     shared memory (SS). 320 = 5 x 64 tiles every UNet width (320, 640,
//     1280) without a ragged column tile.
//   - A stage is 128B-swizzled 64 x 64 bf16 boxes (8 KB each): A, the two
//     warpgroups' 64 output rows x 64 of depth, at 0 and 8 KB; then B from
//     16 KB. B is read as stored, either way round:
//       MN-major: box q holds 64 of depth x output columns 64 q .. 64 q + 63
//       (a box of a row-major (depth, columns) tensor), read through
//       desc_sw128_mn with the transpose bit;
//       K-major: box q holds output columns 64 q .. 64 q + 63 x 64 of depth
//       (a box of a (columns, depth) weight in Linear layout); boxes 0-3 are
//       then one 256-row K-major tile that m64n256 reads through one
//       desc_sw128 (SBO 1024 B), and m64n64 reads box 4, as K2 reads W.
//     A is MN-major in vk_wgrad (a box of token rows of an activation) and
//     K-major in vk_seg_gemm, K3, ff_bwd_dh and K4's conv.
//   - Out-of-range rows, columns and depth arrive from TMA as zeros, so the
//     ragged edges need no masks in the main loop; the epilogue drops what
//     lies outside the output.
//
// vk_wgrad and vk_seg_gemm: 4 stages of 56 KB + barriers, 225 KB (dynamic,
// opt-in; vk_wgrad 2 KB more, a block of ones for its bias gradient). 384
// threads, one block per SM. The other kernels choose their
// own ring depth and stage size and keep the rest of the block's shared
// memory for their epilogue staging.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace vk {

constexpr int TG_BM = 128, TG_BN = 320, TG_BK = 64, TG_STAGES = 4;
constexpr int TG_CONSUMER_WARPS = 8;
constexpr int TG_THREADS = TG_CONSUMER_WARPS * 32 + 128;
constexpr int TG_BOX_BYTES = 64 * 64 * 2;
constexpr int TG_A_BYTES = 2 * TG_BOX_BYTES;
constexpr int TG_STAGE_BYTES = TG_A_BYTES + (TG_BN / 64) * TG_BOX_BYTES;
constexpr int TG_SMEM = 1024 + TG_STAGES * TG_STAGE_BYTES + 16 * TG_STAGES;

using TgRing = Ring<TG_STAGES>;

// Every thread calls it: a ring of STAGES stages of `stage_bytes` in dynamic
// shared memory (1024-aligned for the swizzle), then `extra` bytes for the
// caller (staging boxes), then the ring's barriers, initialised.
template <int STAGES = TG_STAGES>
__device__ __forceinline__ Ring<STAGES> tg_ring(uint8_t* smem_raw,
                                                uint32_t stage_bytes = TG_STAGE_BYTES,
                                                uint32_t extra = 0) {
  const uint32_t raw = smem_u32(smem_raw);
  Ring<STAGES> r;
  r.base = (raw + 1023) & ~1023u;
  r.bytes = stage_bytes;
  r.full0 = r.base + STAGES * stage_bytes + extra;
  r.empty0 = r.full0 + 8 * STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(r.full0 + 8 * s, 1);
      mbar_init(r.empty0 + 8 * s, TG_CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  return r;
}

// Producer: waits for the stage to be free and arms its full barrier for
// the `bytes` of boxes that the caller then loads.
template <int STAGES>
__device__ __forceinline__ void tg_acquire(const Ring<STAGES>& r,
                                           uint32_t bytes = TG_STAGE_BYTES) {
  mbar_wait(r.empty(), r.phase ^ 1);
  mbar_arrive_expect_tx(r.full(), bytes);
}

// Descriptor of the 16-deep slice kk of a 128B-swizzled operand at `addr`:
// MN-major (transpose bit set, 2048 B a slice) or K-major (32 B a slice).
template <bool MN>
__device__ __forceinline__ uint64_t tg_desc(uint32_t addr, int kk) {
  return MN ? desc_sw128_mn(addr + kk * 2048) : desc_sw128(addr) + 2 * kk;
}

// The 64 x 320 accumulator of one consumer warpgroup: columns 0..255 from
// B boxes 0-3, 256..319 from box 4.
struct TgAcc {
  float a[128];  // columns 0..255
  float b[32];   // columns 256..319

  template <bool A_MN, bool B_MN>
  __device__ __forceinline__ void mma(uint64_t da, uint32_t b_tile, int kk, int acc_in) {
    wgmma_m64n256k16_ss<A_MN ? 1 : 0, B_MN ? 1 : 0>(a, da, tg_desc<B_MN>(b_tile, kk), acc_in);
    wgmma_m64n64k16_ss<A_MN ? 1 : 0, B_MN ? 1 : 0>(
        b, da, tg_desc<B_MN>(b_tile + 4 * TG_BOX_BYTES, kk), acc_in);
  }
  __device__ __forceinline__ void fence() {
#pragma unroll
    for (int e = 0; e < 128; ++e) reg_fence(a[e]);
#pragma unroll
    for (int e = 0; e < 32; ++e) reg_fence(b[e]);
  }
};

// Consumer warpgroup `wg`: `stages` stages of products into `acc` (which
// starts from zero), each stage handed back to the producer once its
// products are done. A stage holds A at 0 (warpgroup wg's box at 8 KB x wg)
// and B from TG_A_BYTES; `acc.mma` issues one 16-deep slice.
template <bool A_MN, bool B_MN, class Acc, int STAGES>
__device__ __forceinline__ void tg_mainloop(Ring<STAGES>& r, Acc& acc, int stages, int wg,
                                            int lane) {
  uint32_t done = 0;  // the empty barrier of the stage whose products are in flight
  for (int i = 0; i < stages; ++i) {
    mbar_wait(r.full(), r.phase);
    const uint32_t a = r.tile() + wg * TG_BOX_BYTES, b = r.tile() + TG_A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TG_BK / 16; ++kk)
      acc.template mma<A_MN, B_MN>(tg_desc<A_MN>(a, kk), b, kk, (i | kk) != 0);
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done
    if (i > 0 && lane == 0) mbar_arrive(done);
    done = r.empty();
    r.advance();
  }
  wgmma_wait<0>();
  acc.fence();
  if (lane == 0) mbar_arrive(done);
}

// Accumulator pair p (0..39: 64-column box p / 8, column 8 (p % 8) + 2 t)
// of row half i, in the wgmma D layout (csrc/hopper.cuh). p and i are
// compile-time after unrolling, so this is a register.
__device__ __forceinline__ float2 tg_pair(const TgAcc& acc, int p, int i) {
  return p < 32 ? make_float2(acc.a[4 * p + 2 * i], acc.a[4 * p + 2 * i + 1])
                : make_float2(acc.b[4 * (p - 32) + 2 * i], acc.b[4 * (p - 32) + 2 * i + 1]);
}

// Hands each accumulator pair to store(row, col, v0, v1): row (0..127) and
// col (even, 0..318) within the tile, for columns col and col + 1. `acc` is a
// TgAcc, or an accumulator that begins with TgAcc's a[128] and b[32].
template <class Acc, class Store>
__device__ __forceinline__ void tg_epilogue(const Acc& acc, int wg, int warp_in_wg, int lane,
                                            const Store& store) {
  const int row = 64 * wg + 16 * warp_in_wg + (lane >> 2), col = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 32; ++j)
      store(row + 8 * i, 8 * j + col, acc.a[4 * j + 2 * i], acc.a[4 * j + 2 * i + 1]);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      store(row + 8 * i, 256 + 8 * j + col, acc.b[4 * j + 2 * i], acc.b[4 * j + 2 * i + 1]);
  }
}

static inline int tg_sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

}  // namespace vk
