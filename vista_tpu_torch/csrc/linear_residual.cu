// K3 linear_residual: out = residual + A * W^T + bias, with the bias and
// residual added to the fp32 accumulator and one rounding to bf16.
//
// Replaces, from the JAX package:
//   - vista_tpu/ops/fused_ff.py _ff_kernel, second half (proj_out + bias +
//     fp32 residual);
//   - vista_tpu/ops/fused_temporal_attn.py _kernel, the out-projection +
//     bias + residual;
//   - and serves ``o @ wo + bo + x`` of pre_ln_self_attention
//     (vista_tpu/models/attention.py), which the JAX package left to XLA.
//
// Bound on the H100: FF-out (K = 4c) is bound by the tensor cores at every
// UNet width (2 M 4c c operations against M (4c + 2c) x 2 bytes); attn-out
// and temporal-out (K = c) are bound by bytes at c = 320 (A, residual and
// output are 6 M c bytes for 2 M c^2 operations) and close to balanced at
// 640 and 1280. The epilogue fusion saves a read and a write of the (M, c)
// activation against a GEMM followed by an add.
//
// Design: the TMA + wgmma skeleton of csrc/gemm_tma.cuh with both operands
// K-major as stored (A (M, K) rows, W (N, K) in Linear layout):
//   - A persistent block walks 128 x 320 output tiles row panel by row
//     panel (the column tile fastest), so the blocks in flight share a few
//     panels of A in L2 and A comes from HBM about once; W stays in L2.
//     N = c is 1, 2 or 4 column tiles, none ragged at a UNet width.
//   - The ring has K3_STAGES stages of seven 8 KB boxes: A as one 64-deep x
//     128-row box, W as five boxes of 64 output columns x 64 of depth (the
//     skeleton's K-major B). K / 64 stages an item: 5 at attn-out c = 320,
//     80 at FF-out c = 1280.
//   - Epilogue: each consumer warpgroup stages 64-column boxes of its 64
//     rows in K3_STG_BOXES buffers of 8 KB (128B-swizzled, as TMA writes
//     them). One of its threads loads the residual boxes with TMA, the first
//     K3_STG_BOXES of an item before its main loop (they arrive under the
//     products); each thread adds bias and residual to its accumulator pairs
//     and writes the bf16 result in place, and the thread stores the box
//     with TMA and loads the next residual box into the buffer once the
//     store has read it. No scattered 4-byte global access. The producer
//     runs on into the next item's stages meanwhile, so at K = c the next
//     item's A loads overlap this item's epilogue.
//   - Shared memory: 3 x 56 KB ring + 2 x 3 x 8 KB staging + barriers, 217
//     KB (dynamic, opt-in). A fourth stage (224 KB) would leave no room for
//     staging; a whole 128 x 320 residual tile is 80 KB.
//   - No split-K: every output is summed in one fixed order, so the result
//     is bit-identical over launches.
// Ragged M, N and K need no masks: TMA fills zeros past the tensor's ends
// and drops stores past them (N % 8 == 0 and K % 8 == 0 for TMA's 16-byte
// row strides).
#include "gemm_tma.cuh"

namespace vk {

constexpr int K3_STAGES = 3;
constexpr int K3_STG_BOXES = 3;  // residual/output boxes per consumer warpgroup
constexpr int K3_BOXES = TG_BN / 64;  // 64-column boxes in an output tile
constexpr int K3_STG_BYTES = 2 * K3_STG_BOXES * TG_BOX_BYTES;
constexpr int K3_SMEM =
    1024 + K3_STAGES * TG_STAGE_BYTES + K3_STG_BYTES + 16 * K3_STAGES + 8 * 2 * K3_STG_BOXES;

__global__ void __launch_bounds__(TG_THREADS, 1)
linear_residual_tma_kernel(__grid_constant__ const CUtensorMap tm_a,
                           __grid_constant__ const CUtensorMap tm_w,
                           __grid_constant__ const CUtensorMap tm_res,
                           __grid_constant__ const CUtensorMap tm_out,
                           const float* __restrict__ bias, int M, int K, int N) {
  extern __shared__ uint8_t smem_raw[];
  // ring | staging (warpgroup 0's boxes, then 1's) | ring barriers | residual barriers
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t stg0 = ((raw + 1023) & ~1023u) + K3_STAGES * TG_STAGE_BYTES;
  const uint32_t rbar0 = stg0 + K3_STG_BYTES + 16 * K3_STAGES;
  if (threadIdx.x == 0)
    for (int b = 0; b < 2 * K3_STG_BOXES; ++b) mbar_init(rbar0 + 8 * b, 1);
  Ring<K3_STAGES> ring = tg_ring<K3_STAGES>(smem_raw, TG_STAGE_BYTES, K3_STG_BYTES);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tn = (N + TG_BN - 1) / TG_BN, items = (M + TG_BM - 1) / TG_BM * tn;
  const int stages = (K + TG_BK - 1) / TG_BK;

  if (warp >= TG_CONSUMER_WARPS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (warp == TG_CONSUMER_WARPS && lane == 0) {
      tma_prefetch_map(&tm_a);
      tma_prefetch_map(&tm_w);
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int m0 = item / tn * TG_BM, n0 = item % tn * TG_BN;
        for (int i = 0; i < stages; ++i) {
          tg_acquire(ring);
          const uint32_t dst = ring.tile();
          tma_load_2d(dst, &tm_a, ring.full(), i * TG_BK, m0);
#pragma unroll
          for (int q = 0; q < K3_BOXES; ++q)
            tma_load_2d(dst + TG_A_BYTES + q * TG_BOX_BYTES, &tm_w, ring.full(), i * TG_BK,
                        n0 + 64 * q);
          ring.advance();
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = warp >> 2, row = 16 * (warp & 3) + (lane >> 2), t = lane & 3;
    const bool leader = (threadIdx.x & 127) == 0;  // loads and stores the warpgroup's boxes
    const uint32_t stg = stg0 + wg * K3_STG_BOXES * TG_BOX_BYTES;
    uint8_t* stg_ptr = smem_raw + (stg - raw);
    const uint32_t rbar = rbar0 + 8 * wg * K3_STG_BOXES;
    uint32_t seq = 0;  // residual boxes this warpgroup has loaded so far
    if (leader) tma_prefetch_map(&tm_res);
    TgAcc acc;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int m0 = item / tn * TG_BM, n0 = item % tn * TG_BN;
      const int r0 = m0 + 64 * wg;
      const int nb = min(K3_BOXES, (N - n0 + 63) / 64);  // boxes inside the output
      // box j of this item goes through buffer (seq + j) % K3_STG_BOXES
      auto load_residual = [&](int j) {
        const uint32_t b = (seq + j) % K3_STG_BOXES;
        mbar_arrive_expect_tx(rbar + 8 * b, TG_BOX_BYTES);
        tma_load_2d(stg + b * TG_BOX_BYTES, &tm_res, rbar + 8 * b, n0 + 64 * j, r0);
      };
      if (leader) {
        bulk_wait_read<0>();  // the previous item's stores have read the buffers
        for (int j = 0; j < min(nb, K3_STG_BOXES); ++j) load_residual(j);
      }
      tg_mainloop<false, false>(ring, acc, stages, wg, lane);
#pragma unroll
      for (int j = 0; j < K3_BOXES; ++j) {
        if (j >= nb) break;
        const uint32_t b = (seq + j) % K3_STG_BOXES;
        mbar_wait(rbar + 8 * b, ((seq + j) / K3_STG_BOXES) & 1);
        uint8_t* box = stg_ptr + b * TG_BOX_BYTES;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int n = n0 + 64 * j + 8 * jj + 2 * t;
          const float2 bb =
              n < N ? *reinterpret_cast<const float2*>(bias + n) : make_float2(0.f, 0.f);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            uint32_t* p = reinterpret_cast<uint32_t*>(box + sw128(row + 8 * i, jj) + 4 * t);
            const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
            const float2 v = tg_pair(acc, 8 * j + jj, i);
            *p = pack_bf16(v.x + bb.x + r.x, v.y + bb.y + r.y);
          }
        }
        fence_async_smem();
        bar_named(1 + wg, 128);
        if (leader) {
          tma_store_2d(&tm_out, stg + b * TG_BOX_BYTES, n0 + 64 * j, r0);
          bulk_commit();
          if (j + K3_STG_BOXES < nb) {
            bulk_wait_read<0>();  // the store has read the buffer
            load_residual(j + K3_STG_BOXES);
          }
        }
      }
      seq += nb;
    }
    if (leader) bulk_wait<0>();
  }
}

}  // namespace vk

// a (M, K) bf16, w (N, K) bf16, bias (N) fp32, res and out (M, N) bf16, on
// `grid` persistent blocks (ops/linear.py linear_residual_plan). K % 8 == 0,
// N % 8 == 0; a, w, res and out 16-byte aligned.
extern "C" int vk_linear_residual(const void* a, const void* w, const void* bias,
                                  const void* res, void* out, int M, int K, int N, int grid,
                                  void* stream) {
  using namespace vk;
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 || N % 8 || grid <= 0 ||
      ((uintptr_t)a | (uintptr_t)w | (uintptr_t)res | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_a, tm_w, tm_res, tm_out;
  const uint64_t a_dims[2] = {(uint64_t)K, (uint64_t)M};
  const uint64_t a_strides[1] = {(uint64_t)K * 2};
  const uint32_t a_box[2] = {TG_BK, TG_BM};
  const uint64_t w_dims[2] = {(uint64_t)K, (uint64_t)N};
  const uint64_t w_strides[1] = {(uint64_t)K * 2};
  const uint32_t w_box[2] = {TG_BK, 64};
  const uint64_t o_dims[2] = {(uint64_t)N, (uint64_t)M};
  const uint64_t o_strides[1] = {(uint64_t)N * 2};
  const uint32_t o_box[2] = {64, 64};
  if (!make_tmap_bf16(&tm_a, a, 2, a_dims, a_strides, a_box) ||
      !make_tmap_bf16(&tm_w, w, 2, w_dims, w_strides, w_box) ||
      !make_tmap_bf16(&tm_res, res, 2, o_dims, o_strides, o_box) ||
      !make_tmap_bf16(&tm_out, out, 2, o_dims, o_strides, o_box))
    return (int)cudaErrorInvalidValue;
  if (cudaError_t e = cudaFuncSetAttribute(linear_residual_tma_kernel,
                                            cudaFuncAttributeMaxDynamicSharedMemorySize, K3_SMEM))
    return (int)e;
  linear_residual_tma_kernel<<<grid, TG_THREADS, K3_SMEM, (cudaStream_t)stream>>>(
      tm_a, tm_w, tm_res, tm_out, (const float*)bias, M, K, N);
  return (int)cudaGetLastError();
}
