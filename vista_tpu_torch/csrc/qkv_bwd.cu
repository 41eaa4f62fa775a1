// seg_gemm: out (M, N) = sum over s of A_s (M, Kseg) W[s Kseg:(s+1) Kseg, :],
// fp32 accumulation, stored in fp32 or bf16. The K loop walks the segments
// A_0, A_1, ... (a (segs, M, Kseg) tensor) as one reduction of depth
// segs * Kseg, against the weight W (segs * Kseg, N) as stored.
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
// between kernels shared with csrc/ff_bwd.cu: xn recomputed and dx, dgamma,
// dbeta computed by csrc/layer_norm.cu (vk_layer_norm, vk_ln_bwd), dW =
// g_i^T xn by the split-K vk_wgrad, whose launch also adds its fp32 partials
// in a fixed order. Every sum is taken in an order fixed by the launch:
// deterministic.
//
// Bound on the H100 (c = inner at every UNet width): dxn is 2 * M * 3c * c
// operations against M * (3c * 2 + c * 4) bytes, 0.6 c operations per byte;
// do is 2 * M * c * c against M * 4c bytes, c / 2 per byte. Against the
// card's 295 operations per byte both are byte-bound at c = 320 and
// tensor-core bound from c = 640.
//
// Design: the TMA + wgmma skeleton of csrc/gemm_tma.cuh (128 x 320 tiles,
// persistent, the ring running on across tiles, n fastest so that the tiles
// in flight share their rows of g in L2). A is K-major: a 3-d TMA box of 64
// depth x 128 rows of segment s; B is W as stored, MN-major for this
// product (the output column contiguous), read with the transpose bit: no
// transposed copy of W. A depth chunk that runs past a segment's end
// (Kseg % 64 != 0) reads zeros from A there, so W's rows of the next
// segment add nothing. The epilogue stores each accumulator pair straight
// from registers (8 bytes fp32 or 4 bytes bf16 a thread; the four threads
// of a row cover 32 or 16 contiguous bytes): a 128 x 320 fp32 tile would
// need 160 KB of staging for TMA stores, which the 4-stage ring leaves no
// room for.
#include "gemm_tma.cuh"

namespace vk {

template <bool F32_OUT>
__global__ void __launch_bounds__(TG_THREADS, 1)
seg_gemm_tma_kernel(__grid_constant__ const CUtensorMap tm_a,
                    __grid_constant__ const CUtensorMap tm_w, void* __restrict__ out, int M,
                    int Kseg, int segs, int N) {
  extern __shared__ uint8_t smem_raw[];
  TgRing ring = tg_ring(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tn = (N + TG_BN - 1) / TG_BN, items = (M + TG_BM - 1) / TG_BM * tn;
  const int chunks = (Kseg + TG_BK - 1) / TG_BK;  // per segment

  if (warp >= TG_CONSUMER_WARPS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (warp == TG_CONSUMER_WARPS && lane == 0) {
      tma_prefetch_map(&tm_a);
      tma_prefetch_map(&tm_w);
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int m0 = item / tn * TG_BM, n0 = item % tn * TG_BN;
        for (int s = 0; s < segs; ++s)
          for (int c = 0; c < chunks; ++c) {
            tg_acquire(ring);
            const uint32_t dst = ring.tile();
            tma_load_3d(dst, &tm_a, ring.full(), c * TG_BK, m0, s);
#pragma unroll
            for (int q = 0; q < TG_BN / 64; ++q)
              tma_load_2d(dst + TG_A_BYTES + q * TG_BOX_BYTES, &tm_w, ring.full(), n0 + 64 * q,
                          s * Kseg + c * TG_BK);
            ring.advance();
          }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = warp >> 2;
    TgAcc acc;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int m0 = item / tn * TG_BM, n0 = item % tn * TG_BN;
      tg_mainloop<false, true>(ring, acc, segs * chunks, wg, lane);
      tg_epilogue(acc, wg, warp & 3, lane, [&](int r, int c, float v0, float v1) {
        const int m = m0 + r, n = n0 + c;
        if (m >= M || n >= N) return;
        const size_t o = (size_t)m * N + n;
        if (F32_OUT)
          *reinterpret_cast<float2*>(static_cast<float*>(out) + o) = make_float2(v0, v1);
        else
          *reinterpret_cast<uint32_t*>(static_cast<bf16*>(out) + o) = pack_bf16(v0, v1);
      });
    }
  }
}

}  // namespace vk

// a (segs, M, Kseg) bf16; w (segs * Kseg, N) bf16, the weight as stored;
// out (M, N), fp32 when out_f32 else bf16. Kseg, N % 8 == 0; a, w and out
// 16-byte aligned.
extern "C" int vk_seg_gemm(const void* a, const void* w, void* out, int M, int Kseg, int segs,
                           int N, int out_f32, void* stream) {
  using namespace vk;
  if (M <= 0 || segs <= 0 || Kseg % 8 || N % 8 ||
      ((uintptr_t)a | (uintptr_t)w | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_a, tm_w;
  const uint64_t a_dims[3] = {(uint64_t)Kseg, (uint64_t)M, (uint64_t)segs};
  const uint64_t a_strides[2] = {(uint64_t)Kseg * 2, (uint64_t)M * Kseg * 2};
  const uint32_t a_box[3] = {TG_BK, TG_BM, 1};
  const uint64_t w_dims[2] = {(uint64_t)N, (uint64_t)segs * Kseg};
  const uint64_t w_strides[1] = {(uint64_t)N * 2};
  const uint32_t w_box[2] = {64, TG_BK};
  if (!make_tmap_bf16(&tm_a, a, 3, a_dims, a_strides, a_box) ||
      !make_tmap_bf16(&tm_w, w, 2, w_dims, w_strides, w_box))
    return (int)cudaErrorInvalidValue;
  const long items = (long)((M + TG_BM - 1) / TG_BM) * ((N + TG_BN - 1) / TG_BN);
  const int grid = (int)(items < tg_sm_count() ? items : tg_sm_count());
  auto kernel = out_f32 ? seg_gemm_tma_kernel<true> : seg_gemm_tma_kernel<false>;
  if (cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            TG_SMEM))
    return (int)e;
  kernel<<<grid, TG_THREADS, TG_SMEM, (cudaStream_t)stream>>>(tm_a, tm_w, out, M, Kseg, segs, N);
  return (int)cudaGetLastError();
}
