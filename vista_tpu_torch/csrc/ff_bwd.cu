// ff_bwd: the gradient of the pre-LN GEGLU feed-forward
//   y = x + proj_out(a * gelu(g)) + b2,   [a | g] = LN(x) W1^T + b1
// (the function of K2's GEGLU epilogue followed by K3), with erf GELU.
//
// Replaces, from the JAX package, vista_tpu/ops/fused_ff.py _ff_bwd_kernel
// (_ff_bwd_pallas, c <= 640: everything in one kernel with fp32 grid
// accumulators) and _ff_bwd_wide_kernel (_ff_bwd_wide, c > 640: exported
// activations, dW as plain matmuls). One design serves every width here:
//
//   0. xn = LN(x) in bf16 (csrc/layer_norm.cu, the caller launches it);
//   1. ff_bwd_dh: per (128 rows, 64 inner columns) tile, recompute
//      [a | g] = xn W1^T + b1 and dhg = dy W2, then hg = a * gelu(g),
//      da = dhg * gelu(g), dg = dhg * a * gelu'(g); writes hg (M, 4c) and
//      dH = [da | dg] (M, 8c), bf16. On the TMA + wgmma skeleton of
//      csrc/gemm_tma.cuh: the ring streams two runs of stages per tile,
//      (xn, the tile's W1 value and gate rows) read K-major through one 3-d
//      box over W1 seen as (2, 4c, c), as K2 reads it, then (dy, W2's
//      columns) with W2 (c, 4c) read as stored, MN-major. A consumer
//      warpgroup holds [a | g] (m64n128) and dhg (m64n64), 96 fp32 a
//      thread; a 128-column tile would need 192 and leave no room for the
//      epilogue's staging. The epilogue stages hg, da and dg as 64 x 64
//      boxes in shared memory and stores them with TMA, under the next
//      tile's products;
//   2. dxn = dH W1 (fp32, M x c), the product feeding the LN backward,
//      which needs whole rows: vk_seg_gemm of csrc/qkv_bwd.cu with one
//      segment (the caller launches it);
//   3. ln_bwd: dx = rstd (dxn*gamma - mean(dxn*gamma) - xhat
//      mean(dxn*gamma*xhat)) + dy (the residual), dgamma and dbeta, in one
//      launch (csrc/layer_norm.cu ln_bwd_kernel, the caller launches it);
//   4. wgrad: dW1 = dH^T xn with db1 = colsum(dH), and dW2 = dy^T hg with
//      db2 = colsum(dy), one launch each: the contraction over all M tokens
//      split into S ranges, TMA + wgmma on the skeleton of csrc/gemm_tma.cuh,
//      the operands read as stored (both MN-major). The bias gradient is
//      the column sum of the A operand, which the ring already brings into
//      shared memory: the products sum it there, against a column of ones
//      beside B, so no byte of HBM is read for it. With S > 1 the items
//      write fp32 partials and, after a grid-wide barrier, every block
//      folds a slice of them in split order in the same launch, into dW in
//      the weight's dtype and db in fp32; with S = 1 the epilogue writes
//      them directly. The same launch serves qkv_bwd's dWq/dWk/dWv
//      (segments), K3's dWo and dbo, and conv3's tap products. Every
//      reduction is deterministic: no atomics.
//
// Bound on the H100: the products (2 * M * c * 8c for [a|g], 2 * M * c * 4c
// for dhg, 2 * M * 8c * c for dxn, 2 * M * c * 8c + 2 * M * c * 4c for the
// weight grads) make it tensor-core bound at every UNet width; dH
// (M x 8c bf16) is the one large intermediate in device memory.
#include <type_traits>

#include "common.cuh"
#include "gemm_tma.cuh"

namespace vk {

// 1. hg and dH. Ring stages of 32 KB: A (xn or dy, 128 rows x 64 of depth)
// at 0, then W1's 64 value and 64 gate rows of the tile (16 KB, K-major) or
// W2's 64 of depth x 64 columns (8 KB, MN-major).
constexpr int FB_NI = 64;  // inner columns of a tile
constexpr int FB_STAGES = 5;
constexpr int FB_W1_BYTES = 2 * FB_NI * TG_BK * 2;
constexpr int FB_W2_BYTES = FB_NI * TG_BK * 2;
constexpr int FB_STAGE_BYTES = TG_A_BYTES + FB_W1_BYTES;
constexpr int FB_STG_BYTES = 2 * 3 * TG_BOX_BYTES;  // hg, da and dg boxes of both warpgroups
constexpr int FB_SMEM = 1024 + FB_STAGES * FB_STAGE_BYTES + FB_STG_BYTES + 16 * FB_STAGES;
static_assert(FB_NI == 64, "one 64-column box per output of a tile");

struct FbGateAcc {  // [a | g], 64 x 128: value columns 0..63, gates 64..127
  float d[64];
  template <bool A_MN, bool B_MN>
  __device__ __forceinline__ void mma(uint64_t da, uint32_t b_tile, int kk, int acc_in) {
    wgmma_m64n128k16_ss<A_MN ? 1 : 0, B_MN ? 1 : 0>(d, da, tg_desc<B_MN>(b_tile, kk), acc_in);
  }
  __device__ __forceinline__ void fence() {
#pragma unroll
    for (int e = 0; e < 64; ++e) reg_fence(d[e]);
  }
};

struct FbDhgAcc {  // dhg, 64 x 64
  float d[32];
  template <bool A_MN, bool B_MN>
  __device__ __forceinline__ void mma(uint64_t da, uint32_t b_tile, int kk, int acc_in) {
    wgmma_m64n64k16_ss<A_MN ? 1 : 0, B_MN ? 1 : 0>(d, da, tg_desc<B_MN>(b_tile, kk), acc_in);
  }
  __device__ __forceinline__ void fence() {
#pragma unroll
    for (int e = 0; e < 32; ++e) reg_fence(d[e]);
  }
};

__global__ void __launch_bounds__(TG_THREADS, 1)
ff_bwd_dh_tma_kernel(__grid_constant__ const CUtensorMap tm_xn,
                     __grid_constant__ const CUtensorMap tm_dy,
                     __grid_constant__ const CUtensorMap tm_w1,
                     __grid_constant__ const CUtensorMap tm_w2,
                     __grid_constant__ const CUtensorMap tm_hg,
                     __grid_constant__ const CUtensorMap tm_dh, const float* __restrict__ b1,
                     int M, int C, int N) {
  extern __shared__ uint8_t smem_raw[];
  // ring | staging (warpgroup 0's three boxes, then 1's) | ring barriers
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t stg0 = ((raw + 1023) & ~1023u) + FB_STAGES * FB_STAGE_BYTES;
  Ring<FB_STAGES> ring = tg_ring<FB_STAGES>(smem_raw, FB_STAGE_BYTES, FB_STG_BYTES);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tn = N / FB_NI, items = (M + TG_BM - 1) / TG_BM * tn;
  const int stages = (C + TG_BK - 1) / TG_BK;  // per run

  if (warp >= TG_CONSUMER_WARPS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (warp == TG_CONSUMER_WARPS && lane == 0) {
      tma_prefetch_map(&tm_xn);
      tma_prefetch_map(&tm_dy);
      tma_prefetch_map(&tm_w1);
      tma_prefetch_map(&tm_w2);
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int m0 = item / tn * TG_BM, n0 = item % tn * FB_NI;
        for (int i = 0; i < stages; ++i) {
          tg_acquire(ring, TG_A_BYTES + FB_W1_BYTES);
          tma_load_2d(ring.tile(), &tm_xn, ring.full(), i * TG_BK, m0);
          tma_load_3d(ring.tile() + TG_A_BYTES, &tm_w1, ring.full(), i * TG_BK, n0, 0);
          ring.advance();
        }
        for (int i = 0; i < stages; ++i) {
          tg_acquire(ring, TG_A_BYTES + FB_W2_BYTES);
          tma_load_2d(ring.tile(), &tm_dy, ring.full(), i * TG_BK, m0);
          tma_load_2d(ring.tile() + TG_A_BYTES, &tm_w2, ring.full(), n0, i * TG_BK);
          ring.advance();
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = warp >> 2, row = 16 * (warp & 3) + (lane >> 2), t = lane & 3;
    const bool leader = (threadIdx.x & 127) == 0;  // stores the warpgroup's boxes
    const uint32_t stg = stg0 + wg * 3 * TG_BOX_BYTES;  // hg, da, dg
    uint8_t* stg_ptr = smem_raw + (stg - raw);
    if (leader) {
      tma_prefetch_map(&tm_hg);
      tma_prefetch_map(&tm_dh);
    }
    FbGateAcc ag;
    FbDhgAcc dd;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int m0 = item / tn * TG_BM, n0 = item % tn * FB_NI;
      tg_mainloop<false, false>(ring, ag, stages, wg, lane);
      tg_mainloop<false, true>(ring, dd, stages, wg, lane);
      if (leader) bulk_wait_read<0>();  // the previous tile's stores have read the boxes
      bar_named(1 + wg, 128);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int o = n0 + 8 * j + 2 * t;
        const float2 ba = *reinterpret_cast<const float2*>(b1 + o);
        const float2 bg = *reinterpret_cast<const float2*>(b1 + N + o);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float h[2], da[2], dg[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float a = ag.d[4 * j + 2 * i + e] + (e ? ba.y : ba.x);
            const float g = ag.d[4 * (j + 8) + 2 * i + e] + (e ? bg.y : bg.x);
            const float dhg = dd.d[4 * j + 2 * i + e];
            float gp;
            const float ge = gelu_erf_with_grad(g, gp);
            h[e] = a * ge;
            da[e] = dhg * ge;
            dg[e] = dhg * a * gp;
          }
          const uint32_t off = sw128(row + 8 * i, j) + 4 * t;
          *reinterpret_cast<uint32_t*>(stg_ptr + off) = pack_bf16(h[0], h[1]);
          *reinterpret_cast<uint32_t*>(stg_ptr + TG_BOX_BYTES + off) = pack_bf16(da[0], da[1]);
          *reinterpret_cast<uint32_t*>(stg_ptr + 2 * TG_BOX_BYTES + off) =
              pack_bf16(dg[0], dg[1]);
        }
      }
      fence_async_smem();
      bar_named(1 + wg, 128);
      if (leader) {
        const int r0 = m0 + 64 * wg;
        tma_store_2d(&tm_hg, stg, n0, r0);
        tma_store_2d(&tm_dh, stg + TG_BOX_BYTES, n0, r0);
        tma_store_2d(&tm_dh, stg + 2 * TG_BOX_BYTES, N + n0, r0);
        bulk_commit();
      }
    }
    if (leader) bulk_wait<0>();
  }
}

// 4. dW (segs * N1, N2): row s * N1 + n1 is the sum over all M tokens of
// A_s[m, n1] B[m, n2]; A (segs, M, N1) and B (M, N2) bf16, token-major. Both
// operands are MN-major for this product (the output index contiguous), so
// TMA loads boxes of 64 tokens x 64 columns as the activations are stored
// and wgmma reads both with the transpose bit set: no thread touches an
// operand on its way in. An item is one split of one 128 x 320 tile of one
// segment; the items of a split are adjacent, so the blocks in flight share
// its token range of B in L2. Splits start on a 64-token box
// (rows_per_split % 64 == 0): TMA zero-fills only past M, so a box must
// never reach into the next split.
//
// With db (the instance DB), db[s * N1 + n1] = sum over m of A_s[m, n1]
// comes out of the same products: each consumer warpgroup's 64-column
// product (B columns 256..319) is widened to 72 columns, and its last 8
// columns read, through the descriptor's LBO, a constant 16 x 8 block of
// bf16 ones behind the ring, so they hold A's column sums over the item's
// tokens in fp32. The A stage is not read again and no thread loads from
// shared memory (thread loads of the stages beside the wgmma reads slowed
// the products far more than their bytes); the products grow by 8 / 320.
// Items of column tile 0 write db, once per (split, segment, row tile).
//
// One split (splits == 1): the epilogue writes dW in its dtype and db, no
// partial. More: each item writes an fp32 partial row block, part[split] =
// (dW partial, segs * N1 * N2 | db partial, segs * N1), every block passes a
// grid-wide barrier after its last item (a cooperative launch), and then
// the consumer threads of each block fold an equal contiguous slice of the
// partials: 16-byte loads, WG_FOLD splits in flight, added in split order
// 0 .. splits - 1 from 0.f, so dW's bits depend on the split plan alone.
constexpr int WG_FOLD_THREADS = TG_CONSUMER_WARPS * 32;  // the consumer threads fold
constexpr int WG_FOLD = 8;                               // partials in flight a thread
constexpr int WG_ONES_BYTES = 2 * 1024;  // the ones block: 16 deep x 8, in two 8-row groups
// the ring, the ones and the barriers from a 1024-aligned base; the block
// asks for all the shared memory it may have, which leaves up to 960 bytes
// of the base's alignment (the kernel checks)
constexpr int WG_NEED = TG_STAGES * TG_STAGE_BYTES + WG_ONES_BYTES + 16 * TG_STAGES;
constexpr int WG_SMEM = 232448;
constexpr int WG_FOLD_BAR = 1;  // named barrier of the folding threads
static_assert(WG_NEED <= WG_SMEM, "one block an SM");

// TgAcc with its 64-column product widened to 72: b[32..35] are columns
// 320..327, the column sums (all eight equal).
struct WgDbAcc {
  float a[128];  // columns 0..255
  float b[36];   // columns 256..319, then the sums
  uint32_t ones;  // shared address of the ones block

  template <bool A_MN, bool B_MN>
  __device__ __forceinline__ void mma(uint64_t da, uint32_t b_tile, int kk, int acc_in) {
    static_assert(A_MN && B_MN, "vk_wgrad's operands are MN-major");
    wgmma_m64n256k16_ss<1, 1>(a, da, tg_desc<true>(b_tile, kk), acc_in);
    const uint32_t box4 = b_tile + 4 * TG_BOX_BYTES + kk * 2048;  // this slice of box 4
    wgmma_m64n72k16_ss<1, 1>(b, da, desc_sw128_mn(box4, ones - box4), acc_in);
  }
  __device__ __forceinline__ void fence() {
#pragma unroll
    for (int e = 0; e < 128; ++e) reg_fence(a[e]);
#pragma unroll
    for (int e = 0; e < 36; ++e) reg_fence(b[e]);
  }
};

template <bool DB>
__global__ void __launch_bounds__(TG_THREADS, 1)
wgrad_tma_kernel(__grid_constant__ const CUtensorMap tm_a,
                 __grid_constant__ const CUtensorMap tm_b, float* __restrict__ part,
                 void* __restrict__ dw, float* __restrict__ db, int* __restrict__ barrier,
                 int M, int N1, int N2, int segs, int splits, int rows_per_split, int dw_bf16) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw), base = (raw + 1023) & ~1023u;
  if (base - raw > WG_SMEM - WG_NEED) __trap();
  const uint32_t ones = base + TG_STAGES * TG_STAGE_BYTES;
  if (DB) {
    uint32_t* o = reinterpret_cast<uint32_t*>(smem_raw + (ones - raw));
    for (int i = threadIdx.x; i < WG_ONES_BYTES / 4; i += TG_THREADS) o[i] = 0x3F803F80u;
    fence_async_smem();  // the wgmma reads them through the async proxy
  }
  TgRing ring = tg_ring(smem_raw, TG_STAGE_BYTES, WG_ONES_BYTES);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t1 = (N1 + TG_BM - 1) / TG_BM, t2 = (N2 + TG_BN - 1) / TG_BN;
  const int per_split = segs * t1 * t2, items = splits * per_split;
  // one split's partial: dW's rows, then db's
  const long dw_len = (long)segs * N1 * N2, part_len = dw_len + (DB ? segs * N1 : 0);
  // item -> split, segment, row tile, column tile (the column tile fastest)
  auto decode = [&](int item, int& split, int& s, int& n10, int& n20) {
    split = item / per_split;
    int r = item - split * per_split;
    s = r / (t1 * t2);
    r -= s * t1 * t2;
    n10 = r / t2 * TG_BM;
    n20 = r % t2 * TG_BN;
  };
  auto token_stages = [&](int split) {
    const int m0 = split * rows_per_split;
    return (min(M, m0 + rows_per_split) - m0 + TG_BK - 1) / TG_BK;
  };

  if (warp >= TG_CONSUMER_WARPS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (warp == TG_CONSUMER_WARPS && lane == 0) {
      tma_prefetch_map(&tm_a);
      tma_prefetch_map(&tm_b);
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        int split, s, n10, n20;
        decode(item, split, s, n10, n20);
        const int stages = token_stages(split);
        for (int i = 0; i < stages; ++i) {
          const int m = split * rows_per_split + i * TG_BK;
          tg_acquire(ring);
          const uint32_t dst = ring.tile();
          tma_load_3d(dst, &tm_a, ring.full(), n10, m, s);
          tma_load_3d(dst + TG_BOX_BYTES, &tm_a, ring.full(), n10 + 64, m, s);
#pragma unroll
          for (int q = 0; q < TG_BN / 64; ++q)
            tma_load_2d(dst + TG_A_BYTES + q * TG_BOX_BYTES, &tm_b, ring.full(), n20 + 64 * q, m);
          ring.advance();
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = warp >> 2;
    std::conditional_t<DB, WgDbAcc, TgAcc> acc;
    if constexpr (DB) acc.ones = ones;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      int split, s, n10, n20;
      decode(item, split, s, n10, n20);
      tg_mainloop<true, true>(ring, acc, token_stages(split), wg, lane);
      float* dst = part + split * part_len;
      tg_epilogue(acc, wg, warp & 3, lane, [&](int r, int c, float v0, float v1) {
        const int n1 = n10 + r, n2 = n20 + c;
        if (n1 >= N1 || n2 >= N2) return;
        const long o = ((long)s * N1 + n1) * N2 + n2;
        if (splits > 1) {
          *reinterpret_cast<float2*>(dst + o) = make_float2(v0, v1);
        } else if (dw_bf16) {  // 0.f + v, as the fold adds one split, then the dtype
          *reinterpret_cast<uint32_t*>(static_cast<bf16*>(dw) + o) = pack_bf16(0.f + v0, 0.f + v1);
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(dw) + o) = make_float2(0.f + v0, 0.f + v1);
        }
      });
      if constexpr (DB) {
        // rows r and r + 8 of the warp's 16, from the lanes of column 320
        const int r = n10 + 64 * wg + 16 * (warp & 3) + (lane >> 2);
        float* d = (splits > 1 ? dst + dw_len : db) + (long)s * N1;
        if (n20 == 0 && (lane & 3) == 0) {
          if (r < N1) d[r] = acc.b[32];
          if (r + 8 < N1) d[r + 8] = acc.b[34];
        }
      }
    }
    if (splits == 1) return;
    bar_named(WG_FOLD_BAR, WG_FOLD_THREADS);  // every partial of this block is written
    if (threadIdx.x == 0) grid_barrier(barrier);
    bar_named(WG_FOLD_BAR, WG_FOLD_THREADS);  // ... and every block's
    // the fold: this block's slice of the partials' 16-byte quads
    const long quads = part_len / 4, per = (quads + gridDim.x - 1) / gridDim.x;
    const long q1 = min(quads, (blockIdx.x + 1) * per);
    const float4* src = reinterpret_cast<const float4*>(part);
    for (long q = blockIdx.x * per + threadIdx.x; q < q1; q += WG_FOLD_THREADS) {
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k0 = 0; k0 < splits; k0 += WG_FOLD) {
        float4 v[WG_FOLD];
#pragma unroll
        for (int u = 0; u < WG_FOLD; ++u)
          if (k0 + u < splits) v[u] = __ldcg(src + (k0 + u) * quads + q);
#pragma unroll
        for (int u = 0; u < WG_FOLD; ++u) {
          if (k0 + u >= splits) break;
          t.x += v[u].x;
          t.y += v[u].y;
          t.z += v[u].z;
          t.w += v[u].w;
        }
      }
      const long e = 4 * q;
      if (e >= dw_len) {
        *reinterpret_cast<float4*>(db + (e - dw_len)) = t;
      } else if (dw_bf16) {
        *reinterpret_cast<uint2*>(static_cast<bf16*>(dw) + e) =
            make_uint2(pack_bf16(t.x, t.y), pack_bf16(t.z, t.w));
      } else {
        *reinterpret_cast<float4*>(static_cast<float*>(dw) + e) = t;
      }
    }
  }
}

}  // namespace vk

using vk::bf16;

// 1. xn, dy (M, C) bf16; w1 (2N, C) bf16, [value; gate] rows; w2 (C, N) bf16
// as stored; b1 (2N) fp32 -> hg (M, N), dh (M, 2N) bf16, on `grid`
// persistent blocks (ops/fused_ff.py ff_bwd_dh_plan). C % 8 == 0,
// N % 64 == 0; every tensor 16-byte aligned.
extern "C" int vk_ff_bwd_dh(const void* xn, const void* dy, const void* w1, const void* w2,
                            const void* b1, void* hg, void* dh, int M, int C, int N, int grid,
                            void* stream) {
  using namespace vk;
  if (M <= 0 || C <= 0 || C % 8 || N <= 0 || N % FB_NI || grid <= 0 ||
      ((uintptr_t)xn | (uintptr_t)dy | (uintptr_t)w1 | (uintptr_t)w2 | (uintptr_t)hg |
       (uintptr_t)dh) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_xn, tm_dy, tm_w1, tm_w2, tm_hg, tm_dh;
  const uint64_t x_dims[2] = {(uint64_t)C, (uint64_t)M};
  const uint64_t x_strides[1] = {(uint64_t)C * 2};
  const uint32_t x_box[2] = {TG_BK, TG_BM};
  // W1 as (planes, rows, C): the value and gate rows of a tile in one box
  const uint64_t w1_dims[3] = {(uint64_t)C, (uint64_t)N, 2};
  const uint64_t w1_strides[2] = {(uint64_t)C * 2, (uint64_t)N * C * 2};
  const uint32_t w1_box[3] = {TG_BK, FB_NI, 2};
  const uint64_t w2_dims[2] = {(uint64_t)N, (uint64_t)C};
  const uint64_t w2_strides[1] = {(uint64_t)N * 2};
  const uint32_t w2_box[2] = {FB_NI, TG_BK};
  const uint64_t hg_dims[2] = {(uint64_t)N, (uint64_t)M};
  const uint64_t hg_strides[1] = {(uint64_t)N * 2};
  const uint64_t dh_dims[2] = {(uint64_t)2 * N, (uint64_t)M};
  const uint64_t dh_strides[1] = {(uint64_t)N * 4};
  const uint32_t o_box[2] = {64, 64};
  if (!make_tmap_bf16(&tm_xn, xn, 2, x_dims, x_strides, x_box) ||
      !make_tmap_bf16(&tm_dy, dy, 2, x_dims, x_strides, x_box) ||
      !make_tmap_bf16(&tm_w1, w1, 3, w1_dims, w1_strides, w1_box) ||
      !make_tmap_bf16(&tm_w2, w2, 2, w2_dims, w2_strides, w2_box) ||
      !make_tmap_bf16(&tm_hg, hg, 2, hg_dims, hg_strides, o_box) ||
      !make_tmap_bf16(&tm_dh, dh, 2, dh_dims, dh_strides, o_box))
    return (int)cudaErrorInvalidValue;
  if (cudaError_t e = cudaFuncSetAttribute(ff_bwd_dh_tma_kernel,
                                            cudaFuncAttributeMaxDynamicSharedMemorySize, FB_SMEM))
    return (int)e;
  ff_bwd_dh_tma_kernel<<<grid, TG_THREADS, FB_SMEM, (cudaStream_t)stream>>>(
      tm_xn, tm_dy, tm_w1, tm_w2, tm_hg, tm_dh, (const float*)b1, M, C, N);
  return (int)cudaGetLastError();
}

// 4. dw (segs * N1, N2) in fp32 or bf16 (dw_bf16) from a (segs, M, N1),
// b (M, N2) bf16, and with db (non-null) db (segs * N1) fp32 = a's column
// sums; on `grid` persistent blocks (ops/linear.py wgrad_launch), splits of
// rows_per_split tokens (a multiple of 64). splits > 1 needs `part`
// (splits, segs * N1 * N2 + (db ? segs * N1 : 0)) fp32 scratch and
// `barrier`, two ints of the stream (zero before the first launch; each
// launch leaves them ready for the next), and launches cooperatively: a grid
// that cannot be resident at once is refused. N1, N2 % 8 == 0; every
// pointer 16-byte aligned.
extern "C" int vk_wgrad(const void* a, const void* b, void* part, void* dw, void* db,
                        void* barrier, int M, int N1, int N2, int segs, int splits,
                        int rows_per_split, int grid, int dw_bf16, void* stream) {
  using namespace vk;
  const long items =
      (long)splits * segs * ((N1 + TG_BM - 1) / TG_BM) * ((N2 + TG_BN - 1) / TG_BN);
  if (M <= 0 || N1 <= 0 || N2 <= 0 || N1 % 8 || N2 % 8 || segs <= 0 || splits <= 0 ||
      rows_per_split % TG_BK || (long)splits * rows_per_split < M ||
      (long)(splits - 1) * rows_per_split >= M || grid <= 0 || grid > items || !dw ||
      (splits > 1 && (!part || !barrier)) ||
      ((uintptr_t)a | (uintptr_t)b | (uintptr_t)part | (uintptr_t)dw | (uintptr_t)db) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_a, tm_b;
  const uint64_t a_dims[3] = {(uint64_t)N1, (uint64_t)M, (uint64_t)segs};
  const uint64_t a_strides[2] = {(uint64_t)N1 * 2, (uint64_t)M * N1 * 2};
  const uint32_t a_box[3] = {64, TG_BK, 1};
  const uint64_t b_dims[2] = {(uint64_t)N2, (uint64_t)M};
  const uint64_t b_strides[1] = {(uint64_t)N2 * 2};
  const uint32_t b_box[2] = {64, TG_BK};
  if (!make_tmap_bf16(&tm_a, a, 3, a_dims, a_strides, a_box) ||
      !make_tmap_bf16(&tm_b, b, 2, b_dims, b_strides, b_box))
    return (int)cudaErrorInvalidValue;
  auto kernel = db ? wgrad_tma_kernel<true> : wgrad_tma_kernel<false>;
  if (cudaError_t e =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM))
    return (int)e;
  float* part_f = static_cast<float*>(part);
  float* db_f = static_cast<float*>(db);
  int* bar = static_cast<int*>(barrier);
  if (splits == 1) {
    kernel<<<grid, TG_THREADS, WG_SMEM, (cudaStream_t)stream>>>(
        tm_a, tm_b, part_f, dw, db_f, bar, M, N1, N2, segs, splits, rows_per_split, dw_bf16);
    return (int)cudaGetLastError();
  }
  void* args[] = {&tm_a, &tm_b, &part_f, &dw, &db_f, &bar, &M, &N1,
                  &N2,   &segs, &splits, &rows_per_split, &dw_bf16};
  return (int)cudaLaunchCooperativeKernel((const void*)kernel, grid, TG_THREADS, args, WG_SMEM,
                                          (cudaStream_t)stream);
}
