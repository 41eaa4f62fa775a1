// attention_bwd: the gradient of K1 (csrc/attention.cu) on the packed layout
// q, o, dO (B, Sq, H*64), k, v (B, Sk, H*64), bf16, from K1's fp32
// log-sum-exp (B, H, Sq). Keys at or past kv_len are masked as in K1, so the
// temporal t = 25 attention needs no padding; their dk and dv are zero.
// P and dS are rounded to bf16 for their products, as the TPU kernels do;
// accumulation is fp32. Nothing of size S^2 reaches device memory, and no
// sum uses atomics: two launches give the same bits. Both routes (chosen by
// ops/attention.py attention_bwd_plan) start with attn_bwd_prep_kernel:
// (lse * log2 e, D = rowsum(dO * O)) per (row, head) into fp32
// (B, H, Sq_pad, 2); pad rows read (+inf, 0), so a padded query has P = 0.
//
// wgmma route (Sk > 64: the spatial attention, ds1 .. mid at 576x1024,
// ds1 .. ds4 at 320x576; Sq_pad = Sq rounded up to 128). Replaces
// vista_tpu/ops/flash_attention.py _bwd_dq_kernel and _bwd_dkv_kernel
// (_flash_bwd_packed, s >= 2048) and the spatial half of
// vista_tpu/ops/tiny_attention.py _tiny_bwd_kernel (s <= 1024), with the
// TPU's split: each kernel recomputes P.
//   - attn_bwd_dkv_wgmma_kernel: a block per (128 keys, batch row, head);
//     K and V arrive once by TMA, the Q and dO tiles of 128 queries (with
//     their lse/D rows, a bulk copy) stream through a 3-stage ring that a
//     producer warp keeps full. Each of two consumer warpgroups owns 64 keys:
//     S^T = K Q^T and dP^T = V dO^T (wgmma m64n128, both operands K-major in
//     shared memory), P^T = exp2(S^T scale log2 e - lse log2 e) while dP^T is
//     still running, dS^T = P^T (dP^T - D), then dV += P^T dO and
//     dK += dS^T Q with P^T and dS^T as bf16 register A fragments and dO,
//     Q read MN-major as stored (the transpose bit; no thread transposes).
//     Keys at or past kv_len only touch their own rows, which the epilogue
//     writes as zeros.
//   - attn_bwd_dq_wgmma_kernel: a block per (128 queries, batch row, head),
//     Q and dO loaded once, K and V tiles of 128 keys streaming: S = Q K^T,
//     dP = dO V^T, P, dS = P (dP - D), dQ += dS K (K MN-major). The last
//     key tile masks keys at or past kv_len. It runs on a second stream
//     beside the dK/dV kernel, so that the last, partial wave of blocks of
//     each kernel shares the card with the other's blocks.
// Bound on the H100 at head_dim 64: the two kernels recompute P, so 7
// products of 2 * 64 * S_q * S_k flops (4 in dK/dV, 3 in dQ; the
// single-kernel FA2 count is 5) and exp2 of every score twice. At ds1
// 576x1024, 2 frames: 7.6e11 flops is 0.77 ms at 989 TFLOP/s, and 1.7e9
// exp2 is 0.44 ms on the special-function units (~3.9e12/s), so the exp2 of
// one warpgroup has to run under the other's products: the two consumer
// warpgroups of a block share the tensor cores, and within one, the exp2
// of S runs while dP's product is in flight. Each tile's last products are
// retired before the next tile's start: a product left in flight across
// the loop made ptxas serialise every wgmma of the kernel (C7515), and
// the registers (S, dP: 64 fp32 each; dK, dV or dQ: 32 each; 240 a
// thread) hold no second tile. Bytes are O(S d) per (row, head); the
// ring's Q/dO (K/V) tiles come from L2, shared by the blocks of one
// (batch row, head), which run next to each other.
//
// mma.sync route (Sk <= 64: the temporal t = 25 attention and the 45-key
// mid site at 320x576; Sq_pad = Sq), the port's first design, which beats
// the library call and the wgmma route there. Replaces tiny_attention.py
// _tiny_bwd_kernel at t = 25 and the softmax backward of
// vista_tpu/ops/fused_temporal_attn.py _bwd_kernel. FlashAttention-2 style:
//   - dK/dV: a block of 4 warps per (64 keys, batch row, head), each warp
//     owning 16 keys; K and V stay in registers as MMA fragments while the
//     Q, dO tiles of 64 queries stream through shared memory. Per tile:
//     S^T = K Q^T, P^T = exp2(S^T * scale*log2e - lse*log2e), dV += P^T dO,
//     dP^T = V dO^T, dS^T = P^T (dP^T - D), dK += dS^T Q;
//   - dQ: a block per (64 queries, batch row, head), K and V tiles
//     streaming: S = Q K^T, P, dP = dO V^T, dS = P (dP - D), dQ += dS K.
#include "attention_wgmma.cuh"

namespace vk {

constexpr int BQ = 64, BKV = 64, HD = 64;
constexpr int PS = HD + 8;  // padded smem row stride (bf16)
constexpr float LOG2E = 1.4426950408889634f;

// Tile loader: 64 rows of 64 bf16 from row ``r0`` of a packed (rows, H*64)
// slab, head ``h``; rows at or past ``n`` are zero.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0,
                                          int n, int HDall, int h) {
  for (int c = threadIdx.x; c < 64 * 8; c += 128) {
    const int row = c >> 3, ch = (c & 7) * 8, r = r0 + row;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < n)
      val = *reinterpret_cast<const uint4*>(src + (size_t)r * HDall + h * HD + ch);
    *reinterpret_cast<uint4*>(&dst[row * PS + ch]) = val;
  }
}

// A fragments of this warp's 16 rows of a 64x64 smem tile (k = head dim).
__device__ __forceinline__ void a_frags(const bf16* tile, uint32_t f[4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const bf16* p = tile + (warp * 16 + g) * PS + ks * 16 + t * 2;
    f[ks][0] = ld32(p);
    f[ks][1] = ld32(p + 8 * PS);
    f[ks][2] = ld32(p + 8);
    f[ks][3] = ld32(p + 8 * PS + 8);
  }
}

// acc[j] (16 x 64 over 8 n-tiles) += A(16 x 64, fragments) * T^T where the
// smem tile T holds the 64 n-rows with k = head dim along each row.
__device__ __forceinline__ void mma_rows(float acc[8][4], const uint32_t a[4][4],
                                         const bf16* tile) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bf16* p = tile + (j * 8 + g) * PS + ks * 16 + t * 2;
      const uint32_t b[2] = {ld32(p), ld32(p + 8)};
      mma_16816(acc[j], a[ks], b);
    }
}

// acc[j] (16 x 64 head dims) += P(16 x 64, fp32 accumulators) * T where the
// smem tile T is (64 k-rows, 64 head dims): P becomes the bf16 A fragments.
__device__ __forceinline__ void mma_cols(float acc[8][4], const float p[8][4],
                                         const bf16* tile) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
    const bf16* vp = tile + (kk * 16 + t * 2) * PS + g;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bf16* q = vp + j * 8;
      const uint32_t b[2] = {pack_raw(q[0], q[PS]), pack_raw(q[8 * PS], q[9 * PS])};
      mma_16816(acc[j], pa, b);
    }
  }
}

__device__ __forceinline__ void zero8(float a[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[j][e] = 0.f;
}

// Write this warp's 16 rows x 64 of acc * mul as bf16 (rows >= n skipped).
__device__ __forceinline__ void store_rows(bf16* dst, const float acc[8][4],
                                           int r0, int n, int HDall, int h,
                                           float mul) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + warp * 16 + g + r * 8;
    if (row >= n) continue;
    bf16* p = dst + (size_t)row * HDall + h * HD + t * 2;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(p + j * 8) =
          pack_bf16(acc[j][2 * r] * mul, acc[j][2 * r + 1] * mul);
  }
}

// rows[(b H + h) Sq_pad + q] = (lse[b, h, q] log2 e, sum_d dO O) for q < Sq
// and (+inf, 0) past it. Eight threads per (b, h, q), 16 bytes of O and dO
// each; q fastest, so that a warp writes 32 contiguous bytes of rows and
// reads whole 128-byte rows of one head.
__global__ void __launch_bounds__(256)
attn_bwd_prep_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, float2* __restrict__ rows, int B, int Sq,
                     int Sq_pad, int H) {
  const long idx = (long)blockIdx.x * 256 + threadIdx.x;
  const long pair = idx >> 3;  // (b H + h) Sq_pad + q
  const int part = (int)(idx & 7);
  const bool valid = pair < (long)B * H * Sq_pad;
  const int q = (int)(pair % Sq_pad);
  const long bh = pair / Sq_pad;
  const int h = (int)(bh % H), b = (int)(bh / H);
  float s = 0.f;
  if (valid && q < Sq) {
    const size_t off = ((size_t)b * Sq + q) * H * HD + h * HD + part * 8;
    float a[8], d[8];
    unpack8(*reinterpret_cast<const uint4*>(o + off), a);
    unpack8(*reinterpret_cast<const uint4*>(dout + off), d);
#pragma unroll
    for (int e = 0; e < 8; ++e) s = fmaf(a[e], d[e], s);
  }
#pragma unroll
  for (int m = 4; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  if (valid && part == 0)
    rows[pair] = q < Sq ? make_float2(lse[bh * Sq + q] * LOG2E, s)
                        : make_float2(INFINITY, 0.f);
}

__global__ void __launch_bounds__(128)
attn_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float2* __restrict__ rows,
                    const bf16* __restrict__ dout, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int Sq, int Sk, int H, int kv_len,
                    float scale, float scale_log2) {
  __shared__ __align__(16) bf16 Qs[BQ * PS];
  __shared__ __align__(16) bf16 Ds[BQ * PS];  // the dO tile
  __shared__ float s_lse[BQ], s_d[BQ];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k_tiles = (Sk + BKV - 1) / BKV;
  const int b = blockIdx.x / k_tiles, k0 = (blockIdx.x % k_tiles) * BKV;
  const int h = blockIdx.y;
  const int HDall = H * HD;

  // K and V fragments of this warp's 16 keys, staged through the Q/dO tiles.
  uint32_t kf[4][4], vf[4][4];
  load_tile(Qs, k + (size_t)b * Sk * HDall, k0, kv_len, HDall, h);
  load_tile(Ds, v + (size_t)b * Sk * HDall, k0, kv_len, HDall, h);
  __syncthreads();
  a_frags(Qs, kf);
  a_frags(Ds, vf);

  float dka[8][4], dva[8][4];
  zero8(dka);
  zero8(dva);
  const float2* rows_b = rows + ((size_t)b * H + h) * Sq;
  for (int q0 = 0; q0 < Sq; q0 += BQ) {
    __syncthreads();  // the previous tiles (or the K/V staging) are read
    load_tile(Qs, q + (size_t)b * Sq * HDall, q0, Sq, HDall, h);
    load_tile(Ds, dout + (size_t)b * Sq * HDall, q0, Sq, HDall, h);
    for (int i = threadIdx.x; i < BQ; i += 128) {
      const float2 r = q0 + i < Sq ? rows_b[q0 + i] : make_float2(INFINITY, 0.f);
      s_lse[i] = r.x;
      s_d[i] = r.y;
    }
    __syncthreads();

    // P^T (this warp's 16 keys x 64 queries) from S^T = K Q^T.
    float p[8][4];
    zero8(p);
    mma_rows(p, kf, Qs);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + warp * 16 + g + (e >> 1) * 8;
        const int qc = j * 8 + t * 2 + (e & 1);
        p[j][e] = key < kv_len ? exp2f(p[j][e] * scale_log2 - s_lse[qc]) : 0.f;
      }
    mma_cols(dva, p, Ds);  // dV += P^T dO

    float dp[8][4];
    zero8(dp);
    mma_rows(dp, vf, Ds);  // dP^T = V dO^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[j][e] = p[j][e] * (dp[j][e] - s_d[j * 8 + t * 2 + (e & 1)]);
    mma_cols(dka, dp, Qs);  // dK += dS^T Q
  }
  store_rows(dk + (size_t)b * Sk * HDall, dka, k0, Sk, HDall, h, scale);
  store_rows(dv + (size_t)b * Sk * HDall, dva, k0, Sk, HDall, h, 1.f);
}

__global__ void __launch_bounds__(128)
attn_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float2* __restrict__ rows,
                   const bf16* __restrict__ dout, bf16* __restrict__ dq,
                   int Sq, int Sk, int H, int kv_len, float scale,
                   float scale_log2) {
  __shared__ __align__(16) bf16 Ks[BKV * PS];
  __shared__ __align__(16) bf16 Vs[BKV * PS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q_tiles = (Sq + BQ - 1) / BQ;
  const int b = blockIdx.x / q_tiles, q0 = (blockIdx.x % q_tiles) * BQ;
  const int h = blockIdx.y;
  const int HDall = H * HD;

  uint32_t qf[4][4], df[4][4];
  load_tile(Ks, q + (size_t)b * Sq * HDall, q0, Sq, HDall, h);
  load_tile(Vs, dout + (size_t)b * Sq * HDall, q0, Sq, HDall, h);
  __syncthreads();
  a_frags(Ks, qf);
  a_frags(Vs, df);
  float l2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + warp * 16 + g + r * 8;
    const float2 rw = qi < Sq ? rows[((size_t)b * H + h) * Sq + qi] : make_float2(INFINITY, 0.f);
    l2[r] = rw.x;
    dd[r] = rw.y;
  }

  float dqa[8][4];
  zero8(dqa);
  for (int k0 = 0; k0 < kv_len; k0 += BKV) {
    __syncthreads();
    load_tile(Ks, k + (size_t)b * Sk * HDall, k0, kv_len, HDall, h);
    load_tile(Vs, v + (size_t)b * Sk * HDall, k0, kv_len, HDall, h);
    __syncthreads();

    float p[8][4], dp[8][4];
    zero8(p);
    zero8(dp);
    mma_rows(p, qf, Ks);   // S = Q K^T
    mma_rows(dp, df, Vs);  // dP = dO V^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + t * 2 + (e & 1);
        const float pe = key < kv_len ? exp2f(p[j][e] * scale_log2 - l2[e >> 1]) : 0.f;
        p[j][e] = pe * (dp[j][e] - dd[e >> 1]);
      }
    mma_cols(dqa, p, Ks);  // dQ += dS K
  }
  store_rows(dq + (size_t)b * Sq * HDall, dqa, q0, Sq, HDall, h, scale);
}


// ---- the wgmma route

constexpr int WB = 128;        // rows per block (64 per consumer warpgroup) and per ring stage
constexpr int WB_STAGES = 3;
constexpr int WB_TILE = WB * HD * 2;  // one 128 x 64 bf16 TMA box, 16 KB
constexpr int WB_ROW_BYTES = WB * 8;  // (lse log2 e, D) of a stage's 128 queries
constexpr int WB_DKV_STAGE = 2 * WB_TILE + WB_ROW_BYTES;  // Q, dO, rows
constexpr int WB_DQ_STAGE = 2 * WB_TILE;                  // K, V
constexpr int WB_CONSUMER_WARPS = 8;
constexpr int WB_THREADS = WB_CONSUMER_WARPS * 32 + 128;
constexpr int WB_BAR_BYTES = 8 * (1 + 2 * WB_STAGES);
constexpr int WB_DKV_SMEM = 1024 + 2 * WB_TILE + WB_STAGES * WB_DKV_STAGE + WB_BAR_BYTES;
constexpr int WB_DQ_SMEM = 1024 + 2 * WB_TILE + WB_STAGES * WB_DQ_STAGE + WB_BAR_BYTES;

// Shared memory of a block (1024-aligned for the swizzle): the two tiles it
// keeps (K, V or Q, dO) at `fixed`, then the ring, then the barriers: one
// for the kept tiles, full and empty per stage.
struct WbRing : Ring<WB_STAGES> {
  uint32_t fixed, fixed_bar;
};

__device__ __forceinline__ WbRing wb_ring(uint8_t* smem_raw, int stage_bytes) {
  WbRing r;
  r.fixed = (smem_u32(smem_raw) + 1023) & ~1023u;
  r.base = r.fixed + 2 * WB_TILE;
  r.bytes = stage_bytes;
  r.fixed_bar = r.base + WB_STAGES * stage_bytes;
  r.full0 = r.fixed_bar + 8;
  r.empty0 = r.full0 + 8 * WB_STAGES;
  if (threadIdx.x == 0) {
    mbar_init(r.fixed_bar, 1);
    for (int s = 0; s < WB_STAGES; ++s) {
      mbar_init(r.full0 + 8 * s, 1);
      mbar_init(r.empty0 + 8 * s, WB_CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  return r;
}

// dK, dV of 128 keys of one (batch row, head): block = key tile fastest,
// then head, then batch row, so that the blocks sharing a stream of Q and
// dO run together and find it in L2.
__global__ void __launch_bounds__(WB_THREADS, 1)
attn_bwd_dkv_wgmma_kernel(__grid_constant__ const CUtensorMap tm_q,
                          __grid_constant__ const CUtensorMap tm_k,
                          __grid_constant__ const CUtensorMap tm_v,
                          __grid_constant__ const CUtensorMap tm_do,
                          const float2* __restrict__ rows, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int Sk, int H, int kv_len, int Sq_pad,
                          float scale, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  WbRing ring = wb_ring(smem_raw, WB_DKV_STAGE);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k_tiles = (Sk + WB - 1) / WB;
  const int bh = blockIdx.x / k_tiles, k0 = (blockIdx.x % k_tiles) * WB;
  const int h = bh % H, b = bh / H;
  const int n_q = Sq_pad / WB;

  if (warp >= WB_CONSUMER_WARPS) {
    // producer warpgroup: gives its registers to the consumers; one thread
    // loads K, V once and keeps the ring of Q, dO and row tiles full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (warp == WB_CONSUMER_WARPS && lane == 0) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_do);
      mbar_arrive_expect_tx(ring.fixed_bar, 2 * WB_TILE);
      tma_load_3d(ring.fixed, &tm_k, ring.fixed_bar, h * HD, k0, b);
      tma_load_3d(ring.fixed + WB_TILE, &tm_v, ring.fixed_bar, h * HD, k0, b);
      const float2* rows_bh = rows + (size_t)bh * Sq_pad;
      for (int i = 0; i < n_q; ++i) {
        mbar_wait(ring.empty(), ring.phase ^ 1);
        mbar_arrive_expect_tx(ring.full(), WB_DKV_STAGE);
        const uint32_t dst = ring.tile();
        tma_load_3d(dst, &tm_q, ring.full(), h * HD, i * WB, b);
        tma_load_3d(dst + WB_TILE, &tm_do, ring.full(), h * HD, i * WB, b);
        bulk_load(dst + 2 * WB_TILE, rows_bh + i * WB, WB_ROW_BYTES, ring.full());
        ring.advance();
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const uint32_t ka = ring.fixed + wg * (WB_TILE / 2), va = ka + WB_TILE;
  // this thread's accumulator columns 8 j + 2 t, + 1 are queries; their
  // (lse, D) pairs are the float4 4 j + t of a stage's rows
  const float4* srows = reinterpret_cast<const float4*>(
      smem_raw + (ring.base + 2 * WB_TILE - smem_u32(smem_raw)));
  float dva[32], dka[32], s[64], dp[64];
  uint32_t pf[8][4], df[8][4];
#pragma unroll
  for (int e = 0; e < 32; ++e) dva[e] = dka[e] = 0.f;
  mbar_wait(ring.fixed_bar, 0);
  for (int i = 0; i < n_q; ++i) {
    mbar_wait(ring.full(), ring.phase);
    const uint32_t qa = ring.tile(), doa = qa + WB_TILE;
    const float4* r4 = srows + ring.stage * (WB_DKV_STAGE / 16);
    wgmma_fence();
    wb_scores(s, ka, qa);  // S^T = K Q^T
    wgmma_commit();
    wb_scores(dp, va, doa);  // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<1>();
#pragma unroll
    for (int e = 0; e < 64; ++e) reg_fence(s[e]);
#pragma unroll
    for (int j = 0; j < 16; ++j) {  // P^T, under dP^T's product
      const float4 r = r4[4 * j + t];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        s[4 * j + 2 * u] = ex2(fmaf(s[4 * j + 2 * u], scale_log2, -r.x));
        s[4 * j + 2 * u + 1] = ex2(fmaf(s[4 * j + 2 * u + 1], scale_log2, -r.z));
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < 64; ++e) reg_fence(dp[e]);
#pragma unroll
    for (int j = 0; j < 16; ++j) {  // dS^T = P^T (dP^T - D)
      const float4 r = r4[4 * j + t];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        dp[4 * j + 2 * u] = s[4 * j + 2 * u] * (dp[4 * j + 2 * u] - r.y);
        dp[4 * j + 2 * u + 1] = s[4 * j + 2 * u + 1] * (dp[4 * j + 2 * u + 1] - r.w);
      }
    }
    acc_to_frags(s, pf);
    acc_to_frags(dp, df);
    wgmma_fence();
    wb_accumulate(dva, pf, doa);  // dV += P^T dO
    wb_accumulate(dka, df, qa);   // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        reg_fence(pf[kk][e]);
        reg_fence(df[kk][e]);
      }
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty());
    ring.advance();
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    reg_fence(dva[e]);
    reg_fence(dka[e]);
  }

  // rows 16 w + g + 8 u of this warpgroup's 64 keys; keys at or past kv_len
  // (whose P was not masked) are written as zeros
  const int HDall = H * HD;
  const int key0 = k0 + 64 * wg + 16 * (warp & 3) + g;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int key = key0 + 8 * u;
    if (key >= Sk) continue;
    const bool live = key < kv_len;
    const size_t off = ((size_t)b * Sk + key) * HDall + h * HD + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float* a = dka + 4 * j + 2 * u;
      const float* c = dva + 4 * j + 2 * u;
      *reinterpret_cast<uint32_t*>(dk + off + 8 * j) =
          live ? pack_bf16(a[0] * scale, a[1] * scale) : 0u;
      *reinterpret_cast<uint32_t*>(dv + off + 8 * j) = live ? pack_bf16(c[0], c[1]) : 0u;
    }
  }
}

// dQ of 128 queries of one (batch row, head); block = query tile fastest.
__global__ void __launch_bounds__(WB_THREADS, 1)
attn_bwd_dq_wgmma_kernel(__grid_constant__ const CUtensorMap tm_q,
                         __grid_constant__ const CUtensorMap tm_k,
                         __grid_constant__ const CUtensorMap tm_v,
                         __grid_constant__ const CUtensorMap tm_do,
                         const float2* __restrict__ rows, bf16* __restrict__ dq, int Sq, int H,
                         int kv_len, int Sq_pad, float scale, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  WbRing ring = wb_ring(smem_raw, WB_DQ_STAGE);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q_tiles = Sq_pad / WB;
  const int bh = blockIdx.x / q_tiles, q0 = (blockIdx.x % q_tiles) * WB;
  const int h = bh % H, b = bh / H;
  const int n_k = (kv_len + WB - 1) / WB;

  if (warp >= WB_CONSUMER_WARPS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (warp == WB_CONSUMER_WARPS && lane == 0) {
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      mbar_arrive_expect_tx(ring.fixed_bar, 2 * WB_TILE);
      tma_load_3d(ring.fixed, &tm_q, ring.fixed_bar, h * HD, q0, b);
      tma_load_3d(ring.fixed + WB_TILE, &tm_do, ring.fixed_bar, h * HD, q0, b);
      for (int i = 0; i < n_k; ++i) {
        mbar_wait(ring.empty(), ring.phase ^ 1);
        mbar_arrive_expect_tx(ring.full(), WB_DQ_STAGE);
        const uint32_t dst = ring.tile();
        tma_load_3d(dst, &tm_k, ring.full(), h * HD, i * WB, b);
        tma_load_3d(dst + WB_TILE, &tm_v, ring.full(), h * HD, i * WB, b);
        ring.advance();
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const uint32_t qa = ring.fixed + wg * (WB_TILE / 2), doa = qa + WB_TILE;
  const int row0 = q0 + 64 * wg + 16 * (warp & 3) + g;  // and row0 + 8, both < Sq_pad
  const float2 r0 = rows[(size_t)bh * Sq_pad + row0], r1 = rows[(size_t)bh * Sq_pad + row0 + 8];
  const float l2[2] = {r0.x, r1.x}, dd[2] = {r0.y, r1.y};
  float dqa[32], s[64], dp[64];
  uint32_t df[8][4];
#pragma unroll
  for (int e = 0; e < 32; ++e) dqa[e] = 0.f;
  mbar_wait(ring.fixed_bar, 0);
  for (int i = 0; i < n_k; ++i) {
    mbar_wait(ring.full(), ring.phase);
    const uint32_t ka = ring.tile(), va = ka + WB_TILE;
    wgmma_fence();
    wb_scores(s, qa, ka);  // S = Q K^T
    wgmma_commit();
    wb_scores(dp, doa, va);  // dP = dO V^T
    wgmma_commit();
    wgmma_wait<1>();
#pragma unroll
    for (int e = 0; e < 64; ++e) reg_fence(s[e]);
    const int kbase = i * WB + 2 * t;
    if (i * WB + WB > kv_len) {  // the last tile: keys at or past kv_len are masked
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[4 * j + 2 * u + e];
            x = kbase + 8 * j + e < kv_len ? ex2(fmaf(x, scale_log2, -l2[u])) : 0.f;
          }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[4 * j + 2 * u + e];
            x = ex2(fmaf(x, scale_log2, -l2[u]));
          }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < 64; ++e) reg_fence(dp[e]);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          dp[4 * j + 2 * u + e] = s[4 * j + 2 * u + e] * (dp[4 * j + 2 * u + e] - dd[u]);
    acc_to_frags(dp, df);
    wgmma_fence();
    wb_accumulate(dqa, df, ka);  // dQ += dS K
    wgmma_commit();
    // Retired here, not under the next tile's products: a dQ product left
    // in flight across the loop makes ptxas serialise every wgmma (C7515).
    wgmma_wait<0>();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) reg_fence(df[kk][e]);
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty());
    ring.advance();
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) reg_fence(dqa[e]);

  const int HDall = H * HD;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int row = row0 + 8 * u;
    if (row >= Sq) continue;
    bf16* p = dq + ((size_t)b * Sq + row) * HDall + h * HD + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(p + 8 * j) =
          pack_bf16(dqa[4 * j + 2 * u] * scale, dqa[4 * j + 2 * u + 1] * scale);
  }
}

}  // namespace vk

// Both routes: the pre-pass from o, dout (B, Sq, H*64) bf16 and K1's lse
// (B, H, Sq) fp32 into rows, fp32 (B, H, Sq_pad, 2) scratch: Sq_pad = Sq
// for the mma.sync route, Sq rounded up to 128 for the wgmma one.
extern "C" int vk_attention_bwd_prep(const void* o, const void* dout, const void* lse,
                                     void* rows, int B, int Sq, int Sq_pad, int H,
                                     void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0 || Sq_pad < Sq) return (int)cudaErrorInvalidValue;
  const long threads = (long)B * Sq_pad * H * 8;
  vk::attn_bwd_prep_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const vk::bf16*)o, (const vk::bf16*)dout, (const float*)lse, (float2*)rows, B, Sq,
      Sq_pad, H);
  return (int)cudaGetLastError();
}

// Then dq (like q), dk, dv (like k) from q, dout (B, Sq, H*64), k, v
// (B, Sk, H*64) bf16 and the rows; 1 <= kv_len <= Sk. Both entries take the
// same arguments. The mma.sync route (Sq_pad = Sq):
extern "C" int vk_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                                const void* rows, void* dq, void* dk, void* dv, int B, int Sq,
                                int Sk, int H, int kv_len, int Sq_pad, float scale,
                                void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || kv_len < 1 || kv_len > Sk || Sq_pad != Sq)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float scale_log2 = scale * vk::LOG2E;
  dim3 gkv(B * ((Sk + vk::BKV - 1) / vk::BKV), H);
  vk::attn_bwd_dkv_kernel<<<gkv, 128, 0, st>>>(
      (const vk::bf16*)q, (const vk::bf16*)k, (const vk::bf16*)v, (const float2*)rows,
      (const vk::bf16*)dout, (vk::bf16*)dk, (vk::bf16*)dv, Sq, Sk, H, kv_len, scale, scale_log2);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  dim3 gq(B * ((Sq + vk::BQ - 1) / vk::BQ), H);
  vk::attn_bwd_dq_kernel<<<gq, 128, 0, st>>>(
      (const vk::bf16*)q, (const vk::bf16*)k, (const vk::bf16*)v, (const float2*)rows,
      (const vk::bf16*)dout, (vk::bf16*)dq, Sq, Sk, H, kv_len, scale, scale_log2);
  return (int)cudaGetLastError();
}

// A second stream per device for the dQ kernel, made once.
static cudaError_t side_stream(cudaStream_t* out) {
  static cudaStream_t streams[64] = {};
  int dev = 0;
  if (cudaError_t e = cudaGetDevice(&dev)) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (streams[dev] == nullptr) {
    if (cudaError_t e = cudaStreamCreateWithFlags(&streams[dev], cudaStreamNonBlocking)) return e;
  }
  *out = streams[dev];
  return cudaSuccess;
}

// The wgmma route (Sq_pad = Sq rounded up to 128; every pointer 16-byte
// aligned):
extern "C" int vk_attention_bwd_wgmma(const void* q, const void* k, const void* v,
                                      const void* dout, const void* rows, void* dq, void* dk,
                                      void* dv, int B, int Sq, int Sk, int H, int kv_len,
                                      int Sq_pad, float scale, void* stream) {
  using namespace vk;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || kv_len < 1 || kv_len > Sk ||
      Sq_pad != (Sq + WB - 1) / WB * WB ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout | (uintptr_t)rows |
       (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  if (!attn_map(&tm_q, q, Sq, B, H, WB) || !attn_map(&tm_do, dout, Sq, B, H, WB) ||
      !attn_map(&tm_k, k, Sk, B, H, WB) || !attn_map(&tm_v, v, Sk, B, H, WB))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float scale_log2 = scale * LOG2E;
  if (cudaError_t e = cudaFuncSetAttribute(attn_bwd_dkv_wgmma_kernel,
                                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            WB_DKV_SMEM))
    return (int)e;
  if (cudaError_t e = cudaFuncSetAttribute(attn_bwd_dq_wgmma_kernel,
                                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            WB_DQ_SMEM))
    return (int)e;
  // dQ runs beside dK/dV on a second stream, so that each kernel's last,
  // partial wave of blocks shares the card with the other's blocks; the
  // caller's stream waits for both.
  cudaStream_t side;
  cudaEvent_t ready, done;
  if (cudaError_t e = side_stream(&side)) return (int)e;
  if (cudaEventCreateWithFlags(&ready, cudaEventDisableTiming) != cudaSuccess ||
      cudaEventCreateWithFlags(&done, cudaEventDisableTiming) != cudaSuccess)
    return (int)cudaGetLastError();
  cudaEventRecord(ready, st);
  cudaStreamWaitEvent(side, ready, 0);
  const long dq_blocks = (long)B * H * (Sq_pad / WB);
  attn_bwd_dq_wgmma_kernel<<<(unsigned)dq_blocks, WB_THREADS, WB_DQ_SMEM, side>>>(
      tm_q, tm_k, tm_v, tm_do, (const float2*)rows, (bf16*)dq, Sq, H, kv_len, Sq_pad, scale,
      scale_log2);
  cudaError_t rc = cudaGetLastError();
  const long dkv_blocks = (long)B * H * ((Sk + WB - 1) / WB);
  attn_bwd_dkv_wgmma_kernel<<<(unsigned)dkv_blocks, WB_THREADS, WB_DKV_SMEM, st>>>(
      tm_q, tm_k, tm_v, tm_do, (const float2*)rows, (bf16*)dk, (bf16*)dv, Sk, H, kv_len, Sq_pad,
      scale, scale_log2);
  if (rc == cudaSuccess) rc = cudaGetLastError();
  cudaEventRecord(done, side);
  cudaStreamWaitEvent(st, done, 0);
  cudaEventDestroy(ready);  // released once recorded work completes
  cudaEventDestroy(done);
  return rc == cudaSuccess ? (int)cudaGetLastError() : (int)rc;
}
