// attention_bwd: the gradient of K1 (csrc/attention.cu) on the packed layout
// q, o, dO (B, Sq, H*64), k, v (B, Sk, H*64), bf16, from K1's fp32
// log-sum-exp (B, H, Sq). Keys at or past kv_len are masked as in K1, so the
// temporal t = 25 attention needs no padding; their dk and dv are zero.
// P and dS are rounded to bf16 for their products, as the TPU kernels do;
// accumulation is fp32. Nothing of size S^2 reaches device memory, and no
// sum uses atomics: two launches give the same bits. Two routes, chosen by
// ops/attention.py attention_bwd_plan.
//
// wgmma route (Sk > 64: the spatial attention, ds1 .. mid at 576x1024,
// ds1 .. ds4 at 320x576). It starts with attn_bwd_prep_kernel: (lse * log2 e,
// D = rowsum(dO * O)) per (row, head) into fp32 (B, H, Sq_pad, 2), Sq_pad =
// Sq rounded up to 128; pad rows read (+inf, 0), so a padded query has
// P = 0. Replaces
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
// short route (Sq, Sk <= 64: the temporal t = 25 attention and the 45-key
// mid site at 320x576): attn_bwd_short_kernel, one launch, no pre-pass, no
// atomics. Replaces tiny_attention.py _tiny_bwd_kernel at those sites and
// the softmax backward of vista_tpu/ops/fused_temporal_attn.py _bwd_kernel.
// The layout, the persistent walk and the ring are csrc/attention_short.cuh's;
// a stage holds one unit's Q, K, V, O and dO boxes, so each is read from HBM
// once and dQ, dK, dV are written once: the bytes of the bound. A unit's
// sums never leave the block. Per unit:
//   - phase A, each warp on its 16 query rows: D = rowsum(dO O) in fp32 from
//     the O and dO boxes; S = Q K^T and dP = dO V^T; P = exp2(S scale log2 e
//     - lse log2 e) (lse read ahead, one unit early, into registers; +inf on
//     rows past Sq, so a pad row has P = 0; keys at or past kv_len give
//     P = 0, so their dS, dK and dV are 0); dS = P (dP - D); dQ = dS K with
//     dS rounded to bf16; P and dS in bf16 into shared memory;
//   - a barrier of the consumer warps; phase B, each warp on its 16 keys:
//     dV = P^T dO and dK = dS^T Q, P^T and dS^T read transposed by ldmatrix;
//   - dQ scale into the warp's O rows (read by no other warp), dK scale and
//     dV into its K and V rows (no longer read once phase A is over), stored
//     by three TMA stores of 16 rows; the stage is released once they have
//     read it, and a second barrier lets the next unit overwrite P and dS.
#include "attention_short.cuh"

namespace vk {

constexpr int HD = 64;
constexpr float LOG2E = 1.4426950408889634f;

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

// The short route. Shared memory (1024-aligned for the swizzle): the ring
// of (Q, K, V, O, dO) stages, P and dS (bf16, SB + 8 values a row), the
// barriers (full and empty per stage).
template <int SB>
__global__ void __launch_bounds__(SH_THREADS, SH_BLOCKS_PER_SM)
attn_bwd_short_kernel(__grid_constant__ const CUtensorMap tm_q,
                      __grid_constant__ const CUtensorMap tm_k,
                      __grid_constant__ const CUtensorMap tm_v,
                      __grid_constant__ const CUtensorMap tm_o,
                      __grid_constant__ const CUtensorMap tm_do,
                      __grid_constant__ const CUtensorMap tm_dq,
                      __grid_constant__ const CUtensorMap tm_dk,
                      __grid_constant__ const CUtensorMap tm_dv, const float* __restrict__ lse,
                      int B, int Sq, int H, int kv_len, float scale, float scale_log2) {
  constexpr int NSEQ = SH_ROWS / SB, NT = SB / 8, STRIDE = (SB + 8) * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  Ring<SH_BWD_STAGES> ring;
  ring.base = (raw + 1023) & ~1023u;
  ring.bytes = SH_BWD_STAGE;
  const uint32_t p_s = ring.base + SH_BWD_STAGES * SH_BWD_STAGE, ds_s = p_s + SH_BWD_PDS / 2;
  ring.full0 = p_s + SH_BWD_PDS;
  ring.empty0 = ring.full0 + 8 * SH_BWD_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < SH_BWD_STAGES; ++s) {
      mbar_init(ring.full0 + 8 * s, 1);
      mbar_init(ring.empty0 + 8 * s, SH_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int units = (B + NSEQ - 1) / NSEQ * H;

  if (warp == SH_WARPS) {  // the producer: one thread keeps the ring full
    if (lane == 0) {
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int h = u % H, b0 = u / H * NSEQ;
        const uint32_t dst = ring.tile(), bar = ring.full();
        mbar_wait(ring.empty(), ring.phase ^ 1);
        mbar_arrive_expect_tx(bar, SH_BWD_STAGE);
        tma_load_3d(dst, &tm_q, bar, h * HD, 0, b0);
        tma_load_3d(dst + SH_BOX, &tm_k, bar, h * HD, 0, b0);
        tma_load_3d(dst + 2 * SH_BOX, &tm_v, bar, h * HD, 0, b0);
        tma_load_3d(dst + 3 * SH_BOX, &tm_o, bar, h * HD, 0, b0);
        tma_load_3d(dst + 4 * SH_BOX, &tm_do, bar, h * HD, 0, b0);
        ring.advance();
      }
    }
    return;
  }
  const int g = lane >> 2, t = lane & 3;
  const int R0 = 16 * warp, j = R0 / SB, r0 = R0 % SB, J0 = j * SB;
  // lse log2 e of this thread's rows r0 + g, r0 + g + 8 of unit u's sequence
  auto lse_rows = [&](int u, float (&out)[2]) {
    const int h = u % H, b = u / H * NSEQ + j;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + 8 * r;
      out[r] = b < B && row < Sq ? lse[((size_t)b * H + h) * Sq + row] * LOG2E : INFINITY;
    }
  };
  float l2[2], l2_next[2];
  if (blockIdx.x < units) lse_rows(blockIdx.x, l2_next);
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int h = u % H, b = u / H * NSEQ + j;
    l2[0] = l2_next[0];
    l2[1] = l2_next[1];
    if (u + (int)gridDim.x < units) lse_rows(u + gridDim.x, l2_next);
    mbar_wait(ring.full(), ring.phase);
    const uint32_t qb = ring.tile(), kb = qb + SH_BOX, vb = kb + SH_BOX, ob = vb + SH_BOX,
                   dob = ob + SH_BOX;
    uint8_t* const o_ptr = smem_raw + (ob - raw);

    // phase A: query rows R0 .. R0 + 15. D of row R0 + i from lanes 2i, 2i + 1.
    float dsum = 0.f;
    {
      const uint8_t* op = o_ptr;
      const uint8_t* dp = smem_raw + (dob - raw);
      const int row = R0 + (lane >> 1);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int chunk = 4 * (lane & 1) + c;
        float a[8], d[8];
        unpack8(*reinterpret_cast<const uint4*>(op + sw128(row, chunk)), a);
        unpack8(*reinterpret_cast<const uint4*>(dp + sw128(row, chunk)), d);
#pragma unroll
        for (int e = 0; e < 8; ++e) dsum = fmaf(a[e], d[e], dsum);
      }
      dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
    }
    const float D[2] = {__shfl_sync(0xffffffffu, dsum, 2 * g),
                        __shfl_sync(0xffffffffu, dsum, 2 * g + 16)};
    uint32_t qf[4][4], df[4][4];
    sh_a_frags(qb, R0, qf);
    sh_a_frags(dob, R0, df);
    float s[NT][4], dpa[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dpa[nt][e] = 0.f;
    sh_scores<SB>(s, qf, kb, J0);    // S = Q K^T
    sh_scores<SB>(dpa, df, vb, J0);  // dP = dO V^T
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * nt + 2 * t + (e & 1);
        const float p = key < kv_len ? ex2(fmaf(s[nt][e], scale_log2, -l2[e >> 1])) : 0.f;
        s[nt][e] = p;
        dpa[nt][e] = p * (dpa[nt][e] - D[e >> 1]);  // dS
      }
    uint32_t pf[NT / 2][4], dsf[NT / 2][4];
    sh_pack<NT / 2>(s, pf);
    sh_pack<NT / 2>(dpa, dsf);
    float dq[8][4];
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[dt][e] = 0.f;
    sh_accumulate<SB>(dq, dsf, kb, J0);  // dQ = dS K
    {
      // P and dS rows R0 + g (+ 8), keys 16 kk + 2 t (+ 8): fragment word e
      // of k-step kk is row g + 8 (e & 1), keys + 8 (e >> 1)
      uint8_t* const pp = smem_raw + (p_s - raw);
      uint8_t* const dsp = smem_raw + (ds_s - raw);
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int off = (R0 + g + 8 * (e & 1)) * STRIDE + (16 * kk + 8 * (e >> 1) + 2 * t) * 2;
          *reinterpret_cast<uint32_t*>(pp + off) = pf[kk][e];
          *reinterpret_cast<uint32_t*>(dsp + off) = dsf[kk][e];
        }
    }
    bar_named(1, SH_WARPS * 32);  // P and dS whole; K, V and O no longer read

    // phase B: keys r0 .. r0 + 15 of sequence j (box rows R0 ..)
    uint32_t pt[NT / 2][4], dst[NT / 2][4];
    sh_at_frags<SB>(p_s, STRIDE, J0, r0, pt);
    sh_at_frags<SB>(ds_s, STRIDE, J0, r0, dst);
    float dv[8][4], dk[8][4];
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dv[dt][e] = dk[dt][e] = 0.f;
    sh_accumulate<SB>(dv, pt, dob, J0);  // dV = P^T dO
    sh_accumulate<SB>(dk, dst, qb, J0);  // dK = dS^T Q
    const float by_scale[2] = {scale, scale}, by_one[2] = {1.f, 1.f};
    sh_store_rows(o_ptr, R0, dq, by_scale);
    sh_store_rows(smem_raw + (kb - raw), R0, dk, by_scale);
    sh_store_rows(smem_raw + (vb - raw), R0, dv, by_one);
    fence_async_smem();
    __syncwarp();
    if (lane == 0) {
      tma_store_3d(&tm_dq, ob + R0 * 128, h * HD, r0, b);
      tma_store_3d(&tm_dk, kb + R0 * 128, h * HD, r0, b);
      tma_store_3d(&tm_dv, vb + R0 * 128, h * HD, r0, b);
      bulk_commit();
      bulk_wait_read<0>();
      mbar_arrive(ring.empty());  // the stores have read the stage
    }
    ring.advance();
    bar_named(1, SH_WARPS * 32);  // every warp has read P and dS
  }
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

// The wgmma route's pre-pass from o, dout (B, Sq, H*64) bf16 and K1's lse
// (B, H, Sq) fp32 into rows, fp32 (B, H, Sq_pad, 2) scratch (Sq_pad >= Sq).
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

// The short route (Sq, Sk <= 64), in one launch: dq (like q), dk, dv (like
// k) from q, o, dout (B, Sq, H*64), k, v (B, Sk, H*64) bf16 and K1's lse
// (B, H, Sq) fp32; 1 <= kv_len <= Sk; a persistent grid of `blocks` blocks
// of SH_THREADS with `smem` bytes of dynamic shared memory, as
// ops/attention.py attention_bwd_plan computes them (every pointer 16-byte
// aligned):
extern "C" int vk_attention_bwd_short(const void* q, const void* k, const void* v,
                                      const void* o, const void* dout, const void* lse,
                                      void* dq, void* dk, void* dv, int B, int Sq, int Sk,
                                      int H, int kv_len, float scale, int blocks, int smem,
                                      void* stream) {
  using namespace vk;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || Sq > SH_ROWS || Sk > SH_ROWS || kv_len < 1 ||
      kv_len > Sk || smem != SH_BWD_SMEM ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o | (uintptr_t)dout |
       (uintptr_t)lse | (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv) % 16)
    return (int)cudaErrorInvalidValue;
  const int sb = sh_frames(Sq > Sk ? Sq : Sk), nseq = SH_ROWS / sb;
  const long units = (long)((B + nseq - 1) / nseq) * H;
  if (blocks < 1 || blocks > units) return (int)cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_k, tm_v, tm_o, tm_do, tm_dq, tm_dk, tm_dv;
  if (!short_map(&tm_q, q, Sq, B, H, sb, nseq) || !short_map(&tm_k, k, Sk, B, H, sb, nseq) ||
      !short_map(&tm_v, v, Sk, B, H, sb, nseq) || !short_map(&tm_o, o, Sq, B, H, sb, nseq) ||
      !short_map(&tm_do, dout, Sq, B, H, sb, nseq) || !short_map(&tm_dq, dq, Sq, B, H, 16, 1) ||
      !short_map(&tm_dk, dk, Sk, B, H, 16, 1) || !short_map(&tm_dv, dv, Sk, B, H, 16, 1))
    return (int)cudaErrorInvalidValue;
  auto kernel = sb == 64 ? attn_bwd_short_kernel<64> : attn_bwd_short_kernel<32>;
  // more than 48 KB of dynamic shared memory: allowed once per instance
  static bool opted_in[2] = {false, false};
  if (!opted_in[sb == 64]) {
    if (cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              smem))
      return (int)e;
    opted_in[sb == 64] = true;
  }
  kernel<<<blocks, SH_THREADS, smem, (cudaStream_t)stream>>>(
      tm_q, tm_k, tm_v, tm_o, tm_do, tm_dq, tm_dk, tm_dv, (const float*)lse, B, Sq, H, kv_len,
      scale, scale * LOG2E);
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

// Then the wgmma route: dq (like q), dk, dv (like k) from q, dout (B, Sq,
// H*64), k, v (B, Sk, H*64) bf16 and the rows; 1 <= kv_len <= Sk; Sq_pad =
// Sq rounded up to 128; every pointer 16-byte aligned:
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
