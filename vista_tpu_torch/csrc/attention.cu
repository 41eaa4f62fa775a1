// K1 attention: non-causal multi-head attention on the packed layout
// q (B, Sq, H*64), k and v (B, Sk, H*64), out (B, Sq, H*64), bf16, with an
// optional valid-key length (keys at or past it are masked out). The
// softmax scale times log2(e) is applied to the fp32 scores inside the
// kernel, and the softmax (max m and sum l in fp32; online over key tiles on
// the wgmma route) works in the base-2 domain. P is rounded to bf16 for the
// P.V product, as in the TPU kernels. Nothing of size S^2 reaches device memory, and no sum uses
// atomics: two launches give the same bits.
//
// With a non-null ``lse`` (the training forward, the JAX want_lse path) it
// also writes the natural-log log-sum-exp of every query row's scaled
// scores, fp32 (B, H, Sq), the residual of csrc/attention_bwd.cu. That is a
// template instance of its own, so the inference kernel carries no trace of
// it.
//
// Two routes, chosen by ops/attention.py attention_plan:
//
// wgmma route (attention_wgmma_kernel, more keys than the plan's threshold:
// every spatial self-attention of the UNet from 144 keys up). Replaces
// vista_tpu/ops/flash_attention.py _flash_kernel (flash_attention_packed,
// the spatial attention at s >= 2048) and vista_tpu/ops/tiny_attention.py
// _tiny_kernel (tiny_attention_packed, s <= 1024) at those sites.
//   - A block per (128 queries, batch row, head); query tile fastest, then
//     head, then batch row, so that the blocks that stream one (batch row,
//     head)'s K and V run side by side and find them in L2.
//   - A producer warpgroup gives its registers to the consumers
//     (setmaxnreg); one thread loads Q once by TMA and streams 128-key K and
//     V tiles through a ring of AW_STAGES 128B-swizzled stages under full and
//     empty mbarriers. Keys past Sk arrive as zeros and never read into the
//     next batch row (a 3-d map).
//   - Two consumer warpgroups own 64 query rows each. Per key tile:
//     S = Q K^T by SS wgmma m64n128k16 (4 k-steps, both K-major); the online
//     softmax in registers (row max over the quad by __shfl_xor, alpha =
//     exp2(m_old - m_new), P = exp2(S scale log2 e - m_new), l), the keys at
//     or past kv_len masked on the last tile only; O = alpha O; then
//     O += P V by RS wgmma m64n64k16 with P as bf16 register A fragments and
//     V read MN-major as stored (the transpose bit).
//   - Bound on the H100 at head_dim 64: the exp2 work equals the tensor-core
//     work. At ds1 576x1024 (2 frames, 9216 tokens, 5 heads): 2.17e11 flops
//     of products is 0.220 ms at 989 TFLOP/s, and 8.5e8 exp2 is 0.218 ms on
//     the special-function units (~3.9e12/s). So one warpgroup's softmax
//     has to run under the other's products: the two consumer warpgroups
//     take turns at the tensor cores (FlashAttention-3's ping-pong, named
//     barriers 1 and 2). A warpgroup's turn issues S_j = Q K_j^T, then
//     O += P_{j-1} V_{j-1}, and hands the tensor cores over; the softmax of
//     S_j runs as soon as S_j has retired, under P_{j-1} V_{j-1} and the
//     other warpgroup's turn (FA3's intra-warpgroup overlap), and O is
//     rescaled once P_{j-1} V_{j-1} has retired too. Every product retires
//     within its iteration: a wgmma left in flight across a loop iteration
//     made ptxas serialise every wgmma of a kernel (C7515,
//     csrc/attention_bwd.cu). Stage j is released once P_j V_j has run, in
//     the turn of tile j + 1.
//   - Epilogue: O / l rounded once to bf16 into the warpgroup's half of the
//     Q tile (its products are done) and stored by TMA; rows past Sq are
//     dropped. LSE = m ln 2 + log l for rows < Sq.
//
// short route (attention_short_kernel, at most the threshold's queries and
// keys: the temporal t = 25 attention and the 45-key mid site at 320x576).
// Replaces the attention core of vista_tpu/ops/fused_temporal_attn.py
// _kernel (t = 25 frame tokens, taken unpadded here) and _tiny_kernel at
// those sites. The layout, the persistent walk and the ring are
// csrc/attention_short.cuh's. Per unit, each consumer warp:
//   - S = Q K^T for its 16 query rows and the SB keys of its sequence
//     (mma.sync on ldmatrix fragments of the swizzled Q and K boxes);
//   - the whole-row softmax in base 2: keys at or past kv_len masked, the
//     row max over the quad by __shfl_xor, P = exp2(S scale log2 e - m),
//     l = sum P in fp32 (no online rescaling: the row is whole);
//   - O = P V with P rounded to bf16 and V read transposed by ldmatrix;
//     the stage is released here, so the producer refills it under the
//     epilogue;
//   - O / l rounded once to bf16 into the warp's 16-row staging box and
//     stored by TMA (rows past Sq and sequences past B dropped), and for
//     the training instance LSE = m ln 2 + log l, fp32, for rows < Sq.
#include "attention_short.cuh"

namespace vk {

constexpr int AD = 64;  // head width

// Shared memory (1024-aligned for the swizzle): the ring of (Q, K, V)
// stages, a staging box per consumer warp, the barriers (full and empty per
// stage).
template <int SB, bool LSE>
__global__ void __launch_bounds__(SH_THREADS, SH_BLOCKS_PER_SM)
attention_short_kernel(__grid_constant__ const CUtensorMap tm_q,
                       __grid_constant__ const CUtensorMap tm_k,
                       __grid_constant__ const CUtensorMap tm_v,
                       __grid_constant__ const CUtensorMap tm_o, float* __restrict__ lse,
                       int B, int Sq, int H, int kv_len, float scale_log2) {
  constexpr int NSEQ = SH_ROWS / SB, NT = SB / 8;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  Ring<SH_FWD_STAGES> ring;
  ring.base = (raw + 1023) & ~1023u;
  ring.bytes = SH_FWD_STAGE;
  const uint32_t staging = ring.base + SH_FWD_STAGES * SH_FWD_STAGE;
  ring.full0 = staging + SH_WARPS * SH_OUT_BOX;
  ring.empty0 = ring.full0 + 8 * SH_FWD_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < SH_FWD_STAGES; ++s) {
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
        mbar_wait(ring.empty(), ring.phase ^ 1);
        mbar_arrive_expect_tx(ring.full(), SH_FWD_STAGE);
        tma_load_3d(ring.tile(), &tm_q, ring.full(), h * AD, 0, b0);
        tma_load_3d(ring.tile() + SH_BOX, &tm_k, ring.full(), h * AD, 0, b0);
        tma_load_3d(ring.tile() + 2 * SH_BOX, &tm_v, ring.full(), h * AD, 0, b0);
        ring.advance();
      }
    }
    return;
  }
  const int g = lane >> 2, t = lane & 3;
  const int R0 = 16 * warp, j = R0 / SB, r0 = R0 % SB, J0 = j * SB;
  const uint32_t out = staging + warp * SH_OUT_BOX;
  uint8_t* out_ptr = smem_raw + (out - raw);
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int h = u % H, b = u / H * NSEQ + j;
    mbar_wait(ring.full(), ring.phase);
    const uint32_t qb = ring.tile(), kb = qb + SH_BOX, vb = kb + SH_BOX;
    uint32_t qf[4][4];
    sh_a_frags(qb, R0, qf);
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    sh_scores<SB>(s, qf, kb, J0);

    // rows g (e = 0, 1) and g + 8 (e = 2, 3); keys 8 nt + 2 t + (e & 1)
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * nt + 2 * t + (e & 1);
        s[nt][e] = key < kv_len ? s[nt][e] * scale_log2 : -INFINITY;
        m[e >> 1] = fmaxf(m[e >> 1], s[nt][e]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // key 0 is live: the max is finite
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = ex2(s[nt][e] - m[e >> 1]);
        l[e >> 1] += s[nt][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    uint32_t pf[NT / 2][4];
    sh_pack<NT / 2>(s, pf);
    float o[8][4];
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
    sh_accumulate<SB>(o, pf, vb, J0);  // O = P V
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty());  // this warp has read Q, K and V
    ring.advance();

    if (LSE && t == 0 && b < B) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + g + 8 * r;
        if (row < Sq) lse[((size_t)b * H + h) * Sq + row] = m[r] * 0.6931471805599453f + logf(l[r]);
      }
    }
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
    if (lane == 0) bulk_wait_read<0>();  // the previous unit's store has read the box
    __syncwarp();
    sh_store_rows(out_ptr, 0, o, inv);
    fence_async_smem();
    __syncwarp();
    if (lane == 0) {
      tma_store_3d(&tm_o, out, h * AD, r0, b);
      bulk_commit();
    }
  }
  if (lane == 0) bulk_wait_read<0>();
}

// ---- the wgmma route

constexpr int AW = 128;  // queries per block (64 per consumer warpgroup), keys per stage
constexpr int AW_STAGES = 4;
constexpr int AW_TILE = AW * AD * 2;  // one 128 x 64 bf16 TMA box, 16 KB
constexpr int AW_STAGE = 2 * AW_TILE;  // K, V
constexpr int AW_CONSUMER_WARPS = 8;
constexpr int AW_THREADS = AW_CONSUMER_WARPS * 32 + 128;
constexpr int AW_BAR_BYTES = 8 * (1 + 2 * AW_STAGES);
constexpr int AW_SMEM = 1024 + AW_TILE + AW_STAGES * AW_STAGE + AW_BAR_BYTES;

// The online softmax of the scores s of key tile i (keys k0 = 128 i ..):
// this thread's accumulator columns are keys k0 + 8 j + 2 t + e, its rows
// 16 w + g + 8 u. Leaves P in s, updates the running max m and the thread's
// part of the sum l, and returns in alpha the factor that takes O from the
// old max to the new one (applied once O's last product has retired).
__device__ __forceinline__ void online_softmax(float (&s)[64], float (&alpha)[2], float (&m)[2],
                                               float (&l)[2], int k0, int kv_len,
                                               float scale_log2, int t) {
  if (k0 + AW > kv_len) {  // the last tile: keys at or past kv_len are masked
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (k0 + 8 * j + 2 * t + e >= kv_len) s[4 * j + 2 * u + e] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY}, rsum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u)
      mx[u] = fmaxf(mx[u], fmaxf(s[4 * j + 2 * u], s[4 * j + 2 * u + 1]));
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 1));
    mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 2));
    // every row has a live key in every tile, so the new max is finite
    const float m_new = fmaxf(m[u], mx[u] * scale_log2);
    alpha[u] = ex2(m[u] - m_new);
    m[u] = m_new;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * u + e];
        x = ex2(fmaf(x, scale_log2, -m[u]));
        rsum[u] += x;
      }
#pragma unroll
  for (int u = 0; u < 2; ++u) l[u] = l[u] * alpha[u] + rsum[u];
}

// O = alpha O; P as the bf16 A fragments of the next P V.
__device__ __forceinline__ void rescale_and_pack(float (&o)[32], uint32_t (&pf)[8][4],
                                                 const float (&s)[64], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      o[4 * j + 2 * u] *= alpha[u];
      o[4 * j + 2 * u + 1] *= alpha[u];
    }
  acc_to_frags(s, pf);
}

// Keeps the compiler from moving reads or writes of a product's registers
// across the wait that retires it.
template <int N>
__device__ __forceinline__ void reg_fence_all(float (&r)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) reg_fence(r[e]);
}

__device__ __forceinline__ void reg_fence_all(uint32_t (&f)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) reg_fence(f[kk][e]);
}

// Shared memory (1024-aligned for the swizzle): the Q tile, the ring of K/V
// stages, then the barriers (Q's, full and empty per stage).
template <bool LSE>
__global__ void __launch_bounds__(AW_THREADS, 1)
attention_wgmma_kernel(__grid_constant__ const CUtensorMap tm_q,
                       __grid_constant__ const CUtensorMap tm_k,
                       __grid_constant__ const CUtensorMap tm_v,
                       __grid_constant__ const CUtensorMap tm_o, float* __restrict__ lse,
                       int Sq, int H, int kv_len, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_tile = (smem_u32(smem_raw) + 1023) & ~1023u;
  Ring<AW_STAGES> ring;
  ring.base = q_tile + AW_TILE;
  ring.bytes = AW_STAGE;
  const uint32_t q_bar = ring.base + AW_STAGES * AW_STAGE;
  ring.full0 = q_bar + 8;
  ring.empty0 = ring.full0 + 8 * AW_STAGES;
  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < AW_STAGES; ++s) {
      mbar_init(ring.full0 + 8 * s, 1);
      mbar_init(ring.empty0 + 8 * s, AW_CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q_tiles = (Sq + AW - 1) / AW;
  const int bh = blockIdx.x / q_tiles, q0 = (blockIdx.x % q_tiles) * AW;
  const int h = bh % H, b = bh / H;
  const int n_k = (kv_len + AW - 1) / AW;

  if (warp >= AW_CONSUMER_WARPS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (warp == AW_CONSUMER_WARPS && lane == 0) {
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      mbar_arrive_expect_tx(q_bar, AW_TILE);
      tma_load_3d(q_tile, &tm_q, q_bar, h * AD, q0, b);
      for (int i = 0; i < n_k; ++i) {
        mbar_wait(ring.empty(), ring.phase ^ 1);
        mbar_arrive_expect_tx(ring.full(), AW_STAGE);
        tma_load_3d(ring.tile(), &tm_k, ring.full(), h * AD, i * AW, b);
        tma_load_3d(ring.tile() + AW_TILE, &tm_v, ring.full(), h * AD, i * AW, b);
        ring.advance();
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const uint32_t qa = q_tile + wg * (AW_TILE / 2);
  float o[32], s[64], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  uint32_t pf[8][4];
#pragma unroll
  for (int e = 0; e < 32; ++e) o[e] = 0.f;

  // Turns at the tensor cores: barrier 1 + wg is this warpgroup's, which
  // the other warpgroup opens with a bar.arrive once it has issued its
  // products. Warpgroup 0 takes the first turn; warpgroup 1 opens no turn
  // after its last, so that no arrival is left over at exit. A turn issues
  // S_i = Q K_i^T, then O += P_{i-1} V_{i-1}; the softmax of S_i runs once
  // S_i has retired, under P_{i-1} V_{i-1} and the other warpgroup's turn,
  // and O is rescaled once P_{i-1} V_{i-1} has retired too. Every product
  // retires within its iteration, and the first turn (S_0) and the last (P V
  // of the last tile) are peeled off the loop: a wgmma under a branch made
  // ptxas serialise them all (C7520).
  const int mine = 1 + wg, theirs = 2 - wg;
  float alpha[2];
  if (wg == 1) bar_arrive(theirs, 2 * 128);
  mbar_wait(q_bar, 0);
  Ring<AW_STAGES> held = ring;  // the stage of the tile whose P V is next
  mbar_wait(ring.full(), ring.phase);
  bar_named(mine, 2 * 128);
  wgmma_fence();
  wb_scores(s, qa, ring.tile());  // S_0 = Q K_0^T
  wgmma_commit();
  bar_arrive(theirs, 2 * 128);
  wgmma_wait<0>();
  reg_fence_all(s);
  online_softmax(s, alpha, m, l, 0, kv_len, scale_log2, t);
  rescale_and_pack(o, pf, s, alpha);
  ring.advance();
  for (int i = 1; i < n_k; ++i) {
    mbar_wait(ring.full(), ring.phase);
    bar_named(mine, 2 * 128);
    wgmma_fence();
    wb_scores(s, qa, ring.tile());  // S_i = Q K_i^T
    wgmma_commit();
    wb_accumulate(o, pf, held.tile() + AW_TILE);  // O += P_{i-1} V_{i-1}
    wgmma_commit();
    bar_arrive(theirs, 2 * 128);
    wgmma_wait<1>();
    reg_fence_all(s);
    online_softmax(s, alpha, m, l, i * AW, kv_len, scale_log2, t);
    wgmma_wait<0>();
    reg_fence_all(o);
    reg_fence_all(pf);
    __syncwarp();  // P_{i-1} V_{i-1} has run: stage i - 1 is free
    if (lane == 0) mbar_arrive(held.empty());
    held.advance();
    rescale_and_pack(o, pf, s, alpha);
    ring.advance();
  }
  bar_named(mine, 2 * 128);
  wgmma_fence();
  wb_accumulate(o, pf, held.tile() + AW_TILE);  // O += P_{n-1} V_{n-1}
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence_all(o);
  reg_fence_all(pf);
  if (wg == 0) bar_arrive(theirs, 2 * 128);

  // rows 16 w + g + 8 u of this warpgroup's 64 queries
  const int row0 = 16 * (warp & 3) + g;
  float inv[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    l[u] += __shfl_xor_sync(0xffffffffu, l[u], 1);
    l[u] += __shfl_xor_sync(0xffffffffu, l[u], 2);
    const int qi = q0 + 64 * wg + row0 + 8 * u;
    if (LSE && t == 0 && qi < Sq)
      lse[(size_t)bh * Sq + qi] = m[u] * 0.6931471805599453f + logf(l[u]);
    inv[u] = 1.f / l[u];
  }
  // O into this warpgroup's half of the Q tile, 128B-swizzled as TMA reads
  // it (chunk j of row r at r 128 + (j ^ r % 8) 16: no bank conflicts)
  uint8_t* half = smem_raw + (qa - smem_u32(smem_raw));
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int r = row0 + 8 * u;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(half + r * 128 + ((j ^ (r & 7)) << 4) + 4 * t) =
          pack_bf16(o[4 * j + 2 * u] * inv[u], o[4 * j + 2 * u + 1] * inv[u]);
  }
  fence_async_smem();
  bar_named(3 + wg, 128);
  if ((threadIdx.x & 127) == 0) {
    tma_store_3d(&tm_o, qa, h * AD, q0 + 64 * wg, b);
    bulk_commit();
    bulk_wait_read<0>();
  }
}

}  // namespace vk

// q (B, Sq, H*64), k and v (B, Sk, H*64), out like q; bf16, contiguous.
// lse: fp32 (B, H, Sq) or null. kv_len = number of keys attended (<= Sk).
// scale_log2 = scale * log2(e). The launch is the plan's (ops/attention.py
// attention_plan); each entry checks it against its kernel's walk and
// shared memory (every pointer 16-byte aligned). The short route (Sq, Sk
// <= 64), a persistent grid of `blocks` blocks of SH_THREADS walking the
// units (group of 64 / SB sequences, head), with `smem` bytes of dynamic
// shared memory:
extern "C" int vk_attention_short(const void* q, const void* k, const void* v, void* out,
                                  void* lse, int B, int Sq, int Sk, int H, int kv_len,
                                  float scale_log2, int blocks, int smem, void* stream) {
  using namespace vk;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || Sq > SH_ROWS || Sk > SH_ROWS || kv_len < 1 ||
      kv_len > Sk || smem != SH_FWD_SMEM ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out | (uintptr_t)lse) % 16)
    return (int)cudaErrorInvalidValue;
  const int sb = sh_frames(Sq > Sk ? Sq : Sk), nseq = SH_ROWS / sb;
  const long units = (long)((B + nseq - 1) / nseq) * H;
  if (blocks < 1 || blocks > units) return (int)cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (!short_map(&tm_q, q, Sq, B, H, sb, nseq) || !short_map(&tm_k, k, Sk, B, H, sb, nseq) ||
      !short_map(&tm_v, v, Sk, B, H, sb, nseq) || !short_map(&tm_o, out, Sq, B, H, 16, 1))
    return (int)cudaErrorInvalidValue;
  const int which = (sb == 64) * 2 + (lse != nullptr);
  void (*const kernels[4])(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, float*, int,
                           int, int, int, float) = {
      attention_short_kernel<32, false>, attention_short_kernel<32, true>,
      attention_short_kernel<64, false>, attention_short_kernel<64, true>};
  // more than 48 KB of dynamic shared memory: allowed once per instance
  static bool opted_in[4] = {false, false, false, false};
  if (!opted_in[which]) {
    if (cudaError_t e = cudaFuncSetAttribute(kernels[which],
                                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
      return (int)e;
    opted_in[which] = true;
  }
  kernels[which]<<<blocks, SH_THREADS, smem, (cudaStream_t)stream>>>(
      tm_q, tm_k, tm_v, tm_o, (float*)lse, B, Sq, H, kv_len, scale_log2);
  return (int)cudaGetLastError();
}

// The wgmma route, `blocks` blocks of AW_THREADS with `smem` bytes of
// dynamic shared memory (every pointer 16-byte aligned):
extern "C" int vk_attention_wgmma(const void* q, const void* k, const void* v, void* out,
                                  void* lse, int B, int Sq, int Sk, int H, int kv_len,
                                  float scale_log2, int blocks, int smem, void* stream) {
  using namespace vk;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || kv_len < 1 || kv_len > Sk ||
      (long)blocks != (long)B * H * ((Sq + AW - 1) / AW) || smem != AW_SMEM ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out | (uintptr_t)lse) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (!attn_map(&tm_q, q, Sq, B, H, AW) || !attn_map(&tm_k, k, Sk, B, H, AW) ||
      !attn_map(&tm_v, v, Sk, B, H, AW) || !attn_map(&tm_o, out, Sq, B, H, AW / 2))
    return (int)cudaErrorInvalidValue;
  auto kernel = lse ? attention_wgmma_kernel<true> : attention_wgmma_kernel<false>;
  // more than 48 KB of dynamic shared memory: allowed once per instance
  static bool opted_in[2] = {false, false};
  if (!opted_in[lse != nullptr]) {
    if (cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              smem))
      return (int)e;
    opted_in[lse != nullptr] = true;
  }
  kernel<<<blocks, AW_THREADS, smem, (cudaStream_t)stream>>>(
      tm_q, tm_k, tm_v, tm_o, (float*)lse, Sq, H, kv_len, scale_log2);
  return (int)cudaGetLastError();
}
