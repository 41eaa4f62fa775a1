// K1 attention: non-causal multi-head attention on the packed layout
// q (B, Sq, H*64), k and v (B, Sk, H*64), out (B, Sq, H*64), bf16, with an
// optional valid-key length (keys at or past it are masked out). The
// softmax scale times log2(e) is applied to the fp32 scores inside the
// kernel, and the online softmax (running max m and sum l in fp32) works in
// the base-2 domain. P is rounded to bf16 for the P.V product, as in the TPU
// kernels. Nothing of size S^2 reaches device memory, and no sum uses
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
// mma.sync route (attention_kernel, at most the threshold's keys: the
// temporal t = 25 attention and the 45-key mid site at 320x576, where the
// measured crossover favours it). Replaces the attention core of vista_tpu/ops/fused_temporal_attn.py
// _kernel (t = 25 frame tokens, taken unpadded here) and _tiny_kernel at
// those sites. One block of 4 warps per (64 queries, batch row, head); each
// warp owns 16 query rows. K/V tiles of 64 keys stream through shared
// memory; the scores stay in registers. For t = 25 the block is mostly
// padding, and still beats the library call there.
#include "attention_wgmma.cuh"

namespace vk {

constexpr int AQ = 64, AK = 64, AD = 64;
constexpr int AS = AD + 8;  // padded smem row stride (bf16)

template <bool LSE>
__global__ void __launch_bounds__(128)
attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int H, int kv_len,
                 float scale_log2) {
  __shared__ __align__(16) bf16 Qs[AQ * AS];
  __shared__ __align__(16) bf16 Ks[AK * AS];
  __shared__ __align__(16) bf16 Vs[AK * AS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // blockIdx.x walks the q tiles of one batch row, then the next row, so
  // neighbouring blocks share K/V in L2; the batch has no 65535 grid limit.
  const int q_tiles = (Sq + AQ - 1) / AQ;
  const int b = blockIdx.x / q_tiles, q0 = (blockIdx.x % q_tiles) * AQ;
  const int h = blockIdx.y;
  const int HD = H * AD;

  for (int c = tid; c < AQ * 8; c += 128) {
    const int row = c >> 3, ch = (c & 7) * 8, qi = q0 + row;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (qi < Sq)
      val = *reinterpret_cast<const uint4*>(
          q + ((size_t)b * Sq + qi) * HD + h * AD + ch);
    *reinterpret_cast<uint4*>(&Qs[row * AS + ch]) = val;
  }
  __syncthreads();
  uint32_t qf[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const bf16* p = Qs + (warp * 16 + g) * AS + ks * 16 + t * 2;
    qf[ks][0] = ld32(p);
    qf[ks][1] = ld32(p + 8 * AS);
    qf[ks][2] = ld32(p + 8);
    qf[ks][3] = ld32(p + 8 * AS + 8);
  }

  float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};
  float oacc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[j][e] = 0.f;

  for (int k0 = 0; k0 < kv_len; k0 += AK) {
    __syncthreads();  // the previous K/V tile is no longer read
    for (int c = tid; c < AK * 8; c += 128) {
      const int row = c >> 3, ch = (c & 7) * 8, ki = k0 + row;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (ki < kv_len) {
        const size_t off = ((size_t)b * Sk + ki) * HD + h * AD + ch;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&Ks[row * AS + ch]) = kv;
      *reinterpret_cast<uint4*>(&Vs[row * AS + ch]) = vv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bf16* p = Ks + (j * 8 + g) * AS + ks * 16 + t * 2;
        const uint32_t bfr[2] = {ld32(p), ld32(p + 8)};
        mma_16816(s[j], qf[ks], bfr);
      }

    // Online softmax; rows g (e = 0, 1) and g + 8 (e = 2, 3).
    float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + t * 2 + (e & 1);
        s[j][e] = key < kv_len ? s[j][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      alpha[r] = exp2f(m_i[r] - mx[r]);
      m_i[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - mx[e >> 1]);
        rsum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_i[r] = l_i[r] * alpha[r] + rsum[r];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      oacc[j][0] *= alpha[0];
      oacc[j][1] *= alpha[0];
      oacc[j][2] *= alpha[1];
      oacc[j][3] *= alpha[1];
    }

    // O += P V: the score accumulators of key tiles 2kk, 2kk+1 are the A
    // fragment of the k16 step kk.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const bf16* vp = Vs + (kk * 16 + t * 2) * AS + g;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bf16* p = vp + j * 8;
        const uint32_t bfr[2] = {pack_raw(p[0], p[AS]),
                                 pack_raw(p[8 * AS], p[9 * AS])};
        mma_16816(oacc[j], pa, bfr);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
    const int qi = q0 + warp * 16 + g + r * 8;
    if (LSE && t == 0 && qi < Sq)
      lse[((size_t)b * H + h) * Sq + qi] =
          m_i[r] * 0.6931471805599453f + logf(l_i[r]);
    l_i[r] = 1.f / l_i[r];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + warp * 16 + g + r * 8;
    if (qi >= Sq) continue;
    bf16* orow = o + ((size_t)b * Sq + qi) * HD + h * AD + t * 2;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8) = pack_bf16(
          oacc[j][2 * r] * l_i[r], oacc[j][2 * r + 1] * l_i[r]);
  }
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
// attention_plan); each entry checks it against its kernel's decode. The
// mma.sync route, a (grid_x, grid_y) grid of 128 threads:
extern "C" int vk_attention(const void* q, const void* k, const void* v,
                            void* out, void* lse, int B, int Sq, int Sk, int H,
                            int kv_len, float scale_log2, int grid_x, int grid_y,
                            void* stream) {
  if (grid_x != B * ((Sq + vk::AQ - 1) / vk::AQ) || grid_y != H)
    return (int)cudaErrorInvalidValue;
  auto kernel = lse ? vk::attention_kernel<true> : vk::attention_kernel<false>;
  kernel<<<dim3(grid_x, grid_y), 128, 0, (cudaStream_t)stream>>>(
      (const vk::bf16*)q, (const vk::bf16*)k, (const vk::bf16*)v,
      (vk::bf16*)out, (float*)lse, Sq, Sk, H, kv_len, scale_log2);
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
