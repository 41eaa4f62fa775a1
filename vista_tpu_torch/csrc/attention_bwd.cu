// attention_bwd: the gradient of K1 (csrc/attention.cu) on the packed layout
// q, o, dO (B, Sq, H*64), k, v (B, Sk, H*64), bf16, from K1's fp32
// log-sum-exp (B, H, Sq). Keys at or past kv_len are masked as in K1, so the
// temporal t = 25 attention needs no padding; their dk and dv are zero.
//
// Replaces, from the JAX package:
//   - vista_tpu/ops/flash_attention.py _bwd_dq_kernel and _bwd_dkv_kernel
//     (_flash_bwd_packed, the spatial attention at s >= 2048);
//   - vista_tpu/ops/tiny_attention.py _tiny_bwd_kernel (_tiny_bwd_pallas,
//     s <= 1024 and the t = 25 temporal attention).
//
// One design for every length, FlashAttention-2 style, three launches:
//   1. D = rowsum(dO * O) per (row, head), fp32 (B, H, Sq): one warp each;
//   2. dK/dV: a block of 4 warps per (64 keys, batch row, head), each warp
//      owning 16 keys; K and V stay in registers as MMA fragments while the
//      Q, dO tiles of 64 queries stream through shared memory. Per tile:
//      S^T = K Q^T, P^T = exp2(S^T * scale*log2e - lse*log2e), dV += P^T dO,
//      dP^T = V dO^T, dS^T = P^T (dP^T - D), dK += dS^T Q;
//   3. dQ: a block per (64 queries, batch row, head), K and V tiles
//      streaming: S = Q K^T, P, dP = dO V^T, dS = P (dP - D), dQ += dS K.
// P and dS are rounded to bf16 for their products, as the TPU kernels do;
// accumulation is fp32. Nothing of size S^2 reaches device memory. Bound on
// the H100: at head_dim 64, 5 GEMMs of 64x64x64 per tile pair plus the exp2
// of every score (dK/dV and dQ each recompute P), the tensor-core work of
// FA2's backward; the bytes are O(S * d) per (row, head).
#include "common.cuh"

namespace vk {

constexpr int BQ = 64, BKV = 64, HD = 64;
constexpr int PS = HD + 8;  // padded smem row stride (bf16)

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

// D[b, h, q] = sum_d dO[b, q, h, d] * O[b, q, h, d]; one warp per (row, head).
__global__ void __launch_bounds__(256)
attn_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                      float* __restrict__ delta, int rows, int Sq, int H) {
  const int lane = threadIdx.x & 31;
  const long w = (long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (w >= (long)rows * H) return;
  const int row = (int)(w / H), h = (int)(w % H);
  const size_t off = (size_t)row * H * HD + h * HD + lane * 2;
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + off));
  const float2 d = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dout + off));
  const float s = warp_sum(a.x * d.x + a.y * d.y);
  if (lane == 0) {
    const int b = row / Sq, q = row - b * Sq;
    delta[((size_t)b * H + h) * Sq + q] = s;
  }
}

__global__ void __launch_bounds__(128)
attn_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ lse,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
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
  const float* lse_b = lse + ((size_t)b * H + h) * Sq;
  const float* d_b = delta + ((size_t)b * H + h) * Sq;
  for (int q0 = 0; q0 < Sq; q0 += BQ) {
    __syncthreads();  // the previous tiles (or the K/V staging) are read
    load_tile(Qs, q + (size_t)b * Sq * HDall, q0, Sq, HDall, h);
    load_tile(Ds, dout + (size_t)b * Sq * HDall, q0, Sq, HDall, h);
    for (int i = threadIdx.x; i < BQ; i += 128) {
      const bool ok = q0 + i < Sq;
      s_lse[i] = ok ? lse_b[q0 + i] * 1.4426950408889634f : INFINITY;
      s_d[i] = ok ? d_b[q0 + i] : 0.f;
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
                   const bf16* __restrict__ v, const float* __restrict__ lse,
                   const bf16* __restrict__ dout,
                   const float* __restrict__ delta, bf16* __restrict__ dq,
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
    const bool ok = qi < Sq;
    l2[r] = ok ? lse[((size_t)b * H + h) * Sq + qi] * 1.4426950408889634f : INFINITY;
    dd[r] = ok ? delta[((size_t)b * H + h) * Sq + qi] : 0.f;
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

}  // namespace vk

// q, o, dout (B, Sq, H*64), k, v (B, Sk, H*64) bf16; lse fp32 (B, H, Sq);
// delta fp32 (B, H, Sq) scratch; dq like q, dk, dv like k. kv_len <= Sk.
extern "C" int vk_attention_bwd(const void* q, const void* k, const void* v,
                                const void* o, const void* lse,
                                const void* dout, void* delta, void* dq,
                                void* dk, void* dv, int B, int Sq, int Sk,
                                int H, int kv_len, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long pairs = (long)B * Sq * H;
  vk::attn_bwd_delta_kernel<<<(unsigned)((pairs + 7) / 8), 256, 0, st>>>(
      (const vk::bf16*)o, (const vk::bf16*)dout, (float*)delta, B * Sq, Sq, H);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const float scale_log2 = scale * 1.4426950408889634f;
  dim3 gkv(B * ((Sk + vk::BKV - 1) / vk::BKV), H);
  vk::attn_bwd_dkv_kernel<<<gkv, 128, 0, st>>>(
      (const vk::bf16*)q, (const vk::bf16*)k, (const vk::bf16*)v,
      (const float*)lse, (const vk::bf16*)dout, (const float*)delta,
      (vk::bf16*)dk, (vk::bf16*)dv, Sq, Sk, H, kv_len, scale, scale_log2);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  dim3 gq(B * ((Sq + vk::BQ - 1) / vk::BQ), H);
  vk::attn_bwd_dq_kernel<<<gq, 128, 0, st>>>(
      (const vk::bf16*)q, (const vk::bf16*)k, (const vk::bf16*)v,
      (const float*)lse, (const vk::bf16*)dout, (const float*)delta,
      (vk::bf16*)dq, Sq, Sk, H, kv_len, scale, scale_log2);
  return (int)cudaGetLastError();
}
