// K1 attention: non-causal multi-head attention on the packed layout
// q (B, Sq, H*64), k and v (B, Sk, H*64), out (B, Sq, H*64), bf16, with an
// optional valid-key length (keys at or past it are masked out).
//
// Replaces, from the JAX package:
//   - vista_tpu/ops/flash_attention.py _flash_kernel (flash_attention_packed,
//     the spatial attention at s >= 2048);
//   - vista_tpu/ops/tiny_attention.py  _tiny_kernel (tiny_attention_packed,
//     s <= 1024);
//   - the attention core of vista_tpu/ops/fused_temporal_attn.py _kernel
//     (t = 25 frame tokens, taken unpadded here).
//
// One block of 4 warps per (64 queries, batch row, head); each warp owns 16
// query rows. K/V tiles of 64 keys stream through shared memory; the scores
// stay in registers, with an online softmax (running max m and sum l in
// fp32) in the base-2 domain: the softmax scale times log2(e) is applied to
// the fp32 scores inside the kernel. P is rounded to bf16 for the P.V
// product, as in the TPU kernels. Bound on the H100: at head_dim 64 the
// exp2 work per score competes with the tensor cores (FlashAttention-2's
// regime); nothing of size S^2 reaches device memory. For t = 25 the block
// is mostly padding; that workload is small next to the spatial one.
//
// With a non-null ``lse`` (the training forward, the JAX want_lse path) it
// also writes the natural-log log-sum-exp of every query row's scaled
// scores, fp32 (B, H, Sq), the residual of csrc/attention_bwd.cu. That is a
// template instance of its own, so the inference kernel compiles exactly as
// it did before the output existed.
#include "common.cuh"

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

}  // namespace vk

// q (B, Sq, H*64), k and v (B, Sk, H*64), out like q; bf16, contiguous.
// lse: fp32 (B, H, Sq) or null. kv_len = number of keys attended (<= Sk).
// scale_log2 = scale * log2(e).
extern "C" int vk_attention(const void* q, const void* k, const void* v,
                            void* out, void* lse, int B, int Sq, int Sk, int H,
                            int kv_len, float scale_log2, void* stream) {
  dim3 grid(B * ((Sq + vk::AQ - 1) / vk::AQ), H);
  auto kernel = lse ? vk::attention_kernel<true> : vk::attention_kernel<false>;
  kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
      (const vk::bf16*)q, (const vk::bf16*)k, (const vk::bf16*)v,
      (vk::bf16*)out, (float*)lse, Sq, Sk, H, kv_len, scale_log2);
  return (int)cudaGetLastError();
}
