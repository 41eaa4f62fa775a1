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
//      [a | g] = xn W1^T + b1 (W1 rows of a value column and its gate
//      interleaved, as in K2) and dhg = dy W2 in a second main loop, then
//      hg = a * gelu(g), da = dhg * gelu(g), dg = dhg * a * gelu'(g);
//      writes hg (M, 4c) and dH = [da | dg] (M, 8c), bf16;
//   2. dxn = dH W1 (fp32, M x c), the product feeding the LN backward,
//      which needs whole rows: vk_seg_gemm of csrc/qkv_bwd.cu with one
//      segment (the caller launches it);
//   3. ln_bwd: one warp per row recomputes mean and rstd, then
//      dx = rstd (dxn*gamma - mean(dxn*gamma) - xhat mean(dxn*gamma*xhat))
//      + dy (the residual), and per-block partial column sums of dxn * xhat
//      (dgamma) and dxn (dbeta);
//   4. wgrad (weight grads only): dW1 = dH^T xn and dW2 = dy^T hg, the
//      contraction over all M tokens split into S ranges, each block
//      writing an fp32 partial (S, N1, N2);
//   5. col_sum: db1 = colsum(dH), db2 = colsum(dy) as per-range partials;
//   6. sum_splits: adds the partials of 3-5 in a fixed order. Every
//      reduction is deterministic: no atomics.
//
// Bound on the H100: the products (2 * M * c * 8c for [a|g], 2 * M * c * 4c
// for dhg, 2 * M * 8c * c for dxn, 2 * M * c * 8c + 2 * M * c * 4c for the
// weight grads) make it tensor-core bound at every UNet width; dH
// (M x 8c bf16) is the one large intermediate in device memory.
#include "common.cuh"

namespace vk {

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
}

__device__ __forceinline__ float gelu_erf_grad(float x) {
  return 0.5f * (1.f + erff(x * 0.7071067811865476f)) +
         x * 0.3989422804014327f * __expf(-0.5f * x * x);
}

// 1. hg and dH; xn, dy (M, C); w1 (2N, C); w2t = W2^T (N, C); b1 (2N) fp32.
__global__ void __launch_bounds__(GEMM_THREADS)
ff_bwd_dh_kernel(const bf16* __restrict__ xn, const bf16* __restrict__ dy,
                 const bf16* __restrict__ w1, const bf16* __restrict__ w2t,
                 const float* __restrict__ b1, bf16* __restrict__ hg,
                 bf16* __restrict__ dh, int M, int C, int N) {
  __shared__ __align__(16) GemmSmem sm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = blockIdx.x * BM, o0 = blockIdx.y * (BN / 2);
  auto rows_of = [&](const bf16* a) {
    return [=](int row, int k) -> uint4 {
      const int m = m0 + row;
      if (m >= M) return make_uint4(0, 0, 0, 0);
      return *reinterpret_cast<const uint4*>(a + (size_t)m * C + k);
    };
  };
  // Tile column 32 * wn + l: inner column o0 + 16 * wn + (l % 16); for the
  // first product, l < 16 reads its value row of W1 and l >= 16 its gate
  // row; for the second, both halves read the same row of W2^T.
  auto w1_rows = [&](int row, int k) -> uint4 {
    const int l = row & 31, o = o0 + (row >> 5) * 16 + (l & 15);
    const int src = l < 16 ? o : N + o;
    return *reinterpret_cast<const uint4*>(w1 + (size_t)src * C + k);
  };
  auto w2_rows = [&](int row, int k) -> uint4 {
    const int o = o0 + (row >> 5) * 16 + (row & 15);
    return *reinterpret_cast<const uint4*>(w2t + (size_t)o * C + k);
  };
  float acc[4][4][4], dacc[4][4][4];
  gemm_mainloop(C, rows_of(xn), w1_rows, sm, acc);
  gemm_mainloop(C, rows_of(dy), w2_rows, sm, dacc);

  const int g = lane >> 2, t = lane & 3, wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 64 + i * 16 + g + half * 8;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int o = o0 + wn * 16 + j * 8 + t * 2;
        float h[2], da[2], dg[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float a = acc[i][j][half * 2 + q] + b1[o + q];
          const float gt = acc[i][j + 2][half * 2 + q] + b1[N + o + q];
          const float dhg = dacc[i][j][half * 2 + q];
          const float ge = gelu_erf(gt);
          h[q] = a * ge;
          da[q] = dhg * ge;
          dg[q] = dhg * a * gelu_erf_grad(gt);
        }
        *reinterpret_cast<uint32_t*>(hg + (size_t)m * N + o) = pack_bf16(h[0], h[1]);
        *reinterpret_cast<uint32_t*>(dh + (size_t)m * 2 * N + o) = pack_bf16(da[0], da[1]);
        *reinterpret_cast<uint32_t*>(dh + (size_t)m * 2 * N + N + o) =
            pack_bf16(dg[0], dg[1]);
      }
    }
}

// 3. LayerNorm backward; one warp per row, rows [r0, r1) per block; a row of
// C <= 1280 is held as up to 5 chunks of 8 per lane.
constexpr int LN_CHUNKS = 5;

__global__ void __launch_bounds__(256)
ln_bwd_kernel(const bf16* __restrict__ x, const float* __restrict__ dxn,
              const float* __restrict__ gamma, const bf16* __restrict__ dres,
              bf16* __restrict__ dx, float* __restrict__ dgamma_part,
              float* __restrict__ dbeta_part, int M, int C, int rows_per_block,
              float eps) {
  __shared__ float s_dg[1280], s_db[1280];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunks = C / 8;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(M, r0 + rows_per_block);
  float pg[LN_CHUNKS][8], pb[LN_CHUNKS][8];
#pragma unroll
  for (int c = 0; c < LN_CHUNKS; ++c)
#pragma unroll
    for (int e = 0; e < 8; ++e) pg[c][e] = pb[c][e] = 0.f;

  for (int r = r0 + warp; r < r1; r += 8) {
    float xv[LN_CHUNKS][8], gv[LN_CHUNKS][8];
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int c = 0; c < LN_CHUNKS; ++c) {
      const int ch = lane + 32 * c;
      if (ch >= chunks) break;
      unpack8(*reinterpret_cast<const uint4*>(x + (size_t)r * C + ch * 8), xv[c]);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s += xv[c][e];
        ss += xv[c][e] * xv[c][e];
      }
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mean = s / C;
    const float rstd = rsqrtf(fmaxf(ss / C - mean * mean, 0.f) + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < LN_CHUNKS; ++c) {
      const int ch = lane + 32 * c;
      if (ch >= chunks) break;
      const float* dr = dxn + (size_t)r * C + ch * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float xh = (xv[c][e] - mean) * rstd;
        const float d = dr[e];
        pg[c][e] += d * xh;
        pb[c][e] += d;
        gv[c][e] = d * gamma[ch * 8 + e];
        xv[c][e] = xh;
        s1 += gv[c][e];
        s2 += gv[c][e] * xh;
      }
    }
    s1 = warp_sum(s1) / C;
    s2 = warp_sum(s2) / C;
#pragma unroll
    for (int c = 0; c < LN_CHUNKS; ++c) {
      const int ch = lane + 32 * c;
      if (ch >= chunks) break;
      float o[8], rv[8];
      if (dres)
        unpack8(*reinterpret_cast<const uint4*>(dres + (size_t)r * C + ch * 8), rv);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        o[e] = rstd * (gv[c][e] - s1 - xv[c][e] * s2) + (dres ? rv[e] : 0.f);
      *reinterpret_cast<uint4*>(dx + (size_t)r * C + ch * 8) = pack8(o);
    }
  }
  if (!dgamma_part) return;
  // Fixed-order reduction of the 8 warps' partials through shared memory.
  for (int w = 0; w < 8; ++w) {
    if (warp == w) {
#pragma unroll
      for (int c = 0; c < LN_CHUNKS; ++c) {
        const int ch = lane + 32 * c;
        if (ch >= chunks) break;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int col = ch * 8 + e;
          s_dg[col] = (w ? s_dg[col] : 0.f) + pg[c][e];
          s_db[col] = (w ? s_db[col] : 0.f) + pb[c][e];
        }
      }
    }
    __syncthreads();
  }
  for (int col = threadIdx.x; col < C; col += 256) {
    dgamma_part[(size_t)blockIdx.x * C + col] = s_dg[col];
    dbeta_part[(size_t)blockIdx.x * C + col] = s_db[col];
  }
}

// 4. part[s] (N1, N2) fp32 = sum over m in split s of A[m, n1] B[m, n2];
// A (M, N1), B (M, N2) bf16 row-major; N1, N2 % 8 == 0. The tiles are
// staged transposed (token index along the smem row) for mma_slice.
__global__ void __launch_bounds__(GEMM_THREADS)
wgrad_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
             float* __restrict__ part, int M, int N1, int N2,
             int m_per_split) {
  __shared__ __align__(16) GemmSmem sm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int n10 = blockIdx.x * BM, n20 = blockIdx.y * BN;
  const int mbeg = blockIdx.z * m_per_split;
  const int mend = min(M, mbeg + m_per_split);
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // 32 tokens x 128 columns per operand: 512 chunks of 8, two per thread.
  auto fetch = [&](const bf16* src, int ncols, int c0, int m0, int c, uint4& v) {
    const int k = c >> 4, n8 = (c & 15) * 8, m = m0 + k, n = c0 + n8;
    v = (m < mend && n < ncols)
            ? *reinterpret_cast<const uint4*>(src + (size_t)m * ncols + n)
            : make_uint4(0, 0, 0, 0);
  };
  auto stage = [&](bf16* dst, int c, const uint4& v) {
    const int k = c >> 4, n8 = (c & 15) * 8;
    const bf16* h = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[(n8 + e) * SK + k] = h[e];
  };
  uint4 ra[2], rb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    fetch(a, N1, n10, mbeg, tid + r * GEMM_THREADS, ra[r]);
    fetch(b, N2, n20, mbeg, tid + r * GEMM_THREADS, rb[r]);
  }
  for (int m0 = mbeg; m0 < mend; m0 += BK) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      stage(sm.a, tid + r * GEMM_THREADS, ra[r]);
      stage(sm.b, tid + r * GEMM_THREADS, rb[r]);
    }
    __syncthreads();
    if (m0 + BK < mend) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        fetch(a, N1, n10, m0 + BK, tid + r * GEMM_THREADS, ra[r]);
        fetch(b, N2, n20, m0 + BK, tid + r * GEMM_THREADS, rb[r]);
      }
    }
    mma_slice(sm.a, sm.b, acc, wm, wn, lane);
    __syncthreads();
  }
  const int g = lane >> 2, t = lane & 3;
  float* dst = part + (size_t)blockIdx.z * N1 * N2;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n1 = n10 + wm * 64 + i * 16 + g + half * 8;
      if (n1 >= N1) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n2 = n20 + wn * 32 + j * 8 + t * 2;
        if (n2 >= N2) continue;
        *reinterpret_cast<float2*>(dst + (size_t)n1 * N2 + n2) =
            make_float2(acc[i][j][half * 2], acc[i][j][half * 2 + 1]);
      }
    }
}

// 5. part[s, n] = sum over rows in split s of A[m, n]; one thread per column.
__global__ void __launch_bounds__(256)
col_sum_kernel(const bf16* __restrict__ a, float* __restrict__ part, int M,
               int N, int m_per_split) {
  const int n = blockIdx.x * 256 + threadIdx.x;
  if (n >= N) return;
  const int mbeg = blockIdx.y * m_per_split, mend = min(M, mbeg + m_per_split);
  float s = 0.f;
  for (int m = mbeg; m < mend; ++m) s += __bfloat162float(a[(size_t)m * N + n]);
  part[(size_t)blockIdx.y * N + n] = s;
}

// 6. out[i] = sum_s part[s, i], in order of s.
__global__ void __launch_bounds__(256)
sum_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                  int S, long L) {
  const long i = (long)blockIdx.x * 256 + threadIdx.x;
  if (i >= L) return;
  float s = 0.f;
  for (int k = 0; k < S; ++k) s += part[(size_t)k * L + i];
  out[i] = s;
}

}  // namespace vk

using vk::bf16;

// 1. xn, dy (M, C); w1 (2N, C); w2t (N, C); b1 (2N) fp32 -> hg (M, N),
// dh (M, 2N). C % 32 == 0, N % 64 == 0.
extern "C" int vk_ff_bwd_dh(const void* xn, const void* dy, const void* w1,
                            const void* w2t, const void* b1, void* hg,
                            void* dh, int M, int C, int N, void* stream) {
  dim3 grid((M + vk::BM - 1) / vk::BM, N / (vk::BN / 2));
  vk::ff_bwd_dh_kernel<<<grid, vk::GEMM_THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)xn, (const bf16*)dy, (const bf16*)w1, (const bf16*)w2t,
      (const float*)b1, (bf16*)hg, (bf16*)dh, M, C, N);
  return (int)cudaGetLastError();
}

// 3. x (M, C) bf16, dxn (M, C) fp32, gamma (C) fp32, dres (M, C) bf16 or
// null -> dx (M, C) bf16 and, unless null, partials (blocks, C) fp32.
// C % 8 == 0, C <= 1280.
extern "C" int vk_ln_bwd(const void* x, const void* dxn, const void* gamma,
                         const void* dres, void* dx, void* dgamma_part,
                         void* dbeta_part, int M, int C, int blocks,
                         float eps, void* stream) {
  const int rows_per_block = (M + blocks - 1) / blocks;
  vk::ln_bwd_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)dxn, (const float*)gamma,
      (const bf16*)dres, (bf16*)dx, (float*)dgamma_part, (float*)dbeta_part,
      M, C, rows_per_block, eps);
  return (int)cudaGetLastError();
}

// 4. part (S, N1, N2) fp32 from a (M, N1), b (M, N2) bf16; splits of
// m_per_split rows (a multiple of 32). N1, N2 % 8 == 0.
extern "C" int vk_wgrad(const void* a, const void* b, void* part, int M,
                        int N1, int N2, int splits, int m_per_split,
                        void* stream) {
  dim3 grid((N1 + vk::BM - 1) / vk::BM, (N2 + vk::BN - 1) / vk::BN, splits);
  vk::wgrad_kernel<<<grid, vk::GEMM_THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)a, (const bf16*)b, (float*)part, M, N1, N2, m_per_split);
  return (int)cudaGetLastError();
}

// 5. part (S, N) fp32 from a (M, N) bf16.
extern "C" int vk_col_sum(const void* a, void* part, int M, int N, int splits,
                          int m_per_split, void* stream) {
  dim3 grid((N + 255) / 256, splits);
  vk::col_sum_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const bf16*)a, (float*)part, M, N, m_per_split);
  return (int)cudaGetLastError();
}

// 6. out (L) fp32 = sum over S of part (S, L).
extern "C" int vk_sum_splits(const void* part, void* out, int S, long L,
                             void* stream) {
  vk::sum_splits_kernel<<<(unsigned)((L + 255) / 256), 256, 0,
                          (cudaStream_t)stream>>>((const float*)part,
                                                  (float*)out, S, L);
  return (int)cudaGetLastError();
}
