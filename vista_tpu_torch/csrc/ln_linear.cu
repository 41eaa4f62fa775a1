// K2 ln_linear: row LayerNorm feeding a bf16 tensor-core GEMM against a
// torch-layout weight W (N, K), with a q/k/v split or a GEGLU epilogue.
//
// Replaces, from the JAX package:
//   - vista_tpu/ops/fused_qkv.py  _qkv_kernel (fused_ln_qkv): epilogue "split"
//     writes q, k, v as one (splits, M, N / splits) tensor;
//   - vista_tpu/ops/fused_ff.py   _ff_kernel, first half (LN -> proj_in ->
//     GEGLU): epilogue "geglu" writes a * gelu(g) + bias, (M, N);
//   - vista_tpu/ops/fused_temporal_attn.py _kernel, the LN + q/k/v part.
//
// What bounds it on the H100: K = c is small (320..1280) against M = 50 h w
// rows. Split at c = 320 moves 1.2 GB (x once, q/k/v out) for 0.28 TFLOP:
// bytes. GEGLU moves as much for 0.76 TFLOP: operations. Either way the
// design has to read x from HBM about once, keep the tensor cores fed
// through a short K loop, and never write xn or the 2N-wide proj_in output.
//
// Design, for Hopper:
//   - LayerNorm statistics once per row per call: a pre-pass kernel (one
//     warp per row) writes fp32 (mean, rstd), M x 8 bytes; one extra read of
//     x. Chosen over a block that keeps its row panel in shared memory
//     because a 128 x K panel is 320 KB at K = 1280, and the pass costs
//     about a tenth of the main kernel's time.
//   - A persistent kernel, one block per SM, walks 128 x 256 output tiles
//     row panel by row panel (every column tile of a panel, then the next
//     panel), so the blocks in flight share a few panels of x in L2 and x
//     comes from HBM about once; W stays in L2.
//   - A producer warpgroup (one thread issues, the warpgroup gives its
//     registers to the consumers with setmaxnreg: 40 vs 232) fills a
//     3-stage ring with TMA loads (x tile 128 x 64, W tile 256 x 64,
//     128-byte swizzle, zero fill past M, N and K) under full/empty
//     mbarriers. The ring runs on across tiles, so the next tile's loads
//     overlap this tile's epilogue.
//   - Two consumer warpgroups, 64 rows each, take A from registers: each
//     thread loads its fragment of the raw x tile with ldmatrix, applies
//     (x - mean) * rstd * gamma + beta in fp32 (gamma, beta staged once per
//     block in shared memory, zero past K so the K tail adds nothing), rounds
//     to bf16 and issues wgmma.m64n256k16 with B (W) from shared memory. The
//     next 16-wide slice is normalised while the current product runs. xn
//     never reaches shared or device memory.
//   - Epilogues from the accumulators: split adds the optional fp32 bias;
//     GEGLU loads a W tile of 128 value rows followed by the 128 matching
//     gate rows (one 3-d TMA box over W seen as (2, N, K)), so accumulator
//     columns j and j + 128 of a thread are a and g of one output, and the
//     2N-wide proj_in output is never written. Each warpgroup stages its
//     bf16 rows in shared memory (128B-swizzled 64 x 64 boxes) and one
//     thread stores them with TMA, which runs on under the next tile's
//     products (split writes three times the bytes it reads). A split
//     segment that a 64-wide box would cross (seg % 64 != 0, the tests'
//     small widths) takes 16-byte stores from a padded staging layout
//     instead; the kernel is chosen by shape. Scattered 4-byte stores
//     straight from the accumulator layout cost more than the products here.
//   - GEGLU's erf is a rational approximation with one reciprocal and one
//     exponential (common.cuh), cheaper than erff's branches. The GEGLU epilogue
//     does not overlap the products (both warpgroups reach it together):
//     with the LayerNorm in the A path it is what keeps GEGLU near the
//     library call's time. A ping-pong variant (warpgroups on alternate
//     tiles) was slower: one warpgroup alone does not keep the tensor cores
//     fed.
//   - Shared memory: 3 x (16 + 32) KB ring + 2 x 33 KB staging + K x 8 bytes
//     of gamma/beta + barriers: 214 KB at K = 320, 221 KB at K = 1280, which
//     caps K at 1984 (dynamic, opt-in above 48 KB). 384 threads.
//
// LayerNorm matches the JAX kernels: mean and E[x^2] - mean^2 in fp32,
// normalised value rounded to bf16 before the product. GELU is the exact
// erf form to fp32 accuracy (the TPU kernel used tanh only because Mosaic
// has no erf).
#include "common.cuh"
#include "hopper.cuh"

namespace vk {

enum { LN_SPLIT = 0, LN_GEGLU = 1 };

constexpr int LL_BM = 128, LL_BN = 256, LL_BK = 64, LL_STAGES = 3;
constexpr int LL_CONSUMER_WARPS = 8;  // two warpgroups of 64 rows
constexpr int LL_THREADS = LL_CONSUMER_WARPS * 32 + 128;  // + the producer warpgroup
constexpr int LL_A_BYTES = LL_BM * LL_BK * 2;
constexpr int LL_B_BYTES = LL_BN * LL_BK * 2;
constexpr int LL_STAGE_BYTES = LL_A_BYTES + LL_B_BYTES;
constexpr int LL_STG_STRIDE = LL_BN + 8;  // staged output row, bf16 (+8: no bank conflicts)
constexpr int LL_STG_BYTES = 64 * LL_STG_STRIDE * 2;  // per warpgroup, a multiple of 1024
constexpr int LL_FIXED_SMEM =
    1024 + LL_STAGES * LL_STAGE_BYTES + 2 * LL_STG_BYTES + 16 * LL_STAGES;
constexpr int LL_MAX_K = (232448 - LL_FIXED_SMEM) / 512 * 64;  // gamma/beta: 8 bytes per K

// mean and rstd of each row of x (M, K): one warp per row.
__global__ void __launch_bounds__(256)
ln_stats_kernel(const bf16* __restrict__ x, float2* __restrict__ stats, int M, int K,
                float eps) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (m >= M) return;
  const bf16* xr = x + (size_t)m * K;
  float s = 0.f, ss = 0.f;
  for (int k = lane * 8; k < K; k += 256) {
    float f[8];
    unpack8(*reinterpret_cast<const uint4*>(xr + k), f);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s += f[e];
      ss += f[e] * f[e];
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  if (lane == 0) {
    const float mean = s / K;
    const float var = fmaxf(ss / K - mean * mean, 0.f);
    stats[m] = make_float2(mean, rsqrtf(var + eps));
  }
}

// Two bf16 of one row -> LN -> two bf16. st = (mean, rstd); gb holds
// (gamma[k], gamma[k + 1], beta[k], beta[k + 1]).
__device__ __forceinline__ uint32_t ln_pair(uint32_t v, float2 st, float4 gb) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  return pack_bf16((f.x - st.x) * st.y * gb.x + gb.z, (f.y - st.x) * st.y * gb.y + gb.w);
}

// The normalised A fragment of one 16-wide K slice: `a_tile` is the stage's
// x tile, `row_off`/`swz`/`hi` this lane's ldmatrix row, `gb` the slice's
// gamma/beta pairs starting at column 2t.
__device__ __forceinline__ void load_a_frag(uint32_t (&f)[4], uint32_t a_tile, uint32_t row_off,
                                            int swz, int hi, int kk, const float4* gb,
                                            float2 st0, float2 st1) {
  ldmatrix_x4(a_tile + row_off + ((((2 * kk + hi) ^ swz)) << 4), f);
  const float4 p0 = gb[kk * 8], p1 = gb[kk * 8 + 4];
  f[0] = ln_pair(f[0], st0, p0);
  f[1] = ln_pair(f[1], st1, p0);
  f[2] = ln_pair(f[2], st0, p1);
  f[3] = ln_pair(f[3], st1, p1);
}

template <int MODE, bool TMA_STORE>
__global__ void __launch_bounds__(LL_THREADS, 1)
ln_linear_kernel(__grid_constant__ const CUtensorMap tm_x,
                 __grid_constant__ const CUtensorMap tm_w,
                 __grid_constant__ const CUtensorMap tm_out,
                 const float2* __restrict__ stats, const float* __restrict__ gamma,
                 const float* __restrict__ beta, const float* __restrict__ bias,
                 bf16* __restrict__ out, int M, int K, int N, int seg) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzled tiles need 1024 alignment
  uint8_t* smem = smem_raw + (base - raw);
  const int KT = (K + LL_BK - 1) / LL_BK;
  // ring | two staging areas | gamma/beta | barriers
  uint8_t* staged = smem + LL_STAGES * LL_STAGE_BYTES;
  float4* gb = reinterpret_cast<float4*>(staged + 2 * LL_STG_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(gb + KT * (LL_BK / 2));
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8 * LL_STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int p = tid; p < KT * (LL_BK / 2); p += LL_THREADS) {
    const int k = 2 * p;
    gb[p] = k < K ? make_float4(gamma[k], gamma[k + 1], beta[k], beta[k + 1])
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (tid == 0) {
    for (int s = 0; s < LL_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, LL_CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int tile_n = MODE == LN_SPLIT ? LL_BN : LL_BN / 2;  // output columns per tile
  const int ntn = (N + tile_n - 1) / tile_n;
  const int tiles = (M + LL_BM - 1) / LL_BM * ntn;

  if (warp >= LL_CONSUMER_WARPS) {
    // producer warpgroup: gives its registers to the consumers; one thread
    // keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (warp == LL_CONSUMER_WARPS && lane == 0) {
      tma_prefetch_map(&tm_x);
      tma_prefetch_map(&tm_w);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / ntn * LL_BM, n0 = t % ntn * tile_n;
        for (int kt = 0; kt < KT; ++kt) {
          const uint32_t a_dst = base + stage * LL_STAGE_BYTES;
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          mbar_arrive_expect_tx(full0 + 8 * stage, LL_STAGE_BYTES);
          tma_load_2d(a_dst, &tm_x, full0 + 8 * stage, kt * LL_BK, m0);
          tma_load_3d(a_dst + LL_A_BYTES, &tm_w, full0 + 8 * stage, kt * LL_BK, n0, 0);
          if (++stage == LL_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns rows 64 wg..64 wg + 63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = warp >> 2, wi = warp & 3, g = lane >> 2, t4 = lane & 3;
    const int row_in_tile = 64 * wg + 16 * wi;
    const uint32_t row_off = (row_in_tile + (lane & 15)) * 128;
    const int swz = lane & 7, hi = lane >> 4;
    uint8_t* stg = staged + wg * LL_STG_BYTES;
    const bool leader = (tid & 127) == 0;  // issues this warpgroup's TMA stores
    int stage = 0;
    uint32_t phase = 0;
    float acc[128];
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = t / ntn * LL_BM, n0 = t % ntn * tile_n;
      const int r0 = m0 + row_in_tile + g, r1 = r0 + 8;
      const float2 st0 = r0 < M ? stats[r0] : make_float2(0.f, 0.f);
      const float2 st1 = r1 < M ? stats[r1] : make_float2(0.f, 0.f);

      // K loop: the A fragment of slice i + 1 is normalised while slice i's
      // product runs; a stage goes back to the producer once its last
      // product is done.
      uint32_t fa[2][4];
      int prev = stage;
      mbar_wait(full0 + 8 * stage, phase);
      load_a_frag(fa[0], base + stage * LL_STAGE_BYTES, row_off, swz, hi, 0, gb + t4, st0, st1);
      for (int kt = 0; kt < KT; ++kt) {
        const uint64_t desc = desc_sw128(base + stage * LL_STAGE_BYTES + LL_A_BYTES);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_fence();
          wgmma_m64n256k16_rs(acc, fa[kk & 1], desc + 2 * kk, (kt | kk) != 0);
          wgmma_commit();
          wgmma_wait<1>();  // the previous slice's product is done
#pragma unroll
          for (int e = 0; e < 4; ++e) reg_fence(fa[(kk + 1) & 1][e]);
          if (kk == 0 && kt > 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
          if (kk < 3) {
            load_a_frag(fa[(kk + 1) & 1], base + stage * LL_STAGE_BYTES, row_off, swz, hi,
                        kk + 1, gb + kt * (LL_BK / 2) + t4, st0, st1);
          } else if (kt + 1 < KT) {
            prev = stage;
            if (++stage == LL_STAGES) {
              stage = 0;
              phase ^= 1;
            }
            mbar_wait(full0 + 8 * stage, phase);
            load_a_frag(fa[0], base + stage * LL_STAGE_BYTES, row_off, swz, hi, 0,
                        gb + (kt + 1) * (LL_BK / 2) + t4, st0, st1);
          }
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < 128; ++e) reg_fence(acc[e]);
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);
      if (++stage == LL_STAGES) {
        stage = 0;
        phase ^= 1;
      }

      // Epilogue: bf16 rows into this warpgroup's staging area, then either
      // TMA stores of 64 x 64 boxes (128B-swizzled staging, split with
      // seg % 64 == 0 and GEGLU), which run on under the next tile's
      // products, or 16-byte stores of 8 consecutive columns (padded
      // staging; seg % 8 == 0 keeps each chunk in one part).
      if (leader) bulk_wait_read<0>();  // the previous tile's stores have read it
      bar_named(1 + wg, 128);
      const int srow = 16 * wi + g;
      auto put = [&](int j, int i, uint32_t v) {  // columns 8 j + 2 t4 .. + 1, row srow + 8 i
        const int r = srow + 8 * i;
        const uint32_t off = TMA_STORE ? (j >> 3) * 8192 + sw128(r, j & 7) + 4 * t4
                                       : r * (LL_STG_STRIDE * 2) + 16 * j + 4 * t4;
        *reinterpret_cast<uint32_t*>(stg + off) = v;
      };
      if (MODE == LN_SPLIT) {
#pragma unroll
        for (int j = 0; j < LL_BN / 8; ++j) {
          const int n = n0 + 8 * j + 2 * t4;
          float2 b = make_float2(0.f, 0.f);
          if (bias && n < N) b = *reinterpret_cast<const float2*>(bias + n);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            put(j, i, pack_bf16(acc[4 * j + 2 * i] + b.x, acc[4 * j + 2 * i + 1] + b.y));
        }
      } else {
        // columns j < 16 hold the values, j + 16 the gates of the same outputs
#pragma unroll
        for (int j = 0; j < LL_BN / 16; ++j) {
          const int o = n0 + 8 * j + 2 * t4;
          float2 ba = make_float2(0.f, 0.f), bg = ba;
          if (o < N) {
            ba = *reinterpret_cast<const float2*>(bias + o);
            bg = *reinterpret_cast<const float2*>(bias + N + o);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float* a = acc + 4 * j + 2 * i;
            const float* gt = acc + 4 * (j + LL_BN / 16) + 2 * i;
            put(j, i, pack_bf16((a[0] + ba.x) * gelu_erf(gt[0] + bg.x),
                                (a[1] + ba.y) * gelu_erf(gt[1] + bg.y)));
          }
        }
      }
      if (TMA_STORE) fence_async_smem();
      bar_named(1 + wg, 128);
      if (TMA_STORE) {
        if (leader) {
          for (int b = 0; b < tile_n / 64; ++b) {
            const int n = n0 + 64 * b;
            if (n >= N) break;
            const int part = MODE == LN_SPLIT ? n / seg : 0;
            tma_store_3d(&tm_out, smem_u32(stg + b * 8192), n - part * seg, m0 + 64 * wg,
                         part);
          }
          bulk_commit();
        }
      } else {
        const int chunks = tile_n / 8;  // 16-byte chunks per staged row
#pragma unroll 4
        for (int q = tid & 127; q < 64 * chunks; q += 128) {
          const int row = q / chunks, ch = q - row * chunks;
          const int m = m0 + 64 * wg + row, n = n0 + 8 * ch;
          if (m >= M || n >= N) continue;
          size_t o = (size_t)m * N + n;
          if (MODE == LN_SPLIT) {
            const int part = n / seg;
            o = ((size_t)part * M + m) * seg + (n - part * seg);
          }
          *reinterpret_cast<uint4*>(out + o) =
              *reinterpret_cast<const uint4*>(stg + row * (LL_STG_STRIDE * 2) + 16 * ch);
        }
      }
    }
    if (leader) bulk_wait<0>();
  }
}

}  // namespace vk

// x (M, K) bf16; gamma, beta (K) fp32; w (N, K) bf16 for "split", (2N, K)
// for "geglu"; bias fp32 (N or 2N) or null for "split", required for
// "geglu"; stats (M, 2) fp32 scratch; out (N/seg, M, seg) bf16 for "split",
// (M, N) for "geglu". K % 32 == 0; split: seg % 8 == 0; geglu:
// N % 64 == 0. x and w 16-byte aligned. K <= 1984 (LL_MAX_K).
extern "C" int vk_ln_linear(const void* x, const void* gamma, const void* beta,
                            const void* w, const void* bias, void* stats, void* out, int M,
                            int K, int N, int mode, int seg, float eps, void* stream) {
  using namespace vk;
  if (K % 32 || K > LL_MAX_K || M <= 0 || (mode == LN_SPLIT && seg % 8) ||
      ((uintptr_t)x | (uintptr_t)w | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool split = mode == LN_SPLIT;
  CUtensorMap tm_x, tm_w, tm_out = {};
  const uint64_t x_dims[2] = {(uint64_t)K, (uint64_t)M};
  const uint64_t x_strides[1] = {(uint64_t)K * 2};
  const uint32_t x_box[2] = {LL_BK, LL_BM};
  // W as (planes, rows, K): split one plane of N rows; geglu [value; gate]
  const uint64_t w_dims[3] = {(uint64_t)K, (uint64_t)N, split ? 1ull : 2ull};
  const uint64_t w_strides[2] = {(uint64_t)K * 2, (uint64_t)N * K * 2};
  const uint32_t w_box[3] = {(uint32_t)LL_BK, (uint32_t)(split ? LL_BN : LL_BN / 2),
                             split ? 1u : 2u};
  if (!make_tmap_bf16(&tm_x, x, 2, x_dims, x_strides, x_box) ||
      !make_tmap_bf16(&tm_w, w, 3, w_dims, w_strides, w_box))
    return (int)cudaErrorInvalidValue;
  // out as (parts, M, seg) for split, (1, M, N) for geglu, in 64 x 64 boxes
  // of the swizzled staging; split segments that 64-wide boxes would cross
  // take the 16-byte store path
  const int width = split ? seg : N;
  const int tma_store = width % 64 == 0;
  const uint64_t o_dims[3] = {(uint64_t)width, (uint64_t)M, split ? (uint64_t)(N / seg) : 1ull};
  const uint64_t o_strides[2] = {(uint64_t)width * 2, (uint64_t)M * width * 2};
  const uint32_t o_box[3] = {64u, 64u, 1u};
  if (tma_store && !make_tmap_bf16(&tm_out, out, 3, o_dims, o_strides, o_box))
    return (int)cudaErrorInvalidValue;

  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int KT = (K + LL_BK - 1) / LL_BK;
  const int smem = LL_FIXED_SMEM + KT * LL_BK * 8;
  const int tile_n = split ? LL_BN : LL_BN / 2;
  const int tiles = (M + LL_BM - 1) / LL_BM * ((N + tile_n - 1) / tile_n);
  const int grid = tiles < sms ? tiles : sms;

  ln_stats_kernel<<<(M + 7) / 8, 256, 0, st>>>((const bf16*)x, (float2*)stats, M, K, eps);
  auto kernel = !split     ? ln_linear_kernel<LN_GEGLU, true>
                : tma_store ? ln_linear_kernel<LN_SPLIT, true>
                            : ln_linear_kernel<LN_SPLIT, false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kernel<<<grid, LL_THREADS, smem, st>>>(tm_x, tm_w, tm_out, (const float2*)stats,
                                         (const float*)gamma, (const float*)beta,
                                         (const float*)bias, (bf16*)out, M, K, N, seg);
  return (int)cudaGetLastError();
}
