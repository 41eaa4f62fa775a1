// K4 gn_silu_conv3: the 3-tap convolution over frames of a (b, t, s, c)
// video, with the GroupNorm affine + SiLU applied to its input:
//
//   xn[f, p] = bf16(SiLU(x[f, p] * scale[f] + shift[f]))
//   y[f, p]  = sum_tap xn[f + tap - 1, p] . W[tap] + bias   (zero outside the clip)
//   epilogue "emb": out = y + emb[f]
//   epilogue "res": out = residual + res_scale * y
//
// Replaces vista_tpu/ops/temporal_conv.py _gn_conv3_kernel (entries
// fused_gn_silu_conv3_emb and fused_gn_silu_conv3_res); scale/shift are the
// GroupNorm statistics folded per (frame, channel) by the caller. conv3 (the
// same GEMM with no epilogue but an optional bias) replaces _conv3_kernel
// (temporal_conv3): it runs K4's backward (dx is this conv of the cotangent
// with flipped, transposed taps; the ``res`` epilogue's res_scale gradient
// recomputes y).
//
// Bound on the H100: the conv is 6 M cin cout operations against
// 2 M (cin + cout) bytes, bound by the tensor cores at every UNet width
// (0.286 ms at (50, 9216, 320)). Two kernels:
//
//   - gn_silu_kernel, the pre-pass: xn once, in fp32, rounded to bf16 once
//     (where the reference's tap() and the plain version round), SiLU as
//     a * sigmoid(a) on ex2.approx + rcp.approx. One read of x, one write
//     of xn, 16-byte accesses; a thread keeps its 8 channels' scale and
//     shift in registers over the rows it takes. Fusing the affine + SiLU
//     into the GEMM's A loads would evaluate it once per tap and per column
//     tile (3 to 12 times), as much special-function work as the products
//     at c = 320, and a zero-filled edge row would become SiLU(shift) != 0.
//     The extra write and read of xn cost 4 M cin bytes (0.18 ms at ds1).
//   - conv3_tma_kernel<EPI>, an implicit GEMM on the TMA + wgmma skeleton
//     (csrc/gemm_tma.cuh), built as K3 (csrc/linear_residual.cu): a
//     persistent block of three warpgroups walks 128 x 320 output tiles
//     row panel by row panel; M = clip rows, K = 3 cin (tap-major: the
//     stage of depth kk reads tap kk / cin), W read K-major as stored
//     ((cout, 3, cin) = (N, K)). A is read through a 3-d map over (clips,
//     t s rows, cin): the box of tap `tap` starts at row r0 + (tap - 1) s
//     of the same clip, so TMA's zero fill past a clip's first and last
//     frame is exactly the SAME padding of xn, and a box never reads the
//     neighbouring clip (the sampling batch is two clips back to back).
//     cin % 64 == 0, so a 64-deep stage never straddles two taps. Output
//     tiles stay inside one clip too (the last of a clip may be ragged);
//     the 3-d output and residual maps drop its rows past the clip.
//   - Epilogue: bias and (EMB) emb[frame] per row in fp32 from global
//     memory, or (RES) the residual loaded by TMA into the staging boxes,
//     as K3 does; the bf16 result is written in place and stored by TMA.
//   - No split-K: every output is summed in one fixed order, so the result
//     is bit-identical over launches.
#include "gemm_tma.cuh"

namespace vk {

constexpr int CV_NONE = 0, CV_EMB = 1, CV_RES = 2;  // conv3_tma_kernel's epilogues
constexpr int CV_STAGES = 3;
constexpr int CV_STG_BOXES = 3;  // residual/output boxes per consumer warpgroup
constexpr int CV_BOXES = TG_BN / 64;  // 64-column boxes in an output tile
constexpr int CV_STG_BYTES = 2 * CV_STG_BOXES * TG_BOX_BYTES;
constexpr int CV_SMEM =
    1024 + CV_STAGES * TG_STAGE_BYTES + CV_STG_BYTES + 16 * CV_STAGES + 8 * 2 * CV_STG_BOXES;
constexpr int GS_ROWS = 64;  // rows of one frame a pre-pass block takes

// SiLU(a) = a / (1 + 2^(-a log2 e)); for a -> -inf the exponential is +inf
// and its reciprocal 0, so the result is -0, never NaN.
__device__ __forceinline__ float silu_fast(float a) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(a * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.f + e));
  return a * r;
}

// Block (chunk, frame): threads x = c8 + C/8 * y own channels 8 c8 .. 8 c8 + 7
// of rows y, y + R, ... (R = blockDim / (C/8)) of the frame's rows
// GS_ROWS chunk .. GS_ROWS (chunk + 1) - 1. A warp's accesses are contiguous.
__global__ void __launch_bounds__(1024)
gn_silu_kernel(const bf16* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ shift, bf16* __restrict__ xn, int S, int C) {
  const int cv = C / 8, rstep = blockDim.x / cv;
  const int c8 = threadIdx.x % cv, y = threadIdx.x / cv;
  const int f = blockIdx.y;
  const float4* sc = reinterpret_cast<const float4*>(scale + (size_t)f * C + 8 * c8);
  const float4* sh = reinterpret_cast<const float4*>(shift + (size_t)f * C + 8 * c8);
  const float4 s0 = sc[0], s1 = sc[1], h0 = sh[0], h1 = sh[1];
  const float a_s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  const float a_h[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
  const int end = min(S, (blockIdx.x + 1) * GS_ROWS);
  for (int p = blockIdx.x * GS_ROWS + y; p < end; p += rstep) {
    const size_t off = ((size_t)f * S + p) * C + 8 * c8;
    float v[8];
    unpack8(*reinterpret_cast<const uint4*>(x + off), v);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = silu_fast(fmaf(v[e], a_s[e], a_h[e]));
    *reinterpret_cast<uint4*>(xn + off) = pack8(v);
  }
}

// Work item `item` -> clip, first row in the clip, first column: row panels
// of `panels` per clip, the column tile fastest.
struct CvItem {
  int clip, r0, n0;
  __device__ CvItem(int item, int tn, int panels)
      : clip(item / tn / panels), r0(item / tn % panels * TG_BM), n0(item % tn * TG_BN) {}
};

template <int EPI>
__global__ void __launch_bounds__(TG_THREADS, 1)
conv3_tma_kernel(__grid_constant__ const CUtensorMap tm_a,
                 __grid_constant__ const CUtensorMap tm_w,
                 __grid_constant__ const CUtensorMap tm_res,
                 __grid_constant__ const CUtensorMap tm_out, const float* __restrict__ bias,
                 const float* __restrict__ emb, const float* __restrict__ res_scale, int T,
                 int S, int K, int N, int items) {
  extern __shared__ uint8_t smem_raw[];
  // ring | staging (warpgroup 0's boxes, then 1's) | ring barriers | residual barriers
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t stg0 = ((raw + 1023) & ~1023u) + CV_STAGES * TG_STAGE_BYTES;
  const uint32_t rbar0 = stg0 + CV_STG_BYTES + 16 * CV_STAGES;
  if (EPI == CV_RES && threadIdx.x == 0)
    for (int b = 0; b < 2 * CV_STG_BOXES; ++b) mbar_init(rbar0 + 8 * b, 1);
  Ring<CV_STAGES> ring = tg_ring<CV_STAGES>(smem_raw, TG_STAGE_BYTES, CV_STG_BYTES);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = T * S, panels = (rows + TG_BM - 1) / TG_BM, tn = (N + TG_BN - 1) / TG_BN;
  const int per_tap = K / TG_BK, stages = 3 * per_tap;

  if (warp >= TG_CONSUMER_WARPS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (warp == TG_CONSUMER_WARPS && lane == 0) {
      tma_prefetch_map(&tm_a);
      tma_prefetch_map(&tm_w);
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const CvItem it(item, tn, panels);
        for (int i = 0; i < stages; ++i) {
          const int tap = i / per_tap;
          tg_acquire(ring);
          const uint32_t dst = ring.tile();
          // rows before the clip's first frame or past its last arrive as zeros
          tma_load_3d(dst, &tm_a, ring.full(), (i - tap * per_tap) * TG_BK,
                      it.r0 + (tap - 1) * S, it.clip);
#pragma unroll
          for (int q = 0; q < CV_BOXES; ++q)
            tma_load_2d(dst + TG_A_BYTES + q * TG_BOX_BYTES, &tm_w, ring.full(), i * TG_BK,
                        it.n0 + 64 * q);
          ring.advance();
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = warp >> 2, row = 16 * (warp & 3) + (lane >> 2), t = lane & 3;
    const bool leader = (threadIdx.x & 127) == 0;  // loads and stores the warpgroup's boxes
    const uint32_t stg = stg0 + wg * CV_STG_BOXES * TG_BOX_BYTES;
    uint8_t* stg_ptr = smem_raw + (stg - raw);
    const uint32_t rbar = rbar0 + 8 * wg * CV_STG_BOXES;
    const float rs = EPI == CV_RES ? *res_scale : 0.f;
    uint32_t seq = 0;  // output boxes this warpgroup has stored so far
    if (EPI == CV_RES && leader) tma_prefetch_map(&tm_res);
    TgAcc acc;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const CvItem it(item, tn, panels);
      const int r0 = it.r0 + 64 * wg;  // the warpgroup's first row in the clip
      const int nb = min(CV_BOXES, (N - it.n0 + 63) / 64);  // boxes inside the output
      // EMB: the frames of this thread's two rows (rows past the clip are dropped)
      const float* e_row[2] = {nullptr, nullptr};
#pragma unroll
      for (int i = 0; i < 2 && EPI == CV_EMB; ++i)
        e_row[i] = emb + (size_t)(it.clip * T + min(r0 + row + 8 * i, rows - 1) / S) * N;
      // RES: box j of this item goes through buffer (seq + j) % CV_STG_BOXES
      auto load_residual = [&](int j) {
        const uint32_t b = (seq + j) % CV_STG_BOXES;
        mbar_arrive_expect_tx(rbar + 8 * b, TG_BOX_BYTES);
        tma_load_3d(stg + b * TG_BOX_BYTES, &tm_res, rbar + 8 * b, it.n0 + 64 * j, r0, it.clip);
      };
      if (EPI == CV_RES && leader) {
        bulk_wait_read<0>();  // the previous item's stores have read the buffers
        for (int j = 0; j < min(nb, CV_STG_BOXES); ++j) load_residual(j);
      }
      tg_mainloop<false, false>(ring, acc, stages, wg, lane);
#pragma unroll
      for (int j = 0; j < CV_BOXES; ++j) {
        if (j >= nb) break;
        const uint32_t b = (seq + j) % CV_STG_BOXES;
        if (EPI == CV_RES) {
          mbar_wait(rbar + 8 * b, ((seq + j) / CV_STG_BOXES) & 1);
        } else {
          // the store that last read this buffer, CV_STG_BOXES boxes ago, is done
          if (leader) bulk_wait_read<CV_STG_BOXES - 1>();
          bar_named(1 + wg, 128);
        }
        uint8_t* box = stg_ptr + b * TG_BOX_BYTES;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int n = it.n0 + 64 * j + 8 * jj + 2 * t;
          const float2 bb = bias != nullptr && n < N ? *reinterpret_cast<const float2*>(bias + n)
                                                     : make_float2(0.f, 0.f);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            uint32_t* p = reinterpret_cast<uint32_t*>(box + sw128(row + 8 * i, jj) + 4 * t);
            float2 v = tg_pair(acc, 8 * j + jj, i);
            v.x += bb.x;
            v.y += bb.y;
            if (EPI == CV_EMB && n < N) {
              const float2 e = *reinterpret_cast<const float2*>(e_row[i] + n);
              v.x += e.x;
              v.y += e.y;
            }
            if (EPI == CV_RES) {
              const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
              v.x = fmaf(rs, v.x, r.x);
              v.y = fmaf(rs, v.y, r.y);
            }
            *p = pack_bf16(v.x, v.y);
          }
        }
        fence_async_smem();
        bar_named(1 + wg, 128);
        if (leader) {
          tma_store_3d(&tm_out, stg + b * TG_BOX_BYTES, it.n0 + 64 * j, r0, it.clip);
          bulk_commit();
          if (EPI == CV_RES && j + CV_STG_BOXES < nb) {
            bulk_wait_read<0>();  // the store has read the buffer
            load_residual(j + CV_STG_BOXES);
          }
        }
      }
      seq += nb;
    }
    if (leader) bulk_wait<0>();
  }
}

}  // namespace vk

// x (frames, S, C) bf16; scale, shift (frames, C) fp32; xn like x.
// C % 8 == 0, C <= 8192, frames <= 65535; all 16-byte aligned.
extern "C" int vk_gn_silu(const void* x, const void* scale, const void* shift, void* xn,
                          int frames, int S, int C, void* stream) {
  using namespace vk;
  if (frames <= 0 || frames > 65535 || S <= 0 || C <= 0 || C % 8 || C > 8192 ||
      ((uintptr_t)x | (uintptr_t)scale | (uintptr_t)shift | (uintptr_t)xn) % 16)
    return (int)cudaErrorInvalidValue;
  const int cv = C / 8, threads = cv * max(1, 256 / cv);
  const dim3 grid((S + GS_ROWS - 1) / GS_ROWS, frames);
  gn_silu_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)scale, (const float*)shift, (bf16*)xn, S, C);
  return (int)cudaGetLastError();
}

// The 3-tap frame conv of x (clips * T, S, K) bf16 with w (N, 3, K) bf16
// (taps major), on `grid` persistent blocks with `smem` bytes of dynamic
// shared memory (ops/temporal_conv.py conv3_plan); out (clips * T, S, N).
// bias (N) fp32 or null; then emb (clips * T, N) fp32 (epilogue EMB), or
// res like out with res_scale a one-element fp32 device buffer (RES), or
// neither (NONE). K % 64 == 0, N % 8 == 0; x, w, res and out 16-byte aligned.
extern "C" int vk_conv3(const void* x, const void* w, const void* bias, const void* emb,
                        const void* res, const void* res_scale, void* out, int clips, int T,
                        int S, int K, int N, int grid, int smem, void* stream) {
  using namespace vk;
  if (clips <= 0 || T <= 0 || S <= 0 || K <= 0 || N <= 0 || K % TG_BK || N % 8 ||
      (long)T * S > (1L << 30) || (emb != nullptr && res != nullptr) ||
      (res != nullptr) != (res_scale != nullptr) ||
      ((uintptr_t)x | (uintptr_t)w | (uintptr_t)res | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  const int rows = T * S;
  const long items = (long)clips * ((rows + TG_BM - 1) / TG_BM) * ((N + TG_BN - 1) / TG_BN);
  if (grid <= 0 || grid > items || items > (1L << 30) || smem != CV_SMEM)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_a, tm_w, tm_res, tm_out;
  const uint64_t a_dims[3] = {(uint64_t)K, (uint64_t)rows, (uint64_t)clips};
  const uint64_t a_strides[2] = {(uint64_t)K * 2, (uint64_t)rows * K * 2};
  const uint32_t a_box[3] = {TG_BK, TG_BM, 1};
  const uint64_t w_dims[2] = {(uint64_t)3 * K, (uint64_t)N};
  const uint64_t w_strides[1] = {(uint64_t)3 * K * 2};
  const uint32_t w_box[2] = {TG_BK, 64};
  const uint64_t o_dims[3] = {(uint64_t)N, (uint64_t)rows, (uint64_t)clips};
  const uint64_t o_strides[2] = {(uint64_t)N * 2, (uint64_t)rows * N * 2};
  const uint32_t o_box[3] = {64, 64, 1};
  if (!make_tmap_bf16(&tm_a, x, 3, a_dims, a_strides, a_box) ||
      !make_tmap_bf16(&tm_w, w, 2, w_dims, w_strides, w_box) ||
      !make_tmap_bf16(&tm_res, res != nullptr ? res : out, 3, o_dims, o_strides, o_box) ||
      !make_tmap_bf16(&tm_out, out, 3, o_dims, o_strides, o_box))
    return (int)cudaErrorInvalidValue;
  auto kernel = emb != nullptr ? conv3_tma_kernel<CV_EMB>
                : res != nullptr ? conv3_tma_kernel<CV_RES> : conv3_tma_kernel<CV_NONE>;
  if (cudaError_t e =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, CV_SMEM))
    return (int)e;
  kernel<<<grid, TG_THREADS, CV_SMEM, (cudaStream_t)stream>>>(
      tm_a, tm_w, tm_res, tm_out, (const float*)bias, (const float*)emb,
      (const float*)res_scale, T, S, K, N, (int)items);
  return (int)cudaGetLastError();
}
