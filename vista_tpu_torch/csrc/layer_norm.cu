// layer_norm and ln_bwd: row LayerNorm, bf16 x in, fp32 statistics in the
// E[x^2] - E[x]^2 form (eps inside the rsqrt), and its backward.
//
// Replaces vista_tpu/ops/norms.py _ln_kernel (layer_norm: under LoRA the
// norm1 of every spatial and temporal self-attention) and the LayerNorm
// backward inside vista_tpu/ops/fused_qkv.py _qkv_bwd_kernel and
// vista_tpu/ops/fused_ff.py _ff_bwd_kernel / _ff_bwd_wide_kernel; under LoRA
// also the backward of norm1, which the JAX package leaves to an XLA
// recompute of the formula (vista_tpu/ops/norms.py _layer_norm_vjp_bwd).
//
//   layer_norm_kernel<TW>:       out = (x - mean) rstd gamma + beta, bf16;
//   ln_bwd_kernel<TG, TD, WANT>: dx = rstd (g - mean(g) - xhat mean(g xhat))
//                                + dres, with g = dxn gamma; with WANT also
//                                dgamma = sum dxn xhat, dbeta = sum dxn.
//
// Both are bound by device-memory bytes: 4 bytes an element forward, 6 to 10
// backward (x, dxn in fp32 or bf16, dres, dx), against a few dozen flops.
// Design (ops/norms.py ln_plan is the launch, checked on the CPU by
// tests/test_torch_ln_plan.py):
//
// - Row groups sized to the width. A row is held by `lanes` lanes, each with
//   at most LN_KMAX = 5 chunks of 8 elements: C / 40 lanes at C = 320, 640,
//   1280, so a warp holds 4, 2 or 1 rows (a warp step). Lane j of a group
//   holds chunks j, j + lanes, ...: the lanes of a group read neighbouring
//   16-byte chunks, and a group's sums are a __shfl_xor tree over its own
//   lanes.
// - A persistent grid of LN_BLOCKS_PER_SM blocks an SM; warp w of the grid
//   takes warp steps w, w + (grid warps), ...
// - Loads in flight: each warp streams its steps through its own ring of
//   stages in shared memory with 16-byte cp.async, LN_FWD_STAGES - 1 (or
//   LN_BWD_STAGES - 1) steps ahead of the one it computes. A step's rows are
//   contiguous in every tensor, so the warp copies each as one run of
//   16-byte pieces (lane l takes pieces l, l + 32, ...): every copy
//   instruction covers 512 contiguous bytes, and a stage is an image of the
//   rows that the lanes then read in their row-group layout. cp.async, and
//   not a bulk copy into an mbarrier ring, nor registers: the warp's own
//   cp.async.wait_group and a __syncwarp are the only synchronisation, a
//   ragged last step is a shorter run, and the bytes in flight cost no
//   registers, which the backward spends on its dgamma/dbeta partials (80 a
//   lane).
// - gamma and beta are read once per lane into registers for the whole
//   walk, in their own type (TW, TG: fp32 or bf16), so no wrapper casts them.
//
// The backward's column sums (WANT): each lane sums dxn xhat and dxn of its
// 40 columns over the rows it walks; at the end the warp adds its groups'
// sums (a __shfl_xor butterfly), the block adds its warps' in warp order and
// writes one partial row (2C fp32) to a workspace. Then a fold in the same
// launch: blocks come in groups of LN_FOLD; the last block of a group to
// arrive (an arrival counter, acquire-release) adds the group's rows in
// block order into a group row, and the last group to finish adds the group
// rows in group order into dgamma and dbeta. Every order of every sum
// depends on the grid alone, never on which block came last, so two
// launches give the same bits. One block folding all grid rows alone would
// read grid x 2C fp32 (2.7 MB at C = 1280) by itself after the rest has
// finished; two levels read about sqrt of that each. Each counter resets
// itself to 0 in the launch that used it, so no memset is launched; the
// wrapper keeps one set of counters per stream (launches on one stream are
// ordered; two streams would race on one set).
#include "common.cuh"
#include "hopper.cuh"

namespace vk {

constexpr int LN_KMAX = 5;             // chunks of 8 a lane holds at most
constexpr int LN_MAX_C = 1280;         // 32 lanes x 5 chunks x 8
constexpr int LN_CHUNK_BYTES = 32 * 16;  // a 16-byte piece of every lane of a warp
constexpr int LN_BLOCKS_PER_SM = 2;
constexpr int LN_FWD_WARPS = 8;
constexpr int LN_FWD_STAGES = 4;
constexpr int LN_FWD_STAGE_BYTES = LN_KMAX * LN_CHUNK_BYTES;  // x
constexpr int LN_FWD_SMEM = LN_FWD_WARPS * LN_FWD_STAGES * LN_FWD_STAGE_BYTES;
constexpr int LN_BWD_WARPS = 4;
constexpr int LN_BWD_STAGES = 2;
constexpr int LN_BWD_STAGE_BYTES = 4 * LN_KMAX * LN_CHUNK_BYTES;  // x, dxn (up to fp32), dres
constexpr int LN_BWD_SMEM = LN_BWD_WARPS * LN_BWD_STAGES * LN_BWD_STAGE_BYTES;
constexpr int LN_FOLD = 16;       // blocks a group of the fold adds up
constexpr int LN_COUNTERS = 64;   // arrival counters the wrapper provides
static_assert(LN_BWD_STAGES * LN_BWD_STAGE_BYTES >= 2 * LN_MAX_C * 4,
              "a warp's ring holds its 2C column sums after the walk");

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Copies `bytes` (a multiple of 16) from global `src` to shared `dst` as
// 16-byte pieces, lane l taking pieces l, l + 32, ...: each copy instruction
// of the warp covers LN_CHUNK_BYTES contiguous bytes.
__device__ __forceinline__ void copy_run(uint32_t dst, const void* src, int bytes, int lane) {
  const char* from = reinterpret_cast<const char*>(src);
  for (int o = lane * 16; o < bytes; o += LN_CHUNK_BYTES) cp_async16(dst + o, from + o);
}

// Eight fp32 or bf16 values as one lane holds them: bf16 packed in a uint4,
// fp32 in two float4.
template <typename T>
struct Vec8;

template <>
struct Vec8<bf16> {
  uint4 v;
  __device__ __forceinline__ void load(const bf16* p) { v = *reinterpret_cast<const uint4*>(p); }
  __device__ __forceinline__ void zero() { v = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ void unpack(float f[8]) const { unpack8(v, f); }
};

template <>
struct Vec8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = *reinterpret_cast<const float4*>(p);
    b = *reinterpret_cast<const float4*>(p + 4);
  }
  __device__ __forceinline__ void zero() { a = b = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ void unpack(float f[8]) const {
    f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w, f[4] = b.x, f[5] = b.y, f[6] = b.z,
    f[7] = b.w;
  }
};

// Sum over the `lanes` lanes of a row group (lanes a power of 2, the group
// lanes aligned): a butterfly, so every lane of the group gets the same bits.
__device__ __forceinline__ float group_sum(float v, int lanes) {
  for (int o = 1; o < lanes; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// How a warp walks the rows: step t holds rows t * rows .. t * rows + rows - 1,
// the lane's row is t * rows + sub and its chunks j, j + lanes, ...
struct LnWalk {
  int lanes, rows, sub, j, chunks, n;
  long first, stride;
  __device__ LnWalk(int M, int C, int lanes_, int warps) {
    const int lane = threadIdx.x & 31;
    lanes = lanes_;
    rows = 32 / lanes;
    sub = lane / lanes;
    j = lane & (lanes - 1);
    chunks = C / 8;
    const long steps = (M + rows - 1) / rows;
    first = (long)blockIdx.x * warps + (threadIdx.x >> 5);
    stride = (long)gridDim.x * warps;
    n = first < steps ? (int)((steps - first + stride - 1) / stride) : 0;
  }
  __device__ __forceinline__ long row0(int i) const { return (first + (long)i * stride) * rows; }
  __device__ __forceinline__ long row(int i) const { return row0(i) + sub; }
  // the bytes of step i's rows in a tensor of `elem`-byte elements
  __device__ __forceinline__ int bytes(int i, int M, int C, int elem) const {
    return (int)min((long)rows, M - row0(i)) * C * elem;
  }
  __device__ __forceinline__ bool has(int k) const { return j + lanes * k < chunks; }
  __device__ __forceinline__ int col(int k) const { return (j + lanes * k) * 8; }
};

template <typename TW>
__global__ void __launch_bounds__(LN_FWD_WARPS * 32, LN_BLOCKS_PER_SM)
layer_norm_kernel(const bf16* __restrict__ x, const TW* __restrict__ gamma,
                  const TW* __restrict__ beta, bf16* __restrict__ out, int M, int C, int lanes,
                  float eps) {
  extern __shared__ __align__(16) uint8_t ln_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const LnWalk w(M, C, lanes, LN_FWD_WARPS);
  const int ring = warp * LN_FWD_STAGES * LN_FWD_STAGE_BYTES;
  const uint32_t ring_s = smem_u32(ln_smem) + ring;

  Vec8<TW> g[LN_KMAX], b[LN_KMAX];
#pragma unroll
  for (int k = 0; k < LN_KMAX; ++k) {
    if (w.has(k)) {
      g[k].load(gamma + w.col(k));
      b[k].load(beta + w.col(k));
    } else {
      g[k].zero();
      b[k].zero();
    }
  }
  auto issue = [&](int i) {
    copy_run(ring_s + (i % LN_FWD_STAGES) * LN_FWD_STAGE_BYTES, x + w.row0(i) * C,
             w.bytes(i, M, C, 2), lane);
  };
#pragma unroll
  for (int i = 0; i < LN_FWD_STAGES - 1; ++i) {
    if (i < w.n) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < w.n; ++i) {
    __syncwarp();  // every lane is done with the stage the next copy refills
    if (i + LN_FWD_STAGES - 1 < w.n) issue(i + LN_FWD_STAGES - 1);
    cp_async_commit();
    cp_async_wait<LN_FWD_STAGES - 1>();
    __syncwarp();  // and every lane's pieces of step i have landed
    const long r = w.row(i);
    const bool valid = r < M;
    // the lane's row in the stage, an image of the step's rows
    const uint8_t* xs =
        ln_smem + ring + (i % LN_FWD_STAGES) * LN_FWD_STAGE_BYTES + w.sub * C * 2;
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int k = 0; k < LN_KMAX; ++k) {
      if (!valid || !w.has(k)) continue;
      float v[8];
      unpack8(*reinterpret_cast<const uint4*>(xs + w.col(k) * 2), v);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s += v[e];
        ss += v[e] * v[e];
      }
    }
    s = group_sum(s, lanes);
    ss = group_sum(ss, lanes);
    const float mean = s / C;
    const float rstd = rsqrtf(fmaxf(ss / C - mean * mean, 0.f) + eps);
    if (!valid) continue;
#pragma unroll
    for (int k = 0; k < LN_KMAX; ++k) {
      if (!w.has(k)) continue;
      float v[8], gv[8], bv[8], o[8];
      // x read again from the stage: the registers hold gamma and beta
      unpack8(*reinterpret_cast<const uint4*>(xs + w.col(k) * 2), v);
      g[k].unpack(gv);
      b[k].unpack(bv);
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = (v[e] - mean) * rstd * gv[e] + bv[e];
      *reinterpret_cast<uint4*>(out + r * C + w.col(k)) = pack8(o);
    }
  }
  cp_async_wait<0>();
}

// Adds column quad q of `n` rows of `quads` float4 in row order, reading
// through L2 (other blocks of this launch wrote the rows): LN_FOLD rows'
// loads in flight at once, then their sum, so a group costs one L2 round
// trip and not LN_FOLD.
__device__ __forceinline__ float4 fold_quad(const float* rows, int n, int quads, int q) {
  const float4* p = reinterpret_cast<const float4*>(rows) + q;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int b0 = 0; b0 < n; b0 += LN_FOLD) {
    float4 v[LN_FOLD];
#pragma unroll
    for (int u = 0; u < LN_FOLD; ++u)
      if (b0 + u < n) v[u] = __ldcg(p + (size_t)(b0 + u) * quads);
#pragma unroll
    for (int u = 0; u < LN_FOLD; ++u) {
      if (b0 + u >= n) break;
      acc.x += v[u].x;
      acc.y += v[u].y;
      acc.z += v[u].z;
      acc.w += v[u].w;
    }
  }
  return acc;
}

template <typename TG, typename TD, bool WANT>
__global__ void __launch_bounds__(LN_BWD_WARPS * 32, LN_BLOCKS_PER_SM)
ln_bwd_kernel(const bf16* __restrict__ x, const TD* __restrict__ dxn, const TG* __restrict__ gamma,
              const bf16* __restrict__ dres, bf16* __restrict__ dx, float* __restrict__ part,
              float* __restrict__ dgamma, float* __restrict__ dbeta, int* __restrict__ counters,
              int M, int C, int lanes, float eps) {
  extern __shared__ __align__(16) uint8_t ln_smem[];
  // a stage: the images of the step's rows of x, dxn and dres (up to
  // X_BYTES of a bf16 tensor)
  constexpr int X_BYTES = LN_KMAX * LN_CHUNK_BYTES;
  constexpr int D_OFF = X_BYTES, R_OFF = D_OFF + X_BYTES * (int)sizeof(TD) / 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const LnWalk w(M, C, lanes, LN_BWD_WARPS);
  const int ring = warp * LN_BWD_STAGES * LN_BWD_STAGE_BYTES;
  const uint32_t ring_s = smem_u32(ln_smem) + ring;

  Vec8<TG> g[LN_KMAX];
#pragma unroll
  for (int k = 0; k < LN_KMAX; ++k) {
    if (w.has(k))
      g[k].load(gamma + w.col(k));
    else
      g[k].zero();
  }
  float pg[LN_KMAX][8], pb[LN_KMAX][8];
#pragma unroll
  for (int k = 0; k < LN_KMAX; ++k)
#pragma unroll
    for (int e = 0; e < 8; ++e) pg[k][e] = pb[k][e] = 0.f;

  // A step's rows are contiguous in each tensor: one run of pieces each. An
  // fp32 chunk of 8 copied lane by lane (32 bytes a lane) would split every
  // 32-byte sector between two instructions.
  auto issue = [&](int i) {
    const uint32_t dst = ring_s + (i % LN_BWD_STAGES) * LN_BWD_STAGE_BYTES;
    const size_t at = w.row0(i) * C;
    copy_run(dst, x + at, w.bytes(i, M, C, 2), lane);
    copy_run(dst + D_OFF, dxn + at, w.bytes(i, M, C, sizeof(TD)), lane);
    if (dres) copy_run(dst + R_OFF, dres + at, w.bytes(i, M, C, 2), lane);
  };
  // chunk k of the lane's row of dxn in the stage: 8 values
  auto load_d = [&](const uint8_t* slot, int k, float d[8]) {
    Vec8<TD> v;
    v.load(reinterpret_cast<const TD*>(slot + D_OFF) + w.sub * C + w.col(k));
    v.unpack(d);
  };
#pragma unroll
  for (int i = 0; i < LN_BWD_STAGES - 1; ++i) {
    if (i < w.n) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < w.n; ++i) {
    __syncwarp();  // every lane is done with the stage the next copy refills
    if (i + LN_BWD_STAGES - 1 < w.n) issue(i + LN_BWD_STAGES - 1);
    cp_async_commit();
    cp_async_wait<LN_BWD_STAGES - 1>();
    __syncwarp();  // and every lane's pieces of step i have landed
    const long r = w.row(i);
    const bool valid = r < M;
    const uint8_t* slot = ln_smem + ring + (i % LN_BWD_STAGES) * LN_BWD_STAGE_BYTES;
    uint4 xr[LN_KMAX];
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int k = 0; k < LN_KMAX; ++k) {
      xr[k] = valid && w.has(k)
                  ? *reinterpret_cast<const uint4*>(slot + (w.sub * C + w.col(k)) * 2)
                  : make_uint4(0, 0, 0, 0);
      float v[8];
      unpack8(xr[k], v);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s += v[e];
        ss += v[e] * v[e];
      }
    }
    s = group_sum(s, lanes);
    ss = group_sum(ss, lanes);
    const float mean = s / C;
    const float rstd = rsqrtf(fmaxf(ss / C - mean * mean, 0.f) + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < LN_KMAX; ++k) {
      if (!valid || !w.has(k)) continue;
      float v[8], d[8], gv[8];
      unpack8(xr[k], v);
      load_d(slot, k, d);
      g[k].unpack(gv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float xh = (v[e] - mean) * rstd;
        const float gx = d[e] * gv[e];
        if constexpr (WANT) {
          pg[k][e] += d[e] * xh;
          pb[k][e] += d[e];
        }
        s1 += gx;
        s2 += gx * xh;
      }
    }
    s1 = group_sum(s1, lanes) / C;
    s2 = group_sum(s2, lanes) / C;
    if (!valid) continue;
#pragma unroll
    for (int k = 0; k < LN_KMAX; ++k) {
      if (!w.has(k)) continue;
      float v[8], d[8], gv[8], rv[8], o[8];
      unpack8(xr[k], v);
      load_d(slot, k, d);
      g[k].unpack(gv);
      if (dres)
        unpack8(*reinterpret_cast<const uint4*>(slot + R_OFF + (w.sub * C + w.col(k)) * 2), rv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float xh = (v[e] - mean) * rstd;
        o[e] = rstd * (d[e] * gv[e] - s1 - xh * s2) + (dres ? rv[e] : 0.f);
      }
      *reinterpret_cast<uint4*>(dx + r * C + w.col(k)) = pack8(o);
    }
  }
  cp_async_wait<0>();
  __syncwarp();  // every lane's copies have landed before the ring is reused
  if constexpr (WANT) {
    // the warp's groups: lanes j, j + lanes, ... hold the same columns
    for (int o = lanes; o < 32; o <<= 1) {
#pragma unroll
      for (int k = 0; k < LN_KMAX; ++k)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          pg[k][e] += __shfl_xor_sync(0xffffffffu, pg[k][e], o);
          pb[k][e] += __shfl_xor_sync(0xffffffffu, pb[k][e], o);
        }
    }
    // the warp's 2C sums into its own ring (no copy is in flight any more)
    float* red = reinterpret_cast<float*>(ln_smem + ring);
    if (lane < lanes) {
#pragma unroll
      for (int k = 0; k < LN_KMAX; ++k) {
        if (!w.has(k)) continue;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          red[w.col(k) + e] = pg[k][e];
          red[C + w.col(k) + e] = pb[k][e];
        }
      }
    }
    __syncthreads();
    const int quads = 2 * C / 4;
    constexpr int WARP_FLOATS = LN_BWD_STAGES * LN_BWD_STAGE_BYTES / 4;
    for (int q = threadIdx.x; q < quads; q += blockDim.x) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < LN_BWD_WARPS; ++u) {
        const float4 v =
            reinterpret_cast<const float4*>(reinterpret_cast<const float*>(ln_smem) +
                                            u * WARP_FLOATS)[q];
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      reinterpret_cast<float4*>(part + (size_t)blockIdx.x * 2 * C)[q] = acc;
    }
    // the fold: the last block of each group of LN_FOLD, then the last group.
    // Thread 0 arrives for its block after the barrier: a release of the
    // block's writes and an acquire of the others', for the reads after the
    // next barrier.
    __shared__ int ticket;
    const int groups = (gridDim.x + LN_FOLD - 1) / LN_FOLD, group = blockIdx.x / LN_FOLD;
    const int b0 = group * LN_FOLD, nb = min((int)gridDim.x - b0, LN_FOLD);
    float* group_rows = part + (size_t)gridDim.x * 2 * C;
    __syncthreads();
    if (threadIdx.x == 0) ticket = arrive(counters + group);
    __syncthreads();
    if (ticket != nb - 1) return;
    for (int q = threadIdx.x; q < quads; q += blockDim.x)
      reinterpret_cast<float4*>(group_rows + (size_t)group * 2 * C)[q] =
          fold_quad(part + (size_t)b0 * 2 * C, nb, quads, q);
    __syncthreads();
    if (threadIdx.x == 0) {
      counters[group] = 0;
      ticket = arrive(counters + groups);
    }
    __syncthreads();
    if (ticket != groups - 1) return;
    for (int q = threadIdx.x; q < quads; q += blockDim.x) {
      const float4 v = fold_quad(group_rows, groups, quads, q);
      float* dst = 4 * q < C ? dgamma + 4 * q : dbeta + 4 * q - C;
      *reinterpret_cast<float4*>(dst) = v;
    }
    if (threadIdx.x == 0) counters[groups] = 0;
  }
}

// Whether a launch of `grid` blocks of `warps` warps is the plan's for M
// rows of C: lanes a power of 2 with at most LN_KMAX chunks a lane, every
// block with a step to take.
static inline bool ln_launch_ok(int M, int C, int lanes, int grid, int warps) {
  if (M <= 0 || C <= 0 || C % 8 || C > LN_MAX_C || lanes <= 0 || lanes > 32 ||
      (lanes & (lanes - 1)) || (C / 8 + lanes - 1) / lanes > LN_KMAX)
    return false;
  const long steps = (M + 32 / lanes - 1) / (32 / lanes);
  return grid > 0 && grid <= (steps + warps - 1) / warps;
}

// Shared memory for `smem`-byte blocks, and the carveout that fits
// LN_BLOCKS_PER_SM of them on an SM.
static inline cudaError_t ln_prepare(const void* kernel, int smem) {
  if (cudaError_t e =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
    return e;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace vk

using vk::bf16;

// x, out (M, C) bf16; gamma, beta (C) fp32 or bf16 (w_bf16), every pointer
// 16-byte aligned; `lanes` lanes a row and `grid` blocks as ops/norms.py
// ln_plan says. C % 8 == 0, C <= 1280.
extern "C" int vk_layer_norm(const void* x, const void* gamma, const void* beta, void* out, int M,
                             int C, int lanes, int grid, int w_bf16, float eps, void* stream) {
  using namespace vk;
  if (!ln_launch_ok(M, C, lanes, grid, LN_FWD_WARPS) ||
      ((uintptr_t)x | (uintptr_t)gamma | (uintptr_t)beta | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  auto launch = [&](auto kernel, auto* g, auto* b) {
    if (cudaError_t e = ln_prepare((const void*)kernel, LN_FWD_SMEM)) return (int)e;
    kernel<<<grid, LN_FWD_WARPS * 32, LN_FWD_SMEM, (cudaStream_t)stream>>>(
        (const bf16*)x, g, b, (bf16*)out, M, C, lanes, eps);
    return (int)cudaGetLastError();
  };
  if (w_bf16) return launch(layer_norm_kernel<bf16>, (const bf16*)gamma, (const bf16*)beta);
  return launch(layer_norm_kernel<float>, (const float*)gamma, (const float*)beta);
}

template <typename TG, typename TD, bool WANT>
static int ln_bwd_launch(const void* x, const void* dxn, const void* gamma, const void* dres,
                         void* dx, void* part, void* dgamma, void* dbeta, void* counters, int M,
                         int C, int lanes, int grid, float eps, void* stream) {
  using namespace vk;
  auto kernel = ln_bwd_kernel<TG, TD, WANT>;
  if (cudaError_t e = ln_prepare((const void*)kernel, LN_BWD_SMEM)) return (int)e;
  kernel<<<grid, LN_BWD_WARPS * 32, LN_BWD_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)x, (const TD*)dxn, (const TG*)gamma, (const bf16*)dres, (bf16*)dx,
      (float*)part, (float*)dgamma, (float*)dbeta, (int*)counters, M, C, lanes, eps);
  return (int)cudaGetLastError();
}

template <typename TG, typename TD>
static int ln_bwd_want(int want, const void* x, const void* dxn, const void* gamma,
                       const void* dres, void* dx, void* part, void* dgamma, void* dbeta,
                       void* counters, int M, int C, int lanes, int grid, float eps,
                       void* stream) {
  return want ? ln_bwd_launch<TG, TD, true>(x, dxn, gamma, dres, dx, part, dgamma, dbeta,
                                            counters, M, C, lanes, grid, eps, stream)
              : ln_bwd_launch<TG, TD, false>(x, dxn, gamma, dres, dx, part, dgamma, dbeta,
                                             counters, M, C, lanes, grid, eps, stream);
}

// x (M, C) bf16, dxn (M, C) fp32 or bf16 (dxn_bf16), gamma (C) fp32 or bf16
// (gamma_bf16), dres (M, C) bf16 or null -> dx (M, C) bf16; unless `part` is
// null also dgamma, dbeta (C) fp32, with `part` a workspace of (grid +
// ceil(grid / LN_FOLD)) x 2C fp32 and `counters` LN_COUNTERS ints, zero
// before the launch and zero after it. Every pointer 16-byte aligned; lanes
// and grid as ops/norms.py ln_plan says. C % 8 == 0, C <= 1280.
extern "C" int vk_ln_bwd(const void* x, const void* dxn, const void* gamma, const void* dres,
                         void* dx, void* part, void* dgamma, void* dbeta, void* counters, int M,
                         int C, int lanes, int grid, int dxn_bf16, int gamma_bf16, float eps,
                         void* stream) {
  using namespace vk;
  const int want = part != nullptr;
  if (!ln_launch_ok(M, C, lanes, grid, LN_BWD_WARPS) ||
      ((uintptr_t)x | (uintptr_t)dxn | (uintptr_t)gamma | (uintptr_t)dres | (uintptr_t)dx |
       (uintptr_t)part | (uintptr_t)dgamma | (uintptr_t)dbeta) % 16 ||
      (want && (!dgamma || !dbeta || !counters ||
                (grid + LN_FOLD - 1) / LN_FOLD + 1 > LN_COUNTERS)))
    return (int)cudaErrorInvalidValue;
  if (gamma_bf16)
    return dxn_bf16 ? ln_bwd_want<bf16, bf16>(want, x, dxn, gamma, dres, dx, part, dgamma, dbeta,
                                              counters, M, C, lanes, grid, eps, stream)
                    : ln_bwd_want<bf16, float>(want, x, dxn, gamma, dres, dx, part, dgamma,
                                               dbeta, counters, M, C, lanes, grid, eps, stream);
  return dxn_bf16 ? ln_bwd_want<float, bf16>(want, x, dxn, gamma, dres, dx, part, dgamma, dbeta,
                                             counters, M, C, lanes, grid, eps, stream)
                  : ln_bwd_want<float, float>(want, x, dxn, gamma, dres, dx, part, dgamma, dbeta,
                                              counters, M, C, lanes, grid, eps, stream);
}

// The blocks of each LayerNorm kernel that fit an SM at its launch, into
// out[10]: the forward with fp32 and bf16 gamma/beta, then the backward's
// eight instances (gamma fp32, bf16) x (dxn fp32, bf16) x (dgamma/dbeta
// wanted, not).
extern "C" int vk_ln_occupancy(int* out) {
  using namespace vk;
  const void* kernels[10] = {(const void*)layer_norm_kernel<float>,
                             (const void*)layer_norm_kernel<bf16>,
                             (const void*)ln_bwd_kernel<float, float, true>,
                             (const void*)ln_bwd_kernel<float, float, false>,
                             (const void*)ln_bwd_kernel<float, bf16, true>,
                             (const void*)ln_bwd_kernel<float, bf16, false>,
                             (const void*)ln_bwd_kernel<bf16, float, true>,
                             (const void*)ln_bwd_kernel<bf16, float, false>,
                             (const void*)ln_bwd_kernel<bf16, bf16, true>,
                             (const void*)ln_bwd_kernel<bf16, bf16, false>};
  for (int i = 0; i < 10; ++i) {
    const int smem = i < 2 ? LN_FWD_SMEM : LN_BWD_SMEM;
    const int threads = 32 * (i < 2 ? LN_FWD_WARPS : LN_BWD_WARPS);
    if (cudaError_t e = ln_prepare(kernels[i], smem)) return (int)e;
    if (cudaError_t e =
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + i, kernels[i], threads, smem))
      return (int)e;
  }
  return 0;
}
