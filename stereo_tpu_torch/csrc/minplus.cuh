// Device code shared by the package's CUDA sources: the truncated cost and
// the cooperative column send of the wavefront family of kernels.
//
// Everything here is float32 and is compiled with -fmad=false (see
// ops/_build.py), so h + a * TR(.) stays a separate multiply and add and
// every value equals the plain PyTorch version's bit for bit.
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace minplus {

// TR(q, d0) = min(|q - d0|^KERNEL, tol), KERNEL in {1, 2}.
template <int KERNEL>
__device__ __forceinline__ float trunc_cost(float q, float d0, float tol) {
  float diff = q - d0;
  float c = (KERNEL == 1) ? fabsf(diff) : diff * diff;
  return fminf(c, tol);
}

// A column send is done by a thread block of TILE x blockDim.y threads:
// threadIdx.x is the lane within a tile of TILE neighbouring lanes (label
// planes are contiguous along lanes, so a warp reads 128 contiguous bytes of
// every plane), threadIdx.y the block of KT targets whose running minima the
// thread keeps in registers.  A block has at most MAX_TB warps (a thread of
// the fused sweeps holds about 140 registers, and twelve such warps fill a
// multiprocessor's 65,536); K > MAX_TB * KT labels take several passes, pass
// p giving thread y the targets (p * blockDim.y + y) * KT + [0, KT).
constexpr int TILE = 32;
constexpr int KT = 8;
constexpr int MAX_TB = 12;

// Warps of a block for K labels: ceil(K / KT) up to K = MAX_TB * KT (the
// shape of one pass), else the fewest passes of MAX_TB warps at most, their
// target blocks spread evenly over the warps.
inline int target_blocks(int K) {
  const int blocks = (K + KT - 1) / KT;
  const int passes = (blocks + MAX_TB - 1) / MAX_TB;
  return (blocks + passes - 1) / passes;
}

// The same split for a kernel of its own shape: warps of a block for K
// labels at KT_ targets a warp and MAXW warps at most.
template <int KT_, int MAXW>
inline int blocks_for(int K) {
  const int blocks = (K + KT_ - 1) / KT_;
  const int passes = (blocks + MAXW - 1) / MAXW;
  return (blocks + passes - 1) / passes;
}

// Passes over the targets of a block of blockDim.y warps.
__device__ __forceinline__ int target_passes(int K) {
  return ((K + KT - 1) / KT + (int)blockDim.y - 1) / (int)blockDim.y;
}

// Minimum over threadIdx.y of `v`, per threadIdx.x, through `sm`
// ([MAX_TB][TILE] floats of shared memory).  Every thread of the block must
// call it; the two barriers also order the block's global reads before the
// call against its global writes after it.
__device__ __forceinline__ float block_min_over_y(float v,
                                                  float (*sm)[TILE]) {
  sm[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  float m = sm[0][threadIdx.x];
  for (int y = 1; y < (int)blockDim.y; ++y) m = fminf(m, sm[y][threadIdx.x]);
  __syncthreads();
  return m;
}

// The staging area of one block: two [K][TILE] float planes (send_lane: the
// source heights and positions; the pair kernel: R and H_B).  It lies in
// dynamic shared memory when it fits the block (SMEM; K up to 800-900 on an
// H100, by kernel), else in a slice of a global scratch buffer that the
// wrapper hands in (stage_floats(K) floats per block; plan_stage below
// decides): no K is refused.  The fused sweeps' sends overwrite their own
// sources (out == m), so every source must be staged before any target is
// written: chunks of sources through a smaller shared area would not do.
__host__ __device__ inline size_t stage_floats(int K) {
  return 2 * (size_t)K * TILE;
}
inline size_t stage_bytes(int K) {
  return stage_floats(K) * sizeof(float);
}

// One float from global memory into the staging area: asynchronously
// (cp.async, no register is held and the thread goes on) into shared
// memory, by a load and a store into global scratch.  stage_wait<SMEM>()
// waits for the thread's copies; a __syncthreads() after it publishes them.
template <bool SMEM>
__device__ __forceinline__ void stage_copy(float* dst, const float* src) {
  if constexpr (SMEM)
    __pipeline_memcpy_async(dst, src, sizeof(float));
  else
    *dst = *src;
}

template <bool SMEM>
__device__ __forceinline__ void stage_wait() {
  if constexpr (SMEM) {
    __pipeline_commit();
    __pipeline_wait_prior(0);
  }
}

// send_lane's default wait: nothing to wait for.
struct NoWait {
  __device__ __forceinline__ void operator()() const {}
};

// Release and acquire at device scope, for the fused sweeps' per-tile ready
// flags: phase A's tile publishes the step's epoch with a release store
// after a __syncthreads() (so every thread's writes of the tile come
// first); a phase-B job acquires it before it reads what the tile wrote.
__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}
__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// send_lane's wait in the fused sweeps' phase B: the lanes of warp 0 poll
// the flags of phase-A tiles first .. last of the step, one flag each (32
// at a time), until all have published the step's epoch; then the block
// passes a barrier.  Nothing to wait for when last < first.
struct TileWait {
  const int* flags;
  int first, last, epoch;
  __device__ __forceinline__ void operator()() const {
    if (threadIdx.y == 0) {
      for (int j0 = first; j0 <= last; j0 += TILE) {
        const int j = j0 + threadIdx.x;
        bool ready = j > last;
        while (!__all_sync(0xffffffffu, ready))
          if (!ready) ready = load_acquire(flags + j) >= epoch;
      }
    }
    __syncthreads();
  }
};

// One send for the lane of the calling thread, done together by the
// blockDim.y threads that share threadIdx.x:
//
//   out[t] = min_s ( h[s] + a * TR(xt[t] - ys[s]) ) - vmin,   t, s < K
//   vmin   = min_t of the un-normalised out[t]
//   h[s]   = g[s] - m[s]   (SUB)   or   g[s]   (!SUB)
//
// All pointers are already offset to the lane; label planes are `*_stride`
// floats apart.  `in`: the lane's addresses are valid, so its loads are
// issued; `active` (implies `in`): the send is real, it is walked, takes
// part in vmin and writes `out`.  A thread with neither takes part in the
// barriers only.  Returns vmin (of an active lane).
//
// The loads come in the order of what they wait for:
//   1. the problem's: the source positions ys into the staging area
//      (stage_copy, asynchronous in shared memory) and the first pass's
//      targets xt into registers;
//   2. wait(): a block-wide wait of the caller's for the state that g and m
//      hold (the fused sweeps' per-tile ready flags, TileWait; NoWait
//      elsewhere) -- the problem loads above are in flight meanwhile;
//   3. the state's: h = g - m into the staging area, through L2 (__ldcg:
//      g and m may have been written by other blocks of the same launch,
//      and the non-coherent read-only path must not serve them).
// Then one barrier, and every pass walks the K staged sources once.  `out`
// may alias `m` (an in-place message update): every source is read before
// that barrier, every target written after it.  Earlier passes write their
// sums un-normalised and correct them once vmin is known (min is exact, so
// the result does not depend on the passes).
template <int KERNEL, bool SUB, bool SMEM, typename Wait = NoWait>
__device__ __forceinline__ float send_lane(
    bool in, bool active, const float* g, long long g_stride,
    const float* m, long long m_stride, const float* __restrict__ xt,
    long long xt_stride, const float* __restrict__ ys, long long ys_stride,
    float a, float tol, int K, float* out, long long out_stride,
    float (*sm)[TILE], float* stage, Wait wait = Wait()) {
  const int ny = blockDim.y, npass = target_passes(K);
  float* hS = stage + threadIdx.x;             // [K][TILE] source heights
  float* yS = stage + K * TILE + threadIdx.x;  // [K][TILE] source positions
  float x[KT];
  float acc[KT];
  if (in) {
    for (int s = threadIdx.y; s < K; s += ny)
      stage_copy<SMEM>(yS + s * TILE, ys + s * ys_stride);
    const int t0 = threadIdx.y * KT;  // < K: blockDim.y <= ceil(K / KT)
#pragma unroll
    for (int u = 0; u < KT; ++u)
      x[u] = xt[min(t0 + u, K - 1) * xt_stride];  // ragged: target K-1 again
  }
  wait();
  if (in) {
#pragma unroll 4
    for (int s = threadIdx.y; s < K; s += ny) {
      float h = __ldcg(g + s * g_stride);
      if (SUB) h = h - __ldcg(m + s * m_stride);
      hS[s * TILE] = h;
    }
  }
  stage_wait<SMEM>();
  __syncthreads();
  float part = CUDART_INF_F;
  for (int p = 0; p < npass; ++p) {
    const int t0 = (p * ny + threadIdx.y) * KT;
    if (!active || t0 >= K) continue;  // t0 is uniform over a warp
    if (p > 0) {
#pragma unroll
      for (int u = 0; u < KT; ++u) x[u] = xt[min(t0 + u, K - 1) * xt_stride];
    }
#pragma unroll
    for (int u = 0; u < KT; ++u) acc[u] = CUDART_INF_F;
    for (int s = 0; s < K; ++s) {
      float h = hS[s * TILE];
      float y = yS[s * TILE];
#pragma unroll
      for (int u = 0; u < KT; ++u) {
        float term = a * trunc_cost<KERNEL>(x[u], y, tol);
        acc[u] = fminf(acc[u], h + term);
      }
    }
#pragma unroll
    for (int u = 0; u < KT; ++u) part = fminf(part, acc[u]);
    if (p + 1 < npass) {
#pragma unroll
      for (int u = 0; u < KT; ++u)
        if (t0 + u < K) out[(t0 + u) * out_stride] = acc[u];
    }
  }
  float vmin = block_min_over_y(part, sm);
  if (active) {
    for (int p = 0; p < npass; ++p) {
      const int t0 = (p * ny + threadIdx.y) * KT;
      if (t0 >= K) continue;
#pragma unroll
      for (int u = 0; u < KT; ++u) {
        if (t0 + u < K) {
          float* o = out + (t0 + u) * out_stride;
          *o = (p + 1 < npass ? *o : acc[u]) - vmin;
        }
      }
    }
  }
  return vmin;
}

// How a launch stages its sources, decided here and nowhere else.  `fn_s`
// stages them in dynamic shared memory, after `extra` bytes of its own;
// `fn_g` in global scratch, a slice of stage_floats(K) a block.  The shared
// form is taken whenever the device lets one block have extra +
// stage_bytes(K) beside the kernel's static shared memory.  The grid is
// `jobs` blocks (one job a block), but no more than are resident at once
// where the launch is `persistent` (cooperative) or stages in scratch (the
// kernels then loop over their jobs), so the scratch is bounded by the
// device, not the work.
struct StagePlan {
  const void* fn;      // fn_s or fn_g
  size_t dyn;          // its dynamic shared memory
  int grid;            // its blocks
  long long scratch;   // floats of global scratch it needs (0: none)
};

inline cudaError_t plan_stage(const void* fn_s, const void* fn_g,
                              size_t extra, int K, int threads,
                              long long jobs, bool persistent,
                              StagePlan* p) {
  int dev = 0, optin = 0, sms = 0, per_sm = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn_s);
  if (err != cudaSuccess) return err;
  const bool smem =
      attr.sharedSizeBytes + extra + stage_bytes(K) <= (size_t)optin;
  p->fn = smem ? fn_s : fn_g;
  p->dyn = extra + (smem ? stage_bytes(K) : 0);
  // above 48 KB of dynamic shared memory a kernel must opt in
  if (p->dyn > 48 * 1024) {
    err = cudaFuncSetAttribute(
        p->fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p->dyn);
    if (err != cudaSuccess) return err;
  }
  long long grid = jobs;
  if (persistent || !smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, p->fn,
                                                        threads, p->dyn);
    if (err != cudaSuccess) return err;
    if ((long long)per_sm * sms < grid) grid = (long long)per_sm * sms;
  }
  if (grid < 1) return cudaErrorLaunchOutOfResources;
  // a grid of one block a job: at most 2^31 - 1 blocks
  if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  p->grid = (int)grid;
  p->scratch = smem ? 0 : grid * (long long)stage_floats(K);
  return cudaSuccess;
}

// The scratch hand-shake of the C entry points: they take (scratch, floats
// of it, need).  *need is set to the plan's scratch; a plan that needs more
// than it was handed launches nothing and returns 0, and the wrapper calls
// again with what *need asks for (ops/_launch.py::launch_staged).
inline bool scratch_short(const StagePlan& p, long long floats,
                          long long* need) {
  *need = p.scratch;
  return p.scratch > floats;
}

}  // namespace minplus
