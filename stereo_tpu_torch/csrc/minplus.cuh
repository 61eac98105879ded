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

// The fused sweeps' thread block is TILE x blockDim.y threads: phase A
// gives threadIdx.x a lane of a tile of TILE neighbouring lanes (label planes
// are contiguous along lanes, so a warp reads 128 contiguous bytes of every
// plane) and threadIdx.y a share of the labels; phase B's jobs (send_job)
// are J lanes wide, J in {32, 16, 8}, and spread the same threads over the J
// lanes and the targets.  A block has at most MAX_TB warps (a thread of the
// fused sweeps holds 168 registers, and twelve such warps fill a
// multiprocessor's 65,536); a pass holds blockDim.y * KT targets of every
// lane, and K > MAX_TB * KT labels take several passes.
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

// The minima over threadIdx.y of both parts of `v` at once, per threadIdx.x,
// through `sm` ([MAX_TB][TILE] float2): two barriers for two minima.  The
// same contract as block_min_over_y.
__device__ __forceinline__ float2 block_min2_over_y(float2 v,
                                                    float2 (*sm)[TILE]) {
  sm[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  float2 m = sm[0][threadIdx.x];
  for (int y = 1; y < (int)blockDim.y; ++y) {
    const float2 w = sm[y][threadIdx.x];
    m = make_float2(fminf(m.x, w.x), fminf(m.y, w.y));
  }
  __syncthreads();
  return m;
}

// The staging area of one block: two [K][TILE] float planes (send_job: the
// source heights and positions of up to TILE lanes).  It lies in
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

// send_job's wait in the fused sweeps' phase B: the lanes of warp 0 poll
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

// Phase B's job widths, widest first: a job is one send for J neighbouring
// lanes, J = TILE >> i for i < N_WIDTHS.  JOB_FIXED is what a job costs
// besides its walk (its wait, the round trip of its staging, its barriers
// and writes), counted in warp-terms: a walk is passes x K x KT J / TILE
// terms a thread in each of the block's warps, and an SM issues about one
// warp-term a cycle, so JOB_FIXED is about a microsecond; job_width weighs
// the two.
constexpr int N_WIDTHS = 3;
constexpr int MIN_JOB = TILE >> (N_WIDTHS - 1);
constexpr int JOB_FIXED = 2048;

// The job width of a step of phase B: the width whose jobs the resident
// grid runs in the least time, rounds(J) x (walk(J) + JOB_FIXED) with
// rounds(J) = ceil(jobs[i] / grid) for J = TILE >> i; a tie goes to the
// narrower width.  So a thin step is cut into narrower jobs wherever they
// reach idle blocks without a further round (a step of up to grid / 2 jobs
// TILE lanes wide always is), and a busy step takes the width whose rounds
// come out even.  (Cutting every step of fewer jobs than blocks, a further
// round or not, was 5-10% slower on the banded sweep: PERF.md.)
// ops/minplus.py::job_width is the same rule.
__host__ __device__ inline int job_width(const int (&jobs)[N_WIDTHS],
                                         int grid, int K, int passes,
                                         int warps) {
  int best = TILE;
  long long best_cost = -1;
  for (int i = 0; i < N_WIDTHS; ++i) {
    const int J = TILE >> i;
    const int rounds = (jobs[i] + grid - 1) / grid;
    const long long cost =
        rounds * ((long long)passes * K * (KT * J / TILE) * warps +
                  JOB_FIXED);
    if (best_cost < 0 || cost <= best_cost) {
      best = J;
      best_cost = cost;
    }
  }
  return best;
}

// acc[u] = min(acc[u], h + a * c(x[u], y)) over the K staged (h, y) pairs
// of a lane (`stride` float2 apart), c the hoisted |x - y|^KERNEL (HOIST) or
// the truncated cost TR.  A term is sub, mul (|.| is an operand modifier),
// add, min with HOIST: four issued instructions (kernel 2: five, the square
// is a mul); one more, the truncation's min, without.
template <int KERNEL, bool HOIST, int N>
__device__ __forceinline__ void walk(const float2* hy, int stride, int K,
                                     const float (&x)[N], float a, float tol,
                                     float (&acc)[N]) {
#pragma unroll 4
  for (int s = 0; s < K; ++s) {
    const float2 v = hy[s * stride];
#pragma unroll
    for (int u = 0; u < N; ++u) {
      float c;
      if (HOIST) {
        const float d = x[u] - v.y;
        c = (KERNEL == 1) ? fabsf(d) : d * d;
      } else {
        c = trunc_cost<KERNEL>(x[u], v.y, tol);
      }
      acc[u] = fminf(acc[u], v.x + a * c);
    }
  }
}

// Thread (x, y) of the block in a job of J lanes: lane x % J of the job and
// target slice y * (TILE / J) + x / J of blockDim.y * TILE / J; a slice
// holds KT * J / TILE targets a pass, so a pass covers blockDim.y * KT
// targets of every lane at every width.
template <int J>
__device__ __forceinline__ int job_lane() {
  return threadIdx.x % J;
}
template <int J>
__device__ __forceinline__ bool job_lead() {  // the lane's slice 0
  return threadIdx.y == 0 && threadIdx.x < J;
}

// One send for the job's lane of the calling thread, done together by the
// blockDim.y * TILE / J threads of that lane (its slices):
//
//   out[t] = min_s ( h[s] + a * TR(xt[t] - ys[s]) ) - vmin,   t, s < K
//   vmin   = min_t of the un-normalised out[t]
//   h[s]   = g[s] - m[s]
//
// All pointers are already offset to the lane; label planes are `*_stride`
// floats apart.  `in`: the lane's addresses are valid, so its loads are
// issued; `active` (implies `in`): the send is real, it is walked, takes
// part in vmin and writes `out`.  A thread with neither takes part in the
// barriers and shuffles only.  Returns vmin (of an active lane).
//
// The truncation is taken out of the K^2 walk.  Rounding is monotone, so for
// a >= 0 (-0.0 included) fl(a min(c, tol)) = min(fl(a c), fl(a tol)) and
// fl(h + min(A, B)) = min(fl(h + A), fl(h + B)); hence
//
//   out[t] + vmin = min( min_s (h[s] + a |xt[t] - ys[s]|^KERNEL), far ),
//   far           = min_s (h[s] + a tol),
//
// the same bits, with `far` formed by the threads that stage h (K terms a
// lane, not a term of the walk).  A lane whose `a >= 0.0f` is false (a < 0,
// or a NaN) walks the plain term, truncation inside; the branch is per lane
// and uniform on every solver path, whose weights are >= 0.
//
// The loads come in the order of what they wait for:
//   1. the problem's: the source positions ys into the staging area
//      (stage_copy, asynchronous in shared memory) and the first pass's
//      targets xt into registers;
//   2. wait(): a block-wide wait of the caller's for the state that g and m
//      hold (the fused sweeps' per-tile ready flags, TileWait) -- the
//      problem loads above are in flight meanwhile;
//   3. the state's: h = g - m into the staging area, through L2 (__ldcg:
//      g and m may have been written by other blocks of the same launch,
//      and the non-coherent read-only path must not serve them).
// The staging area holds the job's [K][J] (h, y) pairs, so a slice reads a
// source's pair with one 64-bit load and a warp's slices share it.  Then
// one barrier, and every pass walks the K staged sources once.  `out` may
// alias `m` (an in-place message update): every source is read before that
// barrier, every target written after it.  Earlier passes write their sums
// un-normalised and correct them once vmin is known (min is exact, so the
// result does not depend on the passes).  far and vmin are reduced over a
// lane's slices by shuffles within a warp, then across warps through `sm`.
template <int KERNEL, bool SMEM, int J, typename Wait>
__device__ __forceinline__ float send_job(
    bool in, bool active, const float* g, long long g_stride,
    const float* m, long long m_stride, const float* __restrict__ xt,
    long long xt_stride, const float* __restrict__ ys, long long ys_stride,
    float a, float tol, int K, float* out, long long out_stride,
    float2 (*sm)[TILE], float* stage, Wait wait) {
  constexpr int N = KT * J / TILE;  // targets of a slice in a pass
  const int slices = blockDim.y * (TILE / J);
  const int slice = threadIdx.y * (TILE / J) + threadIdx.x / J;
  const int npass = target_passes(K);
  float2* hy = reinterpret_cast<float2*>(stage) + job_lane<J>();
  const bool hoist = a >= 0.0f;  // false for a < 0 (and a NaN)
  const float at = hoist ? a * tol : CUDART_INF_F;
  float x[N];
  float acc[N];
  if (in) {
    for (int s = slice; s < K; s += slices)
      stage_copy<SMEM>(&hy[s * J].y, ys + s * ys_stride);
    const int t0 = slice * N;
#pragma unroll
    for (int u = 0; u < N; ++u)
      x[u] = xt[min(t0 + u, K - 1) * xt_stride];  // ragged: target K-1 again
  }
  wait();
  float far = CUDART_INF_F;  // this thread's part of min_s h[s] + a tol
  if (in) {
#pragma unroll 4
    for (int s = slice; s < K; s += slices) {
      const float h = __ldcg(g + s * g_stride) - __ldcg(m + s * m_stride);
      hy[s * J].x = h;
      far = fminf(far, h + at);
    }
  }
  stage_wait<SMEM>();
  __syncthreads();
  float part = CUDART_INF_F;
  for (int p = 0; p < npass; ++p) {
    const int t0 = (p * slices + slice) * N;
    if (!active || t0 >= K) continue;
    if (p > 0) {
#pragma unroll
      for (int u = 0; u < N; ++u) x[u] = xt[min(t0 + u, K - 1) * xt_stride];
    }
#pragma unroll
    for (int u = 0; u < N; ++u) acc[u] = CUDART_INF_F;
    if (hoist)
      walk<KERNEL, true>(hy, J, K, x, a, tol, acc);
    else
      walk<KERNEL, false>(hy, J, K, x, a, tol, acc);
#pragma unroll
    for (int u = 0; u < N; ++u) part = fminf(part, acc[u]);
    if (p + 1 < npass) {
#pragma unroll
      for (int u = 0; u < N; ++u)
        if (t0 + u < K) out[(t0 + u) * out_stride] = acc[u];
    }
  }
  // (far, vmin) of the lane: over its slices in the warp, then the warps
  float2 v = make_float2(far, fminf(part, far));
#pragma unroll
  for (int o = J; o < TILE; o *= 2) {
    v.x = fminf(v.x, __shfl_xor_sync(0xffffffffu, v.x, o));
    v.y = fminf(v.y, __shfl_xor_sync(0xffffffffu, v.y, o));
  }
  v = block_min2_over_y(v, sm);
  far = v.x;
  const float vmin = v.y;
  if (active) {
    for (int p = 0; p < npass; ++p) {
      const int t0 = (p * slices + slice) * N;
      if (t0 >= K) continue;
#pragma unroll
      for (int u = 0; u < N; ++u) {
        if (t0 + u < K) {
          float* o = out + (t0 + u) * out_stride;
          *o = fminf(p + 1 < npass ? *o : acc[u], far) - vmin;
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
// `jobs` blocks (one job a block; a `persistent` launch, whose jobs can be
// cut narrower, takes one block an SM at least), but no more than are
// resident at once where the launch is `persistent` (cooperative) or stages
// in scratch (the kernels then loop over their jobs), so the scratch is
// bounded by the device, not the work.
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
  long long grid = persistent && jobs < sms ? sms : jobs;
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
