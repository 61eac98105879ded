// Device code shared by the package's CUDA sources: the truncated cost and
// the cooperative column send of the wavefront family of kernels.
//
// Everything here is float32 and is compiled with -fmad=false (see
// ops/_build.py), so h + a * TR(.) stays a separate multiply and add and
// every value equals the plain PyTorch version's bit for bit.
#pragma once

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

// A column send is done by a thread block of TILE x ceil(K / KT) threads:
// threadIdx.x is the lane within a tile of TILE neighbouring lanes (label
// planes are contiguous along lanes, so a warp reads 128 contiguous bytes of
// every plane), threadIdx.y the block of KT targets whose running minima the
// thread keeps in registers.
constexpr int TILE = 32;
constexpr int KT = 8;
constexpr int MAX_TB = 32;  // target blocks per thread block: K <= 256

inline int target_blocks(int K) { return (K + KT - 1) / KT; }

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

// Bytes of dynamic shared memory a block needs for send_lane's staging.
inline size_t stage_bytes(int K) { return 2 * (size_t)K * TILE * sizeof(float); }

// One send for the lane of the calling thread, done together by the
// blockDim.y threads that share threadIdx.x:
//
//   out[t] = min_s ( h[s] + a * TR(xt[t] - ys[s]) ) - vmin,   t, s < K
//   vmin   = min_t of the un-normalised out[t]
//   h[s]   = g[s] - m[s]   (SUB)   or   g[s]   (!SUB)
//
// All pointers are already offset to the lane; label planes are `*_stride`
// floats apart.  The block first stages the K source heights and positions
// of its 32 lanes in shared memory (`stage`, stage_bytes(K) bytes): thread y
// fetches sources y, y + blockDim.y, ..., all loads in flight at once, so
// the walk over the sources below waits on no global load.  `out` may alias
// `m` (an in-place message update): every source is read before the
// block-wide barriers inside, every target is written after them.  A thread
// with active == false takes part in the barriers only.  Returns vmin (of an
// active lane).
template <int KERNEL, bool SUB>
__device__ __forceinline__ float send_lane(
    bool active, const float* __restrict__ g, long long g_stride,
    const float* m, long long m_stride, const float* __restrict__ xt,
    long long xt_stride, const float* __restrict__ ys, long long ys_stride,
    float a, float tol, int K, float* out, long long out_stride,
    float (*sm)[TILE], float* stage) {
  const int t0 = threadIdx.y * KT;
  float* hS = stage + threadIdx.x;             // [K][TILE] source heights
  float* yS = stage + K * TILE + threadIdx.x;  // [K][TILE] source positions
  float acc[KT];
  float x[KT];
  float part = CUDART_INF_F;
  if (active) {
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      int s = threadIdx.y + j * blockDim.y;  // blockDim.y * KT >= K
      if (s < K) {
        float h = g[s * g_stride];
        if (SUB) h = h - m[s * m_stride];
        hS[s * TILE] = h;
        yS[s * TILE] = ys[s * ys_stride];
      }
    }
#pragma unroll
    for (int u = 0; u < KT; ++u) {
      int t = min(t0 + u, K - 1);  // ragged last block: recompute target K-1
      x[u] = xt[t * xt_stride];
      acc[u] = CUDART_INF_F;
    }
  }
  __syncthreads();
  if (active) {
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
  }
  float vmin = block_min_over_y(part, sm);
  if (active) {
#pragma unroll
    for (int u = 0; u < KT; ++u) {
      if (t0 + u < K) out[(t0 + u) * out_stride] = acc[u] - vmin;
    }
  }
  return vmin;
}

// Let `kernel` use `bytes` of dynamic shared memory (above 48 KB a kernel
// must opt in).
inline cudaError_t allow_stage(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace minplus
