// Both min-plus variants of one edge direction from one walk over the K x K
// label pairs, for NVIDIA Hopper (sm_90a), float32.  Replaces the TPU kernel
// stereo_tpu/ops/minplus.py::_tile_kernel (minplus_pair_pallas).
//
// For every pixel n of N = H * W, with a = alpha[n]:
//
//   msgA[j][n] = min_i ( H_A[i][n] + a * TR(P[i][n] - R[j][n]) )
//   msgB[i][n] = min_j ( H_B[j][n] + a * TR(P[i][n] - R[j][n]) )
//
// un-normalised.  Every term a * TR(P[i] - R[j]) is evaluated once and used
// for both outputs.
//
// Plain C interface (loaded with ctypes): raw device pointers and a CUDA
// stream; launches on that stream without synchronising, allocates nothing,
// returns the launch's error code.  Built with -fmad=false (ops/_build.py),
// so the result equals the plain PyTorch version's bit for bit (a minimum
// does not depend on the order it is taken in).  Inputs must be finite.
//
// The truncation is taken out of the K^2 loop, for both outputs: rounding is
// monotone, so for a >= 0 (-0.0 included)
//
//   msgB[i] = min( min_j (H_B[j] + a * |P_i - R_j|^k), min_j H_B[j] + a * tol )
//   msgA[j] = min( min_i (H_A[i] + a * |P_i - R_j|^k), min_i H_A[i] + a * tol )
//
// bit for bit.  A pair is then sub, mul (|.| is an operand modifier), add,
// min, add, min: six issued float32 instructions (kernel 2: seven) against
// eight with the truncation inside.  A pixel whose `a >= 0.0f` is false
// walks the plain term.
//
// What bounds it: K^2 label pairs per pixel against (4 K + 1) planes read and
// 2 K written; at K = 79 on teddy's 375 x 450 the pairs, about 0.19 ms at six
// issued instructions a pair on 132 SMs, against 0.10 ms of bytes.
//
// Design (csrc/phase_kernel.cu's send, with a second output): a block covers
// a tile of TILE = 32 pixels (threadIdx.x) and the K sources i in groups of
// KP (threadIdx.y): a thread holds P[i], H_A[i] and the running minima of
// msgB[i] of its KP sources in registers.  The tile's (R[j], H_B[j]) pairs
// are copied into shared memory CHUNK at a time with cp.async,
// double-buffered, and every thread walks them once.  Per target j a thread
// stores the minimum over its own sources of msgA[j] into shared memory;
// the block reduces a whole chunk's minima over threadIdx.y after the one
// barrier that also publishes the next chunk, and writes them.  msgB is
// written once from registers.  Above MAX_GROUPS groups the sources are
// walked in passes, each walking every j again; msgA of a pass is the
// minimum of the pass's and what the passes before wrote (the hoisted
// minimum over a pass's own sources is exact on its own, so the passes'
// minima compose).  The staging area does not grow with K, so no K is
// refused.  Ragged edges: a missing pixel loads pixel N - 1 and writes
// nothing; a source i >= K carries H_A = +inf.

#include "minplus.cuh"

namespace {

using minplus::TILE;
using minplus::block_min_over_y;
using minplus::trunc_cost;

constexpr int KP = 20;          // sources a thread holds in registers
constexpr int MAX_GROUPS = 8;   // warps of sources per block at most
constexpr int CHUNK = 16;       // targets j per staged chunk
static_assert(MAX_GROUPS <= minplus::MAX_TB, "block_min_over_y's rows");

// Dynamic shared memory of a block of `groups` warps: the minima of msgA of
// two chunks, [buffer][threadIdx.y][j][x].
size_t reduce_bytes(int groups) {
  return 2 * (size_t)groups * CHUNK * TILE * sizeof(float);
}

// Walk n staged (R[j], H_B[j]) pairs: accB[u] = min over j of
// H_B[j] + a * c(P[u] - R[j]) and, per j, the minimum over u of
// H_A[u] + a * c into mA[j * TILE]; c the hoisted |.|^kernel (HOIST) or the
// truncated cost.
template <int KERNEL, bool HOIST>
__device__ __forceinline__ void walk(const float2* rh, int n,
                                     const float (&p)[KP],
                                     const float (&ha)[KP], float a,
                                     float tol, float (&accB)[KP],
                                     float* mA) {
#pragma unroll 2
  for (int j = 0; j < n; ++j) {
    const float2 v = rh[j * TILE];  // (R[j], H_B[j])
    float m0 = CUDART_INF_F, m1 = CUDART_INF_F;  // two chains, not one
#pragma unroll
    for (int u = 0; u < KP; ++u) {
      float c;
      if (HOIST) {
        const float d = p[u] - v.x;
        c = (KERNEL == 1) ? fabsf(d) : d * d;
      } else {
        c = trunc_cost<KERNEL>(p[u], v.x, tol);
      }
      const float term = a * c;
      accB[u] = fminf(accB[u], v.y + term);
      if (u & 1) m1 = fminf(m1, ha[u] + term);
      else m0 = fminf(m0, ha[u] + term);
    }
    mA[j * TILE] = fminf(m0, m1);
  }
}

template <int KERNEL>
__global__ void __launch_bounds__(MAX_GROUPS * TILE)
minplus_pair_kernel(const float* __restrict__ HA,     // [K, N]
                    const float* __restrict__ HB,     // [K, N]
                    const float* __restrict__ P,      // [K, N]
                    const float* __restrict__ R,      // [K, N]
                    const float* __restrict__ alpha,  // [N]
                    float* __restrict__ msgA,         // [K, N]
                    float* __restrict__ msgB,         // [K, N]
                    float tol, int K, long long N) {
  // buffer, target j of the chunk, pixel x: (R, H_B) at [j][x]
  __shared__ __align__(16) float rh[2][CHUNK * TILE * 2];
  __shared__ float sm[minplus::MAX_TB][TILE];
  extern __shared__ float red[];  // [2][blockDim.y][CHUNK][TILE]
  const int ny = blockDim.y, ty = threadIdx.y, x = threadIdx.x;
  const long long n0 = (long long)blockIdx.x * TILE + x;
  const bool in = n0 < N;
  const long long n = in ? n0 : N - 1;  // a missing pixel loads the last
  const float a = alpha[n];
  const bool hoist = a >= 0.0f;  // false for a < 0 (and a NaN)
  const float at = hoist ? a * tol : CUDART_INF_F;
  const int chunk = min(K, CHUNK), nchunks = (K + chunk - 1) / chunk;
  const int npass = ((K + KP - 1) / KP + ny - 1) / ny;
  const int red_buf = ny * CHUNK * TILE;

  // the copies of chunk c into buffer c & 1: thread (x, ty) copies targets
  // ty, ty + ny, .. of its pixel
  auto issue = [&](int c) {
    const int j0 = c * chunk, cnt = min(chunk, K - j0), bf = c & 1;
    for (int j = ty; j < cnt; j += ny) {
      const int i = j * TILE + x;
      const long long src = (long long)(j0 + j) * N + n;
      __pipeline_memcpy_async(&rh[bf][2 * i], R + src, sizeof(float));
      __pipeline_memcpy_async(&rh[bf][2 * i + 1], HB + src, sizeof(float));
    }
    __pipeline_commit();
  };
  // msgA of chunk c from the minima its walk stored: thread (x, ty) takes
  // the chunk's targets ty, ty + ny, ..
  auto reduce = [&](int c, int q, float farA) {
    const int j0 = c * chunk, cnt = min(chunk, K - j0);
    const float* col = red + (c & 1) * red_buf + x;
    for (int j = ty; j < cnt; j += ny) {
      float m = farA;
      for (int y = 0; y < ny; ++y) m = fminf(m, col[(y * CHUNK + j) * TILE]);
      if (!in) continue;
      float* o = msgA + (long long)(j0 + j) * N + n;
      *o = q > 0 ? fminf(*o, m) : m;  // the passes before: this thread's
    }
  };

  float farB = CUDART_INF_F;  // this thread's part of min_j H_B[j] + a tol
  for (int q = 0; q < npass; ++q) {
    // pass q gives thread ty the sources i0 + [0, KP)
    const int i0 = (q * ny + ty) * KP;
    issue(0);
    float p[KP], ha[KP], accB[KP];
    float farA = CUDART_INF_F;  // min over the thread's i of H_A[i] + a tol
#pragma unroll
    for (int u = 0; u < KP; ++u) {
      const long long i = min(i0 + u, K - 1);  // ragged: H_A = +inf
      p[u] = P[i * N + n];
      ha[u] = i0 + u < K ? HA[i * N + n] : CUDART_INF_F;
      accB[u] = CUDART_INF_F;
      farA = fminf(farA, ha[u] + at);
    }
    farA = block_min_over_y(farA, sm);  // over the pass's sources
    float* mA = red + ty * CHUNK * TILE + x;
    for (int c = 0; c < nchunks; ++c) {
      const int cnt = min(chunk, K - c * chunk), bf = c & 1;
      // the thread's own copies of chunk c have landed
      __pipeline_wait_prior(0);
      for (int j = ty; j < cnt; j += ny)
        farB = fminf(farB, rh[bf][2 * (j * TILE + x) + 1] + at);
      // chunk c is complete for the block; chunk c - 1 is walked and its
      // minima stored by all, and chunk c - 2's reduced: its buffers take
      // chunk c + 1 and chunk c's minima
      __syncthreads();
      if (c + 1 < nchunks) issue(c + 1);
      if (c > 0) reduce(c - 1, q, farA);
      const float2* v = reinterpret_cast<const float2*>(rh[bf]) + x;
      float* out = mA + bf * red_buf;
      if (hoist) walk<KERNEL, true>(v, cnt, p, ha, a, tol, accB, out);
      else walk<KERNEL, false>(v, cnt, p, ha, a, tol, accB, out);
    }
    __syncthreads();
    reduce(nchunks - 1, q, farA);
    // every thread has staged its targets by now: farB is the block's
    const float fB = block_min_over_y(farB, sm);
    if (in) {
#pragma unroll
      for (int u = 0; u < KP; ++u)
        if (i0 + u < K) msgB[(long long)(i0 + u) * N + n] = fminf(accB[u], fB);
    }
  }
}

}  // namespace

// A block of 32 pixels x blocks_for<KP, MAX_GROUPS>(K) warps per tile.
// Returns 0 or the CUDA error code.
extern "C" int minplus_pair_f32(const float* HA, const float* HB,
                                const float* P, const float* R,
                                const float* alpha, float* msgA, float* msgB,
                                float tol, int kernel, int K, long long N,
                                void* stream) {
  if (K < 1 || (kernel != 1 && kernel != 2)) return (int)cudaErrorInvalidValue;
  const long long tiles = (N + TILE - 1) / TILE;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (tiles == 0) return 0;
  const int groups = minplus::blocks_for<KP, MAX_GROUPS>(K);
  const dim3 grid((unsigned)tiles), block(TILE, groups);
  cudaStream_t st = (cudaStream_t)stream;
  if (kernel == 1)
    minplus_pair_kernel<1><<<grid, block, reduce_bytes(groups), st>>>(
        HA, HB, P, R, alpha, msgA, msgB, tol, K, N);
  else
    minplus_pair_kernel<2><<<grid, block, reduce_bytes(groups), st>>>(
        HA, HB, P, R, alpha, msgA, msgB, tol, K, N);
  return (int)cudaGetLastError();
}
