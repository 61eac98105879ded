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
// returns cudaGetLastError().  Built with -fmad=false (ops/_build.py), so the
// result equals the plain PyTorch version's bit for bit (a minimum does not
// depend on the order it is taken in).  Inputs must be finite.
//
// What bounds it: K^2 label pairs of eight float32 instructions per pixel
// (sub, abs|mul, min, mul, add, min, add, min) against (4 K + 1) planes read
// and 2 K written; at K = 79 the operations are the larger bound.  Design: a
// block of 32 pixels x ceil(K / 8) warps; label planes are contiguous along
// pixels, so a warp reads 128 contiguous bytes of every plane.  Thread (x, y)
// owns the sources i = 8 y .. 8 y + 7 of pixel x: their P and H_A stay in
// registers with eight running minima of msgB.  The block stages the pixel
// tile's R and H_B columns in shared memory and every thread walks j over
// them in chunks of eight; per chunk a thread keeps its partial min over its
// own i of the eight msgA[j] in registers, and the block reduces those over
// threadIdx.y through shared memory (two buffers in turn, one barrier a
// chunk).  The ragged edges (N not a multiple of 32, K not of 8) are guarded
// by index: a source i >= K carries H_A = +inf and is never the minimum, a
// j >= K carries H_B = +inf.

#include "minplus.cuh"

namespace {

using namespace minplus;

constexpr int JT = 8;  // j's per chunk

template <int KERNEL>
__global__ void minplus_pair_kernel(const float* __restrict__ HA,     // [K,N]
                                    const float* __restrict__ HB,     // [K,N]
                                    const float* __restrict__ P,      // [K,N]
                                    const float* __restrict__ R,      // [K,N]
                                    const float* __restrict__ alpha,  // [N]
                                    float* __restrict__ msgA,         // [K,N]
                                    float* __restrict__ msgB,         // [K,N]
                                    float tol, int K, long long N) {
  // dynamic shared memory: R then H_B of the tile, [K][TILE] each, then the
  // partial minima of a chunk's msgA, [buffer][threadIdx.y][j in chunk][x]
  extern __shared__ float stage[];
  float* red = stage + 2 * K * TILE + threadIdx.x;
  const int red_y = JT * TILE, red_buf = blockDim.y * red_y;
  const long long n = (long long)blockIdx.x * TILE + threadIdx.x;
  const bool active = n < N;
  float* rS = stage + threadIdx.x;
  float* hbS = stage + K * TILE + threadIdx.x;
  const int i0 = threadIdx.y * KT;

  float p[KT], ha[KT], accB[KT];
  float a = 0.0f;
  if (active) {
    a = alpha[n];
    for (int j = threadIdx.y; j < K; j += blockDim.y) {
      rS[j * TILE] = R[j * N + n];
      hbS[j * TILE] = HB[j * N + n];
    }
  }
#pragma unroll
  for (int u = 0; u < KT; ++u) {
    const int i = i0 + u;
    const bool in = active && i < K;
    p[u] = in ? P[i * N + n] : 0.0f;
    ha[u] = in ? HA[i * N + n] : CUDART_INF_F;
    accB[u] = CUDART_INF_F;
  }
  __syncthreads();

  int buf = 0;
  for (int j0 = 0; j0 < K; j0 += JT, buf ^= 1) {
    float partA[JT];
#pragma unroll
    for (int v = 0; v < JT; ++v) {
      const bool in = active && j0 + v < K;
      const float r = in ? rS[(j0 + v) * TILE] : 0.0f;
      const float hb = in ? hbS[(j0 + v) * TILE] : CUDART_INF_F;
      float m = CUDART_INF_F;
#pragma unroll
      for (int u = 0; u < KT; ++u) {
        const float term = a * trunc_cost<KERNEL>(p[u], r, tol);
        accB[u] = fminf(accB[u], hb + term);
        m = fminf(m, ha[u] + term);
      }
      partA[v] = m;
    }
#pragma unroll
    for (int v = 0; v < JT; ++v)
      red[buf * red_buf + threadIdx.y * red_y + v * TILE] = partA[v];
    // one barrier a chunk: the next chunk writes the other buffer, and the
    // chunk after it comes behind the next barrier, by which every thread
    // has finished reading this one
    __syncthreads();
    for (int v = threadIdx.y; v < JT; v += blockDim.y) {
      if (active && j0 + v < K) {
        const float* col = red + buf * red_buf + v * TILE;
        float m = col[0];
        for (int y = 1; y < (int)blockDim.y; ++y) m = fminf(m, col[y * red_y]);
        msgA[(j0 + v) * N + n] = m;
      }
    }
  }
  if (active) {
#pragma unroll
    for (int u = 0; u < KT; ++u)
      if (i0 + u < K) msgB[(i0 + u) * N + n] = accB[u];
  }
}

}  // namespace

extern "C" int minplus_pair_f32(const float* HA, const float* HB,
                                const float* P, const float* R,
                                const float* alpha, float* msgA, float* msgB,
                                float tol, int kernel, int K, long long N,
                                void* stream) {
  dim3 block(TILE, target_blocks(K));
  dim3 grid((unsigned)((N + TILE - 1) / TILE));
  cudaStream_t st = (cudaStream_t)stream;
  size_t smem = stage_bytes(K) + 2 * (size_t)block.y * JT * TILE * sizeof(float);
  cudaError_t err = allow_stage(
      kernel == 1 ? (const void*)minplus_pair_kernel<1>
                  : (const void*)minplus_pair_kernel<2>, smem);
  if (err != cudaSuccess) return (int)err;
  if (kernel == 1)
    minplus_pair_kernel<1><<<grid, block, smem, st>>>(HA, HB, P, R, alpha,
                                                      msgA, msgB, tol, K, N);
  else
    minplus_pair_kernel<2><<<grid, block, smem, st>>>(HA, HB, P, R, alpha,
                                                      msgA, msgB, tol, K, N);
  return (int)cudaGetLastError();
}
