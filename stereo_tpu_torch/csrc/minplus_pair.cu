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
// block of 32 pixels x target_blocks(K) warps; label planes are contiguous
// along pixels, so a warp reads 128 contiguous bytes of every plane.  Thread
// (x, y) owns the sources i = 8 y .. 8 y + 7 of pixel x: their P and H_A stay
// in registers with eight running minima of msgB.  A block has at most 12
// warps (minplus.cuh); more than 96 labels take several passes over the
// sources, each pass walking every j again, and msgA[j] of a pass is the
// minimum of the pass's reduction and what the passes before wrote.  The
// block stages the pixel tile's R and H_B columns in shared memory and every
// thread walks j over them in chunks of eight; per chunk a thread keeps its
// partial min over its own i of the eight msgA[j] in registers, and the
// block reduces those over threadIdx.y through shared memory (two buffers in
// turn, one barrier a chunk).  The ragged edges (N not a multiple of 32, K
// not of 8) are guarded by index: a source i >= K carries H_A = +inf and is
// never the minimum, a j >= K carries H_B = +inf.  R and H_B are staged in
// global scratch when they do not fit shared memory (minplus.cuh::
// plan_stage; the grid is then the blocks resident at once, each walking a
// stride of tiles), so every K is taken.

#include "minplus.cuh"

namespace {

using namespace minplus;

constexpr int JT = 8;  // j's per chunk

template <int KERNEL, bool SMEM>
__global__ void minplus_pair_kernel(const float* __restrict__ HA,     // [K,N]
                                    const float* __restrict__ HB,     // [K,N]
                                    const float* __restrict__ P,      // [K,N]
                                    const float* __restrict__ R,      // [K,N]
                                    const float* __restrict__ alpha,  // [N]
                                    float* __restrict__ msgA,         // [K,N]
                                    float* __restrict__ msgB,         // [K,N]
                                    float tol, int K, long long N,
                                    float* gstage) {
  // dynamic shared memory: the partial minima of a chunk's msgA,
  // [buffer][threadIdx.y][j in chunk][x], then (SMEM) the staging area, R
  // then H_B of the tile, [K][TILE] each; else the staging area is the
  // block's slice of the global scratch
  extern __shared__ float dyn[];
  const int red_y = JT * TILE, red_buf = blockDim.y * red_y;
  float* red = dyn + threadIdx.x;
  float* stage = SMEM ? dyn + 2 * red_buf
                      : gstage + (long long)blockIdx.x * stage_floats(K);
  float* rS = stage + threadIdx.x;
  float* hbS = stage + K * TILE + threadIdx.x;
  const int npass = target_passes(K);
  int buf = 0;
  // one tile of 32 pixels a block in shared memory, a stride of them in
  // scratch (plan_stage bounds that grid).  A tile's staging writes follow
  // the previous tile's last chunk barrier, after which no thread reads the
  // staging area.
  for (long long tile = blockIdx.x; tile * TILE < N; tile += gridDim.x) {
    const long long n = tile * TILE + threadIdx.x;
    const bool active = n < N;

    float a = 0.0f;
    if (active) {
      a = alpha[n];
      for (int j = threadIdx.y; j < K; j += blockDim.y) {
        rS[j * TILE] = R[j * N + n];
        hbS[j * TILE] = HB[j * N + n];
      }
    }
    __syncthreads();

    // pass q gives thread y the sources
    // i = (q * blockDim.y + y) * KT + [0, KT)
    for (int q = 0; q < npass; ++q) {
      const int i0 = (q * blockDim.y + threadIdx.y) * KT;
      float p[KT], ha[KT], accB[KT];
#pragma unroll
      for (int u = 0; u < KT; ++u) {
        const int i = i0 + u;
        const bool in = active && i < K;
        p[u] = in ? P[i * N + n] : 0.0f;
        ha[u] = in ? HA[i * N + n] : CUDART_INF_F;
        accB[u] = CUDART_INF_F;
      }
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
        // one barrier a chunk: the next chunk writes the other buffer, and
        // the chunk after it comes behind the next barrier, by which every
        // thread has finished reading this one (the chunks of all passes and
        // tiles alternate)
        __syncthreads();
        for (int v = threadIdx.y; v < JT; v += blockDim.y) {
          if (active && j0 + v < K) {
            const float* col = red + buf * red_buf + v * TILE;
            float m = col[0];
            for (int y = 1; y < (int)blockDim.y; ++y)
              m = fminf(m, col[y * red_y]);
            // the minimum of the passes before, written by this same thread
            if (q > 0) m = fminf(msgA[(j0 + v) * N + n], m);
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
    if constexpr (SMEM) break;  // the grid covers the tiles: no loop
  }
}

template <int KERNEL>
cudaError_t launch(const float* HA, const float* HB, const float* P,
                   const float* R, const float* alpha, float* msgA,
                   float* msgB, float tol, int K, long long N, float* scratch,
                   long long scratch_floats, long long* need,
                   cudaStream_t st) {
  dim3 block(TILE, target_blocks(K));
  const size_t red = 2 * (size_t)block.y * JT * TILE * sizeof(float);
  StagePlan plan;
  cudaError_t err = plan_stage(
      (const void*)minplus_pair_kernel<KERNEL, true>,
      (const void*)minplus_pair_kernel<KERNEL, false>, red, K,
      block.x * block.y, (N + TILE - 1) / TILE, false, &plan);
  if (err != cudaSuccess || scratch_short(plan, scratch_floats, need))
    return err;
  if (plan.scratch == 0)
    minplus_pair_kernel<KERNEL, true><<<plan.grid, block, plan.dyn, st>>>(
        HA, HB, P, R, alpha, msgA, msgB, tol, K, N, nullptr);
  else
    minplus_pair_kernel<KERNEL, false><<<plan.grid, block, plan.dyn, st>>>(
        HA, HB, P, R, alpha, msgA, msgB, tol, K, N, scratch);
  return cudaGetLastError();
}

}  // namespace

// scratch, scratch_floats, need: the staging hand-shake of
// minplus.cuh::scratch_short.  Returns 0 or the CUDA error code.
extern "C" int minplus_pair_f32(const float* HA, const float* HB,
                                const float* P, const float* R,
                                const float* alpha, float* msgA, float* msgB,
                                float tol, int kernel, int K, long long N,
                                float* scratch, long long scratch_floats,
                                long long* need, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(kernel == 1
                   ? launch<1>(HA, HB, P, R, alpha, msgA, msgB, tol, K, N,
                               scratch, scratch_floats, need, st)
                   : launch<2>(HA, HB, P, R, alpha, msgA, msgB, tol, K, N,
                               scratch, scratch_floats, need, st));
}
