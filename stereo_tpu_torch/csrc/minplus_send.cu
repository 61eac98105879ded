// The column send of the wavefront family of TRW-S schedules for NVIDIA
// Hopper (sm_90a), float32.  Replaces the TPU kernel
// stereo_tpu/ops/minplus.py::_send_kernel.
//
// For every batch entry b and lane l:
//
//   msg[b][t][l] = min_s ( hs[b][s][l] + alpha[b][l] * TR(p[b][t][l] - r[b][s][l]) )
//
// minus vmin[b][l], its minimum over t; vmin is returned too.
//
// Plain C interface (loaded with ctypes): raw device pointers and a CUDA
// stream; launches on that stream without synchronising, allocates nothing,
// returns cudaGetLastError().  Built with -fmad=false (ops/_build.py), so
// the result equals the plain PyTorch version's bit for bit.
//
// What bounds it: K^2 min-plus steps of six float32 instructions per lane
// against (4 K + 2) planes of traffic; at the sizes a sweep step gives it
// (a few [K, L] columns with L ~ 1500) both bounds are under a microsecond
// and the launch latency is what one measures.  The design is the shared
// cooperative send (minplus.cuh): a block of 32 x ceil(K / 8) threads per
// tile of 32 lanes, the sources staged in shared memory, the whole leading
// batch in one launch (blockIdx.y).

#include "minplus.cuh"

namespace {

using namespace minplus;

template <int KERNEL>
__global__ void minplus_send_kernel(const float* __restrict__ hs,     // [B,K,L]
                                    const float* __restrict__ p,      // [B,K,L]
                                    const float* __restrict__ r,      // [B,K,L]
                                    const float* __restrict__ alpha,  // [B,L]
                                    float* __restrict__ msg,          // [B,K,L]
                                    float* __restrict__ vmin,         // [B,L]
                                    float tol, int K, int L) {
  __shared__ float sm[MAX_TB][TILE];
  extern __shared__ float stage[];
  int l = blockIdx.x * TILE + threadIdx.x;
  bool active = l < L;
  long long bk = (long long)blockIdx.y * K * L + l;  // into a [B, K, L] array
  long long bl = (long long)blockIdx.y * L + l;      // into a [B, L] array
  float a = active ? alpha[bl] : 0.0f;
  float v = send_lane<KERNEL, false>(active, hs + bk, L, nullptr, 0, p + bk,
                                     L, r + bk, L, a, tol, K, msg + bk, L,
                                     sm, stage);
  if (active && threadIdx.y == 0) vmin[bl] = v;
}

}  // namespace

extern "C" int minplus_send_f32(const float* hs, const float* p,
                                const float* r, const float* alpha,
                                float* msg, float* vmin, float tol,
                                int kernel, int B, int K, int L,
                                void* stream) {
  dim3 block(TILE, target_blocks(K));
  dim3 grid((L + TILE - 1) / TILE, B);
  cudaStream_t st = (cudaStream_t)stream;
  size_t smem = stage_bytes(K);
  cudaError_t err = allow_stage(
      kernel == 1 ? (const void*)minplus_send_kernel<1>
                  : (const void*)minplus_send_kernel<2>, smem);
  if (err != cudaSuccess) return (int)err;
  if (kernel == 1)
    minplus_send_kernel<1><<<grid, block, smem, st>>>(hs, p, r, alpha, msg,
                                                      vmin, tol, K, L);
  else
    minplus_send_kernel<2><<<grid, block, smem, st>>>(hs, p, r, alpha, msg,
                                                      vmin, tol, K, L);
  return (int)cudaGetLastError();
}
