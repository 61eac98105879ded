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
// cooperative send (minplus.cuh): a block of 32 x target_blocks(K) threads
// (at most 12 warps; more than 96 labels take several passes over the
// targets) per tile of 32 lanes, the sources staged in shared memory (in
// global scratch when K is too large for it), the whole leading batch in one
// launch.  It takes every K.

#include "minplus.cuh"

namespace {

using namespace minplus;

template <int KERNEL, bool SMEM>
__global__ void minplus_send_kernel(const float* __restrict__ hs,     // [B,K,L]
                                    const float* __restrict__ p,      // [B,K,L]
                                    const float* __restrict__ r,      // [B,K,L]
                                    const float* __restrict__ alpha,  // [B,L]
                                    float* __restrict__ msg,          // [B,K,L]
                                    float* __restrict__ vmin,         // [B,L]
                                    float tol, int B, int K, int L,
                                    float* gstage) {
  __shared__ float sm[MAX_TB][TILE];
  extern __shared__ float smem_stage[];
  float* stage = SMEM ? smem_stage
                      : gstage + (long long)blockIdx.x * stage_floats(K);
  // job = (batch entry, tile of 32 lanes); one job a block in shared memory,
  // a stride of them in scratch (plan_stage bounds that grid)
  const int per_b = (L + TILE - 1) / TILE;
  for (long long job = blockIdx.x; job < (long long)B * per_b;
       job += gridDim.x) {
    const long long b = job / per_b;
    const int l = (int)(job % per_b) * TILE + threadIdx.x;
    const bool active = l < L;
    const long long bk = b * K * L + l;  // into a [B, K, L] array
    const long long bl = b * L + l;      // into a [B, L] array
    const float a = active ? alpha[bl] : 0.0f;
    const float v = send_lane<KERNEL, false, SMEM>(
        active, active, hs + bk, L, nullptr, 0, p + bk, L, r + bk, L, a, tol,
        K, msg + bk, L, sm, stage);
    if (active && threadIdx.y == 0) vmin[bl] = v;
    if constexpr (SMEM) break;  // the grid covers the jobs: no loop
  }
}

template <int KERNEL>
cudaError_t launch(const float* hs, const float* p, const float* r,
                   const float* alpha, float* msg, float* vmin, float tol,
                   int B, int K, int L, float* scratch,
                   long long scratch_floats, long long* need,
                   cudaStream_t st) {
  dim3 block(TILE, target_blocks(K));
  StagePlan plan;
  cudaError_t err = plan_stage(
      (const void*)minplus_send_kernel<KERNEL, true>,
      (const void*)minplus_send_kernel<KERNEL, false>, 0, K,
      block.x * block.y, (long long)B * ((L + TILE - 1) / TILE), false,
      &plan);
  if (err != cudaSuccess || scratch_short(plan, scratch_floats, need))
    return err;
  if (plan.scratch == 0)
    minplus_send_kernel<KERNEL, true><<<plan.grid, block, plan.dyn, st>>>(
        hs, p, r, alpha, msg, vmin, tol, B, K, L, nullptr);
  else
    minplus_send_kernel<KERNEL, false><<<plan.grid, block, plan.dyn, st>>>(
        hs, p, r, alpha, msg, vmin, tol, B, K, L, scratch);
  return cudaGetLastError();
}

}  // namespace

// scratch, scratch_floats, need: the staging hand-shake of
// minplus.cuh::scratch_short.  Returns 0 or the CUDA error code.
extern "C" int minplus_send_f32(const float* hs, const float* p,
                                const float* r, const float* alpha,
                                float* msg, float* vmin, float tol,
                                int kernel, int B, int K, int L,
                                float* scratch, long long scratch_floats,
                                long long* need, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(kernel == 1
                   ? launch<1>(hs, p, r, alpha, msg, vmin, tol, B, K, L,
                               scratch, scratch_floats, need, st)
                   : launch<2>(hs, p, r, alpha, msg, vmin, tol, B, K, L,
                               scratch, scratch_floats, need, st));
}
