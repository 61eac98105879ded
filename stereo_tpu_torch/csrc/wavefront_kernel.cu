// One whole raster-order (anti-diagonal wavefront) TRW-S sweep in one launch,
// for NVIDIA Hopper (sm_90a), float32.  Replaces the TPU kernel
// stereo_tpu/ops/wavefront_kernel.py::_kernel (sweep_pallas).
//
// What it computes: solvers/wavefront.py::_fwd_col for steps t = 0 .. T-1,
// then _bwd_col for t = T-1 .. 0, in place on the message groups (MA, MB),
// and the sweep's lower bound.  T = H + W - 1; step t works on the padded
// column c = t + 1 of the skewed, t-leading arrays, whose lane y holds pixel
// (y, t - y).
//
// Plain C interface (loaded with ctypes): raw device pointers and a CUDA
// stream; one cooperative launch on that stream, no synchronisation, no
// allocation (the wrapper hands in the scratch); returns the CUDA error code
// of the launch.  Built with -fmad=false (ops/_build.py): the messages equal
// the plain PyTorch version's bit for bit.  The lower bound is accumulated
// per lane in double and reduced at the end, so it agrees with the plain
// version's float32 sums to their rounding only.
//
// Design.  The problem's skewed column arrays are read where they lie; a
// shift of the plain version (the up neighbour is lane y - 1 of the previous
// column, the down neighbour lane y + 1 of the next) is index arithmetic
// with the guard before the load.  A step has two phases with a grid-wide
// barrier after each (4 T barriers a sweep): phase A forms the node beliefs
// of column c from the eight incident buffers and writes gamma * belief
// (backward: minus its minimum, which goes to the bound) to the scratch
// column gD; phase B does the four sends of the step: two head-sends at
// column c, each reading gD and the old message of its own lane, and two
// tail-sends into column c + 1 (forward) or c - 1 (backward), reading gD of
// lane y and of lane y - 1 (forward) or y + 1 (backward).  The tail-sends of
// step c write the column that the next step's beliefs read: the second
// barrier orders them.  The barrier is cooperative_groups' grid.sync(): the
// kernel is persistent, launched with cudaLaunchCooperativeKernel on a grid no
// larger than what is resident at once (a larger grid is refused by the
// launch, it cannot deadlock), and its blocks stride over the step's jobs.
//
// A job is one send for a tile of 32 neighbouring lanes, done by a block of
// 32 x target_blocks(K) threads (minplus.cuh::send_lane; at most 12 warps,
// more than 96 labels in several passes, so every K is taken).  Only lanes
// that hold a pixel at a step are visited: y in [max(0, t - W + 1),
// min(H - 1, t)].  Every other lane of a column is padding whose masks are
// zero and whose messages stay zero, so skipping it changes nothing.
//
// What bounds it: per sweep 8 sends x K^2 x 6 float32 instructions per pixel
// against every live problem and message entry moved once per pass; at teddy
// K = 79 the operations are the larger bound.  What one measures on top is
// the 4 T barriers and the thin parallelism of a step (at most
// 4 x ceil(min(H, W) / 32) jobs for 132 SMs); PERF.md has the numbers.

#include <cooperative_groups.h>

#include "minplus.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace minplus;

constexpr int LB_SLOTS = 5;  // node term + the 4 sends of a backward step

struct Params {
  // problem columns: theta, D0 [T+2, K, H]; QA, QB [T+2, 2, K, H];
  // aA, aB, vA, vB [T+2, 2, H]; gamma [T+2, H]
  const float *theta, *D0, *QA, *QB, *aA, *aB, *vA, *vB, *gamma;
  float *MA, *MB;  // state, updated in place: [T+2, 2, K, H]
  float* gD;       // scratch [K, H]
  double* lbacc;   // scratch [LB_SLOTS, H]
  double* lb;      // out [1]
  float* gstage;   // scratch: grid x stage_floats(K), or null (plan_stage)
  float tol;
  int K, H, W, T;
};

// order of the pointer array handed to wavefront_sweep_f32
// (ops/wavefront_kernel.py builds it in this order)
enum Ptr {
  P_THETA, P_D0, P_QA, P_QB, P_AA, P_AB, P_VA, P_VB, P_GAMMA,
  P_MA, P_MB, P_GD, P_LBACC, P_LB, P_COUNT
};

__host__ __device__ inline int tiles(int n) { return (n + TILE - 1) / TILE; }

// Lanes of step s's column that hold pixels: [lo, hi); empty outside 0..T-1.
__device__ __forceinline__ void live_range(const Params& P, int s, int& lo,
                                           int& hi) {
  if (s < 0 || s >= P.T) {
    lo = hi = 0;
    return;
  }
  lo = max(0, s - P.W + 1);
  hi = min(P.H - 1, s) + 1;
}

// Phase A of step t: beliefs of column c = t + 1 -> gD (and, backward, the
// node term of the bound).  The additions follow
// solvers/wavefront.py::_beliefs_col term by term.  Thread y sums the labels
// k = (p KT + j) blockDim.y + y, j < KT, in passes p; backward, the sums of
// the passes before the last wait in gD for the step's minimum.
template <bool BACKWARD>
__device__ void beliefs_step(const Params& P, int t, float (*sm)[TILE]) {
  const int K = P.K, H = P.H, c = t + 1, ny = blockDim.y;
  const int npass = target_passes(K);
  const long long KH = (long long)K * H;
  int lo, hi;
  live_range(P, t, lo, hi);
  const int ntiles = tiles(hi - lo);
  const float* th = P.theta + c * KH;
  const float* A0 = P.MA + 2LL * c * KH;
  const float* A1 = A0 + KH;
  const float* B0 = P.MB + 2LL * c * KH;
  const float* B1 = B0 + KH;
  const float* Am0 = P.MA + 2LL * (c - 1) * KH;
  const float* Am1 = Am0 + KH;
  const float* Bp0 = P.MB + 2LL * (c + 1) * KH;
  const float* Bp1 = Bp0 + KH;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int l = lo + tile * TILE + threadIdx.x;
    const bool active = l < hi;
    float D[KT];
    float part = CUDART_INF_F;
    float gam = 0.0f;
    if (active) {
      gam = P.gamma[(long long)c * H + l];
      const bool up_in = l >= 1, dn_in = l + 1 < H;
      for (int p = 0; p < npass; ++p) {
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          const int k = (p * KT + j) * ny + threadIdx.y;
          if (k < K) {
            const long long o = (long long)k * H + l;
            float d = th[o] + A0[o];
            d = d + A1[o];
            d = d + B0[o];
            d = d + B1[o];
            d = d + Am0[o];
            d = d + (up_in ? Am1[o - 1] : 0.0f);
            d = d + Bp0[o];
            d = d + (dn_in ? Bp1[o + 1] : 0.0f);
            D[j] = d;
            part = fminf(part, d);
            if (!BACKWARD)
              P.gD[o] = gam * d;
            else if (p + 1 < npass)
              P.gD[o] = d;  // corrected below
          }
        }
      }
    }
    if (BACKWARD) {
      const float vmin = block_min_over_y(part, sm);
      // every live lane holds a pixel: the plain version's pix mask is 1
      if (active && threadIdx.y == 0) P.lbacc[l] += (double)vmin;
      if (active) {
        for (int p = 0; p < npass; ++p) {
#pragma unroll
          for (int j = 0; j < KT; ++j) {
            const int k = (p * KT + j) * ny + threadIdx.y;
            if (k < K) {
              float* o = P.gD + (long long)k * H + l;
              *o = gam * ((p + 1 < npass ? *o : D[j]) - vmin);
            }
          }
        }
      }
    }
  }
}

// Phase B of step t: the four sends.  Heads are the group the pass writes at
// column c (forward: A = (RT, DN); backward: B = (LT, UP)); tails are the
// other group, written into column cn = c + 1 (forward) or c - 1 (backward).
template <int KERNEL, bool BACKWARD, bool SMEM>
__device__ void sends_step(const Params& P, int t, float (*sm)[TILE],
                           float* stage) {
  const int K = P.K, H = P.H, c = t + 1;
  const int cn = BACKWARD ? c - 1 : c + 1;
  const long long KH = (long long)K * H;
  float* Mh = BACKWARD ? P.MB : P.MA;
  const float* Qh = BACKWARD ? P.QB : P.QA;
  const float* ah = BACKWARD ? P.aB : P.aA;
  const float* vh = BACKWARD ? P.vB : P.vA;
  float* Mt = BACKWARD ? P.MA : P.MB;
  const float* Qt = BACKWARD ? P.QA : P.QB;
  const float* at = BACKWARD ? P.aA : P.aB;
  const float* vt = BACKWARD ? P.vA : P.vB;

  int hlo, hhi, tlo, thi;
  live_range(P, t, hlo, hhi);
  live_range(P, BACKWARD ? t - 1 : t + 1, tlo, thi);
  const int n_h = tiles(hhi - hlo), n_t = tiles(thi - tlo);
  const int njobs = 2 * (n_h + n_t);

  for (int job = blockIdx.x; job < njobs; job += gridDim.x) {
    const bool head = job < 2 * n_h;
    const int rest = head ? job : job - 2 * n_h;
    const int n_seg = head ? n_h : n_t;
    const int d = rest / n_seg;  // direction within the group
    const int i = (rest - d * n_seg) * TILE + threadIdx.x;

    bool in = false, active = false;
    const float *g = nullptr, *xt = nullptr, *ys = nullptr;
    float* m = nullptr;
    float a = 0.0f;
    int l = 0;
    if (head) {
      // head-send, direction d of the heads' group, at column c
      l = hlo + i;
      if (l < hhi) {
        in = true;
        active = vh[(2LL * c + d) * H + l] > 0.0f;
        const long long o = (2LL * c + d) * KH + l;
        g = P.gD + l;
        m = Mh + o;
        xt = Qh + o;
        ys = P.D0 + c * KH + l;
        a = ah[(2LL * c + d) * H + l];
      }
    } else {
      // tail-send, direction d of the tails' group, into column cn; d = 0
      // takes the source at the same lane, d = 1 at the vertical neighbour
      // (forward: l - 1, backward: l + 1)
      l = tlo + i;
      const int ls = d == 0 ? l : (BACKWARD ? l + 1 : l - 1);
      if (l < thi && ls >= 0 && ls < H) {
        in = true;
        active = vt[(2LL * cn + d) * H + l] > 0.0f;
        const long long o = (2LL * cn + d) * KH + l;
        g = P.gD + ls;
        m = Mt + o;
        xt = P.D0 + cn * KH + l;
        ys = Qt + o;
        a = at[(2LL * cn + d) * H + l];
      }
    }
    const float vmin = send_lane<KERNEL, true, SMEM>(in, active, g, H, m, H,
                                                     xt, H, ys, H, a, P.tol,
                                                     K, m, H, sm, stage);
    if (BACKWARD && active && threadIdx.y == 0)
      P.lbacc[(1 + (head ? 0 : 2) + d) * (long long)H + l] += (double)vmin;
  }
}

template <int KERNEL, bool SMEM>
__global__ void __launch_bounds__(TILE * MAX_TB)
    wavefront_sweep_kernel(const Params P) {
  __shared__ float sm[MAX_TB][TILE];
  __shared__ double red[MAX_TB * TILE];
  extern __shared__ float smem_stage[];
  float* stage = SMEM ? smem_stage
                      : P.gstage + (long long)blockIdx.x * stage_floats(P.K);
  cg::grid_group grid = cg::this_grid();
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  // the bound's accumulators are first used after the forward pass
  for (long long i = (long long)blockIdx.x * nthreads + tid;
       i < (long long)LB_SLOTS * P.H; i += (long long)gridDim.x * nthreads)
    P.lbacc[i] = 0.0;

  for (int t = 0; t < P.T; ++t) {
    beliefs_step<false>(P, t, sm);
    grid.sync();
    sends_step<KERNEL, false, SMEM>(P, t, sm, stage);
    grid.sync();
  }
  for (int t = P.T - 1; t >= 0; --t) {
    beliefs_step<true>(P, t, sm);
    grid.sync();
    sends_step<KERNEL, true, SMEM>(P, t, sm, stage);
    grid.sync();
  }

  // the sweep's lower bound: one block sums the accumulators, in a fixed
  // order (the same bits from run to run)
  if (blockIdx.x == 0) {
    double s = 0.0;
    for (int i = tid; i < LB_SLOTS * P.H; i += nthreads) s += P.lbacc[i];
    red[tid] = s;
    __syncthreads();
    if (tid == 0) {
      double total = 0.0;
      for (int i = 0; i < nthreads; ++i) total += red[i];
      *P.lb = total;
    }
  }
}

template <int KERNEL>
cudaError_t launch(Params P, float* scratch, long long scratch_floats,
                   long long* need, cudaStream_t st) {
  dim3 block(TILE, target_blocks(P.K));
  // no more blocks than the widest step has jobs, and no more than are
  // resident at once (the cooperative launch refuses a larger grid)
  const int widest = P.H < P.W ? P.H : P.W;
  StagePlan plan;
  cudaError_t err = plan_stage(
      (const void*)wavefront_sweep_kernel<KERNEL, true>,
      (const void*)wavefront_sweep_kernel<KERNEL, false>, 0, P.K,
      block.x * block.y, 4 * tiles(widest), true, &plan);
  if (err != cudaSuccess || scratch_short(plan, scratch_floats, need))
    return err;
  P.gstage = scratch;
  void* args[] = {(void*)&P};
  err = cudaLaunchCooperativeKernel(plan.fn, dim3(plan.grid), block, args,
                                    plan.dyn, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// ptrs: P_COUNT device pointers in the order of enum Ptr (a host array);
// dims: {K, H, W}; scratch, scratch_floats, need: the staging hand-shake of
// minplus.cuh::scratch_short.  Returns 0 or the CUDA error code.
extern "C" int wavefront_sweep_f32(const void* const* ptrs, const int* dims,
                                   float tol, int kernel, float* scratch,
                                   long long scratch_floats, long long* need,
                                   void* stream) {
  Params P;
#define FP(i) ((const float*)ptrs[i])
  P.theta = FP(P_THETA); P.D0 = FP(P_D0); P.QA = FP(P_QA); P.QB = FP(P_QB);
  P.aA = FP(P_AA); P.aB = FP(P_AB); P.vA = FP(P_VA); P.vB = FP(P_VB);
  P.gamma = FP(P_GAMMA);
#undef FP
  P.MA = (float*)ptrs[P_MA]; P.MB = (float*)ptrs[P_MB];
  P.gD = (float*)ptrs[P_GD];
  P.lbacc = (double*)ptrs[P_LBACC]; P.lb = (double*)ptrs[P_LB];
  P.tol = tol;
  P.K = dims[0]; P.H = dims[1]; P.W = dims[2];
  P.T = P.H + P.W - 1;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(kernel == 1
                   ? launch<1>(P, scratch, scratch_floats, need, st)
                   : launch<2>(P, scratch, scratch_floats, need, st));
}
