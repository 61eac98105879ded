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
// with the guard before the load.  A step has two phases: phase A forms the
// node beliefs of column c from the eight incident buffers and writes
// gamma * belief (backward: minus its minimum, which goes to the bound) to
// the scratch column gD, one tile of 32 lanes at a time; phase B does the
// four sends of the step: two head-sends at column c, each reading gD and
// the old message of its own lane, and two tail-sends into column c + 1
// (forward) or c - 1 (backward), reading gD of lane y and of lane y - 1
// (forward) or y + 1 (backward).  The kernel is persistent, launched with
// cudaLaunchCooperativeKernel on a grid no larger than what is resident at
// once (a larger grid is refused by the launch, it cannot hang), and its
// blocks stride over a phase's tiles and jobs.
//
// A job of phase B is one send for J neighbouring lanes, J in {32, 16, 8},
// done by the whole block of 32 x target_blocks(K) threads
// (minplus.cuh::send_job: J lanes x 32 blockDim.y / J slices of the
// targets; at most 12 warps, more than 96 labels in several passes, so
// every K is taken), with the truncation taken out of the K^2 walk for
// a >= 0.  Each step takes the width whose jobs the resident grid runs
// soonest (minplus.cuh::job_width): a step of this schedule has at most
// 4 x ceil(min(H, W) / 32) jobs 32 lanes wide, 48 at teddy, so narrower
// jobs reach the SMs those leave idle.  Only lanes that hold a pixel at a
// step are visited: y in [max(0, t - W + 1), min(H - 1, t)].  Every other
// lane of a column is padding whose masks are zero and whose messages stay
// zero, so skipping it changes nothing.
//
// What bounds it: per sweep 8 sends x K^2 x 6 float32 instructions per pixel
// against every live problem and message entry moved once per pass; at teddy
// K = 79 the operations are the larger bound, 0.755 ms (the issue floor of
// four instructions a term, 1.0 ms).  What one measures on top (PERF.md) is
// a fixed cost of every one of the 2 T steps -- grid barriers over the
// resident blocks and chains of dependent global round trips -- and the
// thin parallelism of a step, which the narrow jobs spread over the card.
// What the design does about the fixed cost, as csrc/banded_kernel.cu does
// (kernel 6 is kernel 5 without seams):
//   - one grid.sync() a step, after phase B: the tail-sends of step t write
//     the column that step t + 1's beliefs read, and step t + 1's beliefs
//     overwrite the gD that step t's sends read.  Within a step, phase B
//     waits for phase A through per-tile ready flags: the tile's block
//     publishes the step's epoch with a release store, and a job acquires
//     the flags of the tiles it needs (sends_width states the rule) -- but
//     not of a tile its own block wrote in this step's phase A: the
//     __syncthreads() that ends belief_tile already ordered that one, and
//     the blocks that run phase A are the last to reach phase B;
//   - no load waits for another load: phase A issues the nine loads of a
//     target at once, and a phase-B job issues its problem loads (validity,
//     weight, the staging of the source positions by cp.async, its targets)
//     and reads the bound's accumulators before it waits for its flags, so
//     after the wait one global round trip is left (gD and its own
//     message).  (Measured, PERF.md: the loads before the wait were slower
//     until the rule above took the acquire out of the path of the blocks
//     that run phase A; relaxed polls and one acquire fence were no
//     faster.)
// No deadlock: a block runs all its phase-A tiles of a step before its
// first phase-B job, phase A never waits, and every block is resident (the
// cooperative launch refuses a grid that is not), so every flag a job waits
// for gets published.
// The arithmetic, and the order of every sum, are the plain version's: the
// messages stay bit for bit.

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
  int* flags;      // scratch [ceil(H / 32)]: phase A's per-tile ready flags
  double* lb;      // out [1]
  float* gstage;   // scratch: grid x stage_floats(K), or null (plan_stage)
  float tol;
  int width;  // phase B's job width, or 0: chosen a step (sends_step)
  int K, H, W, T;
};

// order of the pointer array handed to wavefront_sweep_f32
// (ops/wavefront_kernel.py builds it in this order)
enum Ptr {
  P_THETA, P_D0, P_QA, P_QB, P_AA, P_AB, P_VA, P_VB, P_GAMMA,
  P_MA, P_MB, P_GD, P_LBACC, P_FLAGS, P_LB, P_COUNT
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

// Phase A of step t for one tile of 32 lanes: beliefs of column c = t + 1
// -> gD (and, backward, the node term of the bound), then the tile's ready
// flag.  The additions follow solvers/wavefront.py::_beliefs_col term by
// term.  Thread y sums the labels k = (p KT + j) blockDim.y + y, j < KT, in
// passes p; backward, the sums of the passes before the last wait in gD for
// the step's minimum.
template <bool BACKWARD>
__device__ void belief_tile(const Params& P, int t, int tile,
                            float (*sm)[TILE], int epoch) {
  const int K = P.K, H = P.H, c = t + 1, ny = blockDim.y;
  const int npass = target_passes(K);
  const long long KH = (long long)K * H;
  int lo, hi;
  live_range(P, t, lo, hi);
  const float* th = P.theta + c * KH;
  const float* A0 = P.MA + 2LL * c * KH;
  const float* A1 = A0 + KH;
  const float* B0 = P.MB + 2LL * c * KH;
  const float* B1 = B0 + KH;
  const float* Am0 = P.MA + 2LL * (c - 1) * KH;
  const float* Am1 = Am0 + KH;
  const float* Bp0 = P.MB + 2LL * (c + 1) * KH;
  const float* Bp1 = Bp0 + KH;
  const int l = lo + tile * TILE + threadIdx.x;
  const bool active = l < hi;
  float D[KT];
  float part = CUDART_INF_F;
  float gam = 0.0f;
  double lb_old = 0.0;
  if (active) {
    if (BACKWARD && threadIdx.y == 0) lb_old = P.lbacc[l];
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
    if (active && threadIdx.y == 0) P.lbacc[l] = lb_old + (double)vmin;
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
  // the tile is ready: the barrier orders every thread's gD writes (and
  // message reads) before thread 0's release of the flag
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0)
    store_release(P.flags + tile, epoch);
}

// Phase A of step t: every tile of the step's live lanes that falls to this
// block.  It never waits on another block.
template <bool BACKWARD>
__device__ void beliefs_step(const Params& P, int t, float (*sm)[TILE],
                             int epoch) {
  int lo, hi;
  live_range(P, t, lo, hi);
  const int ntiles = tiles(hi - lo);
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x)
    belief_tile<BACKWARD>(P, t, tile, sm, epoch);
}

// Jobs of width J of step t's phase B: 2 ceil((hhi - hlo) / J) head-sends
// (the step's live lanes) and 2 ceil((thi - tlo) / J) tail-sends (those of
// the step they write into).  ops/wavefront_kernel.py::step_jobs is the same
// enumeration.
__device__ __forceinline__ int step_jobs(int hlo, int hhi, int tlo, int thi,
                                         int J) {
  return 2 * ((hhi - hlo + J - 1) / J) + 2 * ((thi - tlo + J - 1) / J);
}

// Phase B of step t at job width J: the four sends, one job a send for J
// lanes.  Heads are the group the pass writes at column c (forward: A =
// (RT, DN); backward: B = (LT, UP)); tails are the other group, written
// into column cn = c + 1 (forward) or c - 1 (backward).
//
// A job waits for the phase-A tiles (of TILE lanes) of the step that cover
// the lanes of this rule (ops/wavefront_kernel.py::wait_lanes is the same
// rule, and tests/test_torch_wavefront.py checks it against the plain
// version's index maps at every width), l0 the first lane of the job:
//   head-sends    [l0, l0 + J)        gD read at its own lane; the message
//                                     written at lane l is read by phase A
//                                     at lane l
//   tail-sends    forward  [l0 - 1, l0 + J)
//                 backward [l0, l0 + J + 1)
//                                     gD at l and l -/+ 1; the message
//                                     written at lane l is read by phase A
//                                     at lane l (d = 0) and l -/+ 1 (d = 1:
//                                     Bp1[o + 1], Am1[o - 1] in belief_tile)
// clipped to the step's live lanes.  So phase B reads gD only once it is
// written, and overwrites a message only once phase A has read it.
template <int KERNEL, bool BACKWARD, bool SMEM, int J>
__device__ void sends_width(const Params& P, int t, int hlo, int hhi,
                            int tlo, int thi, float2 (*sm)[TILE],
                            float* stage, int epoch) {
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
  const int n_h = (hhi - hlo + J - 1) / J, n_t = (thi - tlo + J - 1) / J;
  const int njobs = 2 * (n_h + n_t);

  for (int job = blockIdx.x; job < njobs; job += gridDim.x) {
    const bool head = job < 2 * n_h;
    const int rest = head ? job : job - 2 * n_h;
    const int n_seg = head ? n_h : n_t;
    const int d = rest / n_seg;  // direction within the group
    const int tile = rest - d * n_seg;
    const int l0 = (head ? hlo : tlo) + tile * J;
    const int l = l0 + job_lane<J>();
    // the phase-A tiles of the step that this job waits for (see above);
    // a tile that this block wrote itself needs no flag: the
    // __syncthreads() that ends belief_tile ordered it before the job
    const int wlo = max(head || BACKWARD ? l0 : l0 - 1, hlo);
    const int whi = min(head || !BACKWARD ? l0 + J : l0 + J + 1, hhi);
    const int first = (wlo - hlo) / TILE;
    int last = wlo < whi ? (whi - 1 - hlo) / TILE : -1;
    bool own = true;
    for (int j = first; j <= last; ++j)
      own = own && j % (int)gridDim.x == (int)blockIdx.x;
    if (own) last = -1;
    const TileWait wait{P.flags, first, last, epoch};

    bool in = false, active = false;
    const float *g = nullptr, *xt = nullptr, *ys = nullptr;
    float* m = nullptr;
    float a = 0.0f;
    if (head) {
      // head-send, direction d of the heads' group, at column c
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
    // the bound's slot was last written by an earlier step: read it now
    // (one thread a lane)
    double* lb_slot = P.lbacc + (1 + (head ? 0 : 2) + d) * (long long)H + l;
    const bool lead = job_lead<J>();
    const double lb_old = BACKWARD && in && lead ? __ldcg(lb_slot) : 0.0;
    const float vmin = send_job<KERNEL, SMEM, J>(
        in, active, g, H, m, H, xt, H, ys, H, a, P.tol, K, m, H, sm, stage,
        wait);
    if (BACKWARD && active && lead) *lb_slot = lb_old + (double)vmin;
  }
}

// Phase B of step t: its job width (P.width, or job_width's choice from the
// step's jobs at each width and the resident grid; the same in every block),
// then its jobs.
template <int KERNEL, bool BACKWARD, bool SMEM>
__device__ void sends_step(const Params& P, int t, float2 (*sm)[TILE],
                           float* stage, int epoch) {
  int hlo, hhi, tlo, thi;
  live_range(P, t, hlo, hhi);
  live_range(P, BACKWARD ? t - 1 : t + 1, tlo, thi);
  int J = P.width;
  if (J == 0) {
    int jobs[N_WIDTHS];
    for (int w = 0; w < N_WIDTHS; ++w)
      jobs[w] = step_jobs(hlo, hhi, tlo, thi, TILE >> w);
    J = job_width(jobs, gridDim.x, P.K, target_passes(P.K), blockDim.y);
  }
  if (J == TILE)
    sends_width<KERNEL, BACKWARD, SMEM, TILE>(P, t, hlo, hhi, tlo, thi, sm,
                                              stage, epoch);
  else if (J == TILE / 2)
    sends_width<KERNEL, BACKWARD, SMEM, TILE / 2>(P, t, hlo, hhi, tlo, thi,
                                                  sm, stage, epoch);
  else
    sends_width<KERNEL, BACKWARD, SMEM, MIN_JOB>(P, t, hlo, hhi, tlo, thi, sm,
                                                 stage, epoch);
}

// __launch_bounds__: ptxas then takes 80 registers (and spills ~88 bytes);
// without it 96-128, and the sweep runs slower (PERF.md)
template <int KERNEL, bool SMEM>
__global__ void __launch_bounds__(TILE * MAX_TB)
    wavefront_sweep_kernel(const Params P) {
  __shared__ float sm[MAX_TB][TILE];
  __shared__ double red[MAX_TB * TILE];
  // phase B's reductions share `red`, which only the bound's sum uses
  float2(*sm2)[TILE] = reinterpret_cast<float2(*)[TILE]>(red);
  extern __shared__ float smem_stage[];
  float* stage = SMEM ? smem_stage
                      : P.gstage + (long long)blockIdx.x * stage_floats(P.K);
  cg::grid_group grid = cg::this_grid();
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const long long gtid = (long long)blockIdx.x * nthreads + tid;
  const long long gthreads = (long long)gridDim.x * nthreads;
  // the bound's accumulators and the ready flags start at zero; a flag
  // holds the epoch of the step whose beliefs its tile last published:
  // forward step t 1 + t, backward step t 2 T - t, increasing through the
  // launch, so no flag is reset between steps
  for (long long i = gtid; i < (long long)LB_SLOTS * P.H; i += gthreads)
    P.lbacc[i] = 0.0;
  for (long long i = gtid; i < tiles(P.H); i += gthreads) P.flags[i] = 0;
  grid.sync();

  // one grid.sync a step: it orders the step's sends (which write the
  // messages that the next step's beliefs read, and read the gD that they
  // overwrite) before the next step; within a step the ready flags order
  // phase B after phase A
  for (int t = 0; t < P.T; ++t) {
    beliefs_step<false>(P, t, sm, 1 + t);
    sends_step<KERNEL, false, SMEM>(P, t, sm2, stage, 1 + t);
    grid.sync();
  }
  for (int t = P.T - 1; t >= 0; --t) {
    beliefs_step<true>(P, t, sm, 2 * P.T - t);
    sends_step<KERNEL, true, SMEM>(P, t, sm2, stage, 2 * P.T - t);
    grid.sync();
  }

  // the sweep's lower bound: one block sums the accumulators, in a fixed
  // order (the same bits from run to run)
  if (blockIdx.x == 0) {
    double s = 0.0;
    for (int i = tid; i < LB_SLOTS * P.H; i += nthreads)
      s += __ldcg(P.lbacc + i);
    red[tid] = s;
    __syncthreads();
    if (tid == 0) {
      double total = 0.0;
      for (int i = 0; i < nthreads; ++i) total += red[i];
      *P.lb = total;
    }
  }
}

// The grid: no more blocks than the widest step has jobs of the narrowest
// width, and no more than are resident at once (the cooperative launch
// refuses a larger grid).  At K = 15 that is 188 blocks at 370 x 413,
// 3.6% faster than one an SM; from K = 79 one block an SM is resident
// (PERF.md has the times).

template <int KERNEL>
cudaError_t launch(Params P, float* scratch, long long scratch_floats,
                   long long* need, int* grid, cudaStream_t st) {
  dim3 block(TILE, target_blocks(P.K));
  const int widest = P.H < P.W ? P.H : P.W;
  StagePlan plan;
  cudaError_t err = plan_stage(
      (const void*)wavefront_sweep_kernel<KERNEL, true>,
      (const void*)wavefront_sweep_kernel<KERNEL, false>, 0, P.K,
      block.x * block.y, 4 * ((widest + MIN_JOB - 1) / MIN_JOB), true,
      &plan);
  if (err != cudaSuccess || scratch_short(plan, scratch_floats, need))
    return err;
  *grid = plan.grid;
  P.gstage = scratch;
  void* args[] = {(void*)&P};
  err = cudaLaunchCooperativeKernel(plan.fn, dim3(plan.grid), block, args,
                                    plan.dyn, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// ptrs: P_COUNT device pointers in the order of enum Ptr (a host array);
// dims: {K, H, W}; width: phase B's job width (32, 16 or 8), or 0 to choose
// it a step (minplus.cuh::job_width); scratch, scratch_floats, need: the
// staging hand-shake of minplus.cuh::scratch_short; grid: out, the blocks
// of the launch.  Returns 0 or the CUDA error code.
extern "C" int wavefront_sweep_f32(const void* const* ptrs, const int* dims,
                                   float tol, int kernel, int width,
                                   float* scratch, long long scratch_floats,
                                   long long* need, int* grid, void* stream) {
  Params P;
#define FP(i) ((const float*)ptrs[i])
  P.theta = FP(P_THETA); P.D0 = FP(P_D0); P.QA = FP(P_QA); P.QB = FP(P_QB);
  P.aA = FP(P_AA); P.aB = FP(P_AB); P.vA = FP(P_VA); P.vB = FP(P_VB);
  P.gamma = FP(P_GAMMA);
#undef FP
  P.MA = (float*)ptrs[P_MA]; P.MB = (float*)ptrs[P_MB];
  P.gD = (float*)ptrs[P_GD];
  P.lbacc = (double*)ptrs[P_LBACC]; P.lb = (double*)ptrs[P_LB];
  P.flags = (int*)ptrs[P_FLAGS];
  if (width != 0 && width != TILE && width != TILE / 2 && width != MIN_JOB)
    return (int)cudaErrorInvalidValue;
  P.tol = tol;
  P.width = width;
  P.K = dims[0]; P.H = dims[1]; P.W = dims[2];
  P.T = P.H + P.W - 1;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(kernel == 1
                   ? launch<1>(P, scratch, scratch_floats, need, grid, st)
                   : launch<2>(P, scratch, scratch_floats, need, grid, st));
}
