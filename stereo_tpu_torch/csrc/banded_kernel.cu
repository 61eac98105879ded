// One whole banded TRW-S sweep in one launch, for NVIDIA Hopper (sm_90a),
// float32.  Replaces the TPU kernel stereo_tpu/ops/banded_kernel.py::_kernel
// (sweep_banded_pallas).
//
// What it computes: solvers/banded.py::_fwd_col for steps t = 0 .. T-1, then
// _bwd_col for t = T-1 .. 0, in place on the state (MA, MB, SxL, SxR, SyU,
// SyD), and the sweep's lower bound.  T = Bh + Bw - 1.
//
// Plain C interface (loaded with ctypes): raw device pointers and a CUDA
// stream; one cooperative launch on that stream, no synchronisation, no
// allocation (the wrapper hands in the scratch); returns the CUDA error
// code of the launch.  Built with -fmad=false (ops/_build.py): the messages
// and seam arrays equal the plain PyTorch version's bit for bit.  The lower
// bound is accumulated per lane in double and reduced at the end, so it
// agrees with the plain version's float32 sums to their rounding only.
//
// Design.  The problem's skewed column arrays are read where they lie; what
// the TPU kernel does with lane rotations and resident windows is index
// arithmetic here:
//   within-block up/down neighbour of lane l          lane l -/+ nb
//   x-seam partner buffers                             SxR[l - 1], SxL[l + 1]
//   y-seam buffers of the group-0 lane (0, b)          SyU[t nb + b], SyD[t nb + b - Gx]
//   y-seam buffers of the group-(Bh-1) lane            SyD[x2 nb + b], SyU[x2 nb + b + Gx],
//                                                      x2 = t - Bh + 1
// and every guard that the plain version applies as a mask after a wrapped
// roll is applied here before the load.
//
// A step has two phases: phase A forms the node beliefs of the step's column
// from the eight incident buffers and writes gamma * belief (backward: minus
// its minimum, which goes to the bound) to the scratch column gD, one tile of
// 32 lanes at a time; phase B does the eight sends of the step, each reading
// gD at the source lane and its own lane's old message and writing the new
// message over it.  The kernel is persistent, launched with
// cudaLaunchCooperativeKernel on a grid no larger than what is resident at
// once (a larger grid is refused by the launch, it cannot hang), and its
// blocks stride over a phase's tiles and jobs.
//
// A job is one send for a tile of 32 neighbouring lanes, done by a block of
// 32 x target_blocks(K) threads (minplus.cuh::send_lane: at most 12 warps,
// more than 96 labels in several passes), which stages the tile's K sources
// in shared memory before it walks them (in global scratch when they do not
// fit, so every K is taken).  Only lanes that hold a node at this step are
// enumerated: in the skewed layout they are the contiguous range yb in
// [max(0, t - Bw + 1), min(Bh - 1, t)], and a seam send touches one group of
// nb lanes.
//
// What bounds it: per sweep 8 sends x K^2 x 6 float32 instructions per pixel
// against every live problem and message entry moved once per pass; at teddy
// K = 79 the operations are the larger bound, 0.755 ms.  What one measured
// on top (PERF.md) is a fixed cost of every one of the 2 T steps (15 us at
// K = 15) -- the barriers over 132 blocks and chains of dependent global
// round trips -- and the thin parallelism of a step (a few thousand
// lane-sends for 132 SMs).  What the design does about the fixed cost:
//   - one grid.sync() a step, after phase B.  Phase B waits for phase A of
//     the same step through per-tile ready flags (release by the tile's
//     block, acquire by the jobs that need the tile; sends_step states which
//     tiles a job needs);
//   - no load waits for another load: phase A issues all of a tile's
//     loads at once (the seam buffers under the index part of their masks,
//     the problem's part applied at the sum), and a phase-B job issues its
//     problem loads (validity, weights, the staging of the source positions
//     by cp.async, its targets) before it waits for its flags, so after the
//     wait one global round trip is left (gD and its own message); the
//     bound's accumulators are read before the wait their update follows.
//     (Loading phase A's problem before the grid.sync was tried and was
//     slower: the barrier's fence waits for the loads in flight.  So were
//     a barrier of one release atomic and acquire polls in place of
//     grid.sync(), and phase A's loads through L2: PERF.md has the times.)
// The arithmetic, and the order of every sum, are the plain version's: the
// messages stay bit for bit.

#include <cooperative_groups.h>

#include "minplus.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace minplus;

constexpr int LB_SLOTS = 9;  // node term + the 8 sends of a backward step

struct Params {
  // problem columns: theta, D0 [T+2, K, L]; QA, QB [T+2, 2, K, L];
  // aA, aB, vA, vB [T+2, 2, L]; pix, gamma [T+2, L]
  const float *theta, *D0, *QA, *QB, *aA, *aB, *vA, *vB, *pix, *gamma;
  // seam problem data: Px* [K, L] / [L]; Py* [K, Lp] / [Lp]
  const float *PxL_q, *PxL_d0, *PxL_a, *PxR_q, *PxR_d0, *PxR_a;
  const float *PyU_q, *PyU_d0, *PyU_a, *PyD_q, *PyD_d0, *PyD_a;
  // seam buffer validity: vSx* [L], vSy* [Lp] (bytes, 0 or 1)
  const unsigned char *vSxL, *vSxR, *vSyU, *vSyD;
  // state, updated in place: MA, MB [T+2, 2, K, L]; Sx* [K, L]; Sy* [K, Lp]
  float *MA, *MB, *SxL, *SxR, *SyU, *SyD;
  float* gD;      // scratch [K, L]
  double* lbacc;  // scratch [LB_SLOTS, Lp]
  int* flags;     // scratch [ceil(L / 32)]: phase A's per-tile ready flags
  double* lb;     // out [1]
  float* gstage;  // scratch: grid x stage_floats(K), or null (plan_stage)
  float tol;
  int K, Bh, Bw, Gy, Gx, nb, L, Lp, T;
};

// order of the pointer array handed to banded_sweep_f32 (ops/banded_kernel.py
// builds it in this order)
enum Ptr {
  P_THETA, P_D0, P_QA, P_QB, P_AA, P_AB, P_VA, P_VB, P_PIX, P_GAMMA,
  P_PXL_Q, P_PXL_D0, P_PXL_A, P_PXR_Q, P_PXR_D0, P_PXR_A,
  P_PYU_Q, P_PYU_D0, P_PYU_A, P_PYD_Q, P_PYD_D0, P_PYD_A,
  P_VSXL, P_VSXR, P_VSYU, P_VSYD,
  P_MA, P_MB, P_SXL, P_SXR, P_SYU, P_SYD, P_GD, P_LBACC, P_FLAGS, P_LB,
  P_COUNT
};

__host__ __device__ inline int tiles(int n) { return (n + TILE - 1) / TILE; }

// Lanes of step s's column that hold nodes: [lo, hi); empty outside 0..T-1.
__device__ __forceinline__ void live_range(const Params& P, int s, int& lo,
                                           int& hi) {
  if (s < 0 || s >= P.T) {
    lo = hi = 0;
    return;
  }
  lo = max(0, s - P.Bw + 1) * P.nb;
  hi = (min(P.Bh - 1, s) + 1) * P.nb;
}

// Release and acquire at device scope, for the per-tile ready flags.
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

// Phase A of step t for one tile of 32 lanes: beliefs of column c = t + 1
// -> gD (and, backward, the node term of the bound), then the tile's ready
// flag.  The additions follow solvers/banded.py::_beliefs term by term.
// Thread y sums the labels k = (p KT + j) blockDim.y + y, j < KT, in passes
// p; backward, the sums of the passes before the last wait in gD for the
// step's minimum.  Every load of the tile is issued at once: the seam
// buffers are loaded under the index part of their masks and selected by
// the problem's part (vSx*, pix) at the sum, so no load waits for another.
template <bool BACKWARD>
__device__ void belief_tile(const Params& P, int t, int tile,
                            float (*sm)[TILE], int epoch) {
  const int K = P.K, L = P.L, Lp = P.Lp, nb = P.nb, c = t + 1;
  const int ny = blockDim.y, npass = target_passes(K);
  const long long KL = (long long)K * L;
  int lo, hi;
  live_range(P, t, lo, hi);
  const float* th = P.theta + c * KL;
  const float* A0 = P.MA + 2LL * c * KL;
  const float* A1 = A0 + KL;
  const float* B0 = P.MB + 2LL * c * KL;
  const float* B1 = B0 + KL;
  const float* Am0 = P.MA + 2LL * (c - 1) * KL;
  const float* Am1 = Am0 + KL;
  const float* Bp0 = P.MB + 2LL * (c + 1) * KL;
  const float* Bp1 = Bp0 + KL;
  const int x2 = t - (P.Bh - 1);
  const int l = lo + tile * TILE + threadIdx.x;
  const bool active = l < hi;
  float D[KT];
  float part = CUDART_INF_F, gam = 0.0f, pixc = 0.0f;
  double lb_old = 0.0;
  if (active) {
    if (BACKWARD && threadIdx.y == 0) lb_old = P.lbacc[l];
    pixc = P.pix[(long long)c * L + l];
    gam = P.gamma[(long long)c * L + l];
    const unsigned char vxl = P.vSxL[l], vxr = P.vSxR[l];
    const int yb = l / nb, b = l - yb * nb, gy = b / P.Gx;
    const bool up_in = l >= nb, dn_in = l + nb < L;
    // the index part of each seam mask (what makes the loads valid) ...
    const bool ix0 = yb == t && l >= 1;
    const bool ixW = yb == t - (P.Bw - 1) && l + 1 < L;
    const bool iy0 = yb == 0 && gy > 0 && t < P.Bw;
    const bool iyT = yb == P.Bh - 1 && gy < P.Gy - 1 && x2 >= 0 && x2 < P.Bw;
    const int u0 = t * nb + b, uT = x2 * nb + b;
    for (int p = 0; p < npass; ++p) {
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const int k = (p * KT + j) * ny + threadIdx.y;
        if (k < K) {
          const long long o = (long long)k * L + l;
          const long long o2 = (long long)k * Lp;
          const float sx0 = ix0 ? P.SxL[o] + P.SxR[o - 1] : 0.0f;
          const float sxW = ixW ? P.SxR[o] + P.SxL[o + 1] : 0.0f;
          const float sy0 =
              iy0 ? P.SyU[o2 + u0] + P.SyD[o2 + u0 - P.Gx] : 0.0f;
          const float syT =
              iyT ? P.SyD[o2 + uT] + P.SyU[o2 + uT + P.Gx] : 0.0f;
          float d = th[o] + A0[o];
          d = d + A1[o];
          d = d + B0[o];
          d = d + B1[o];
          d = d + Am0[o];
          d = d + (up_in ? Am1[o - nb] : 0.0f);
          d = d + Bp0[o];
          d = d + (dn_in ? Bp1[o + nb] : 0.0f);
          // ... and its problem part
          d = d + (ix0 && vxl ? sx0 : 0.0f);
          d = d + (ixW && vxr ? sxW : 0.0f);
          d = d + (iy0 && pixc > 0.0f ? sy0 : 0.0f);
          d = d + (iyT && pixc > 0.0f ? syT : 0.0f);
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
    if (active && threadIdx.y == 0 && pixc > 0.0f)
      P.lbacc[l] = lb_old + (double)vmin;
    if (active) {
      for (int p = 0; p < npass; ++p) {
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          const int k = (p * KT + j) * ny + threadIdx.y;
          if (k < K) {
            float* o = P.gD + (long long)k * L + l;
            *o = gam * ((p + 1 < npass ? *o : D[j]) - vmin);
          }
        }
      }
    }
  }
  // the tile is ready: the barrier orders every thread's gD writes before
  // thread 0's release of the flag
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

// send_lane's wait in phase B: the lanes of warp 0 poll the flags of
// phase-A tiles first .. last of the step, one flag each (32 at a time),
// until all have published the step's epoch; then the block passes a
// barrier.  Nothing to wait for when last < first.
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

// Phase B of step t: the eight sends.  Heads are the group the pass writes at
// column c (forward: A = (RT, DN); backward: B = (LT, UP)); tails are the
// other group, written into column cn = c + 1 (forward) or c - 1 (backward).
//
// A job waits for the phase-A tiles of the step that cover the lanes of
// this rule (ops/banded_kernel.py::wait_lanes is the same rule, and
// tests/test_torch_any_k.py checks it against the plain version's index
// maps), l0 the first lane of the job's tile in its segment's lane space:
//   head-sends (seg 0, 1)    [l0, l0 + 32)           gD read, own lane
//   tail-sends (seg 2, 3)    forward  [l0 - nb, l0 + 32)
//                            backward [l0, l0 + 32 + nb)
//                            gD at l and l -/+ nb; the message written at
//                            lane l is read by phase A at lane l (d = 0)
//                            and l -/+ nb (d = 1)
//   x-seam sends (seg 4, 5)  [l0 - 1, l0 + 33)      gD at l, l -/+ 1; phase A
//                            reads Sx* at l and l -/+ 1
//   y-seam sends (seg 6, 7)  every tile of the step
// clipped to the step's live lanes.  So phase B reads gD only once it is
// written, and overwrites a message only once phase A has read it.  A block
// runs all its phase-A tiles of the step before its first job, phase A
// never waits, and every block is resident (a cooperative launch refuses a
// grid that is not), so every flag a job waits for is published: no
// deadlock.
template <int KERNEL, bool BACKWARD, bool SMEM>
__device__ void sends_step(const Params& P, int t, float (*sm)[TILE],
                           float* stage, int epoch) {
  const int K = P.K, L = P.L, Lp = P.Lp, nb = P.nb, Gx = P.Gx, c = t + 1;
  const int cn = BACKWARD ? c - 1 : c + 1;
  const long long KL = (long long)K * L;
  float* Mh = BACKWARD ? P.MB : P.MA;
  const float* Qh = BACKWARD ? P.QB : P.QA;
  const float* ah = BACKWARD ? P.aB : P.aA;
  const float* vh = BACKWARD ? P.vB : P.vA;
  float* Mt = BACKWARD ? P.MA : P.MB;
  const float* Qt = BACKWARD ? P.QA : P.QB;
  const float* at = BACKWARD ? P.aA : P.aB;
  const float* vt = BACKWARD ? P.vA : P.vB;
  // seam arrays: the head-sends of a pass write the seam buffers of the
  // tails' directions (forward: SxL = LT, SyU = UP), its tail-sends those of
  // the heads' directions (forward: SxR = RT, SyD = DN)
  float* Sxh = BACKWARD ? P.SxR : P.SxL;
  float* Sxt = BACKWARD ? P.SxL : P.SxR;
  float* Syh = BACKWARD ? P.SyD : P.SyU;
  float* Syt = BACKWARD ? P.SyU : P.SyD;
  const unsigned char* vSxh = BACKWARD ? P.vSxR : P.vSxL;
  const unsigned char* vSxt = BACKWARD ? P.vSxL : P.vSxR;
  const unsigned char* vSyh = BACKWARD ? P.vSyD : P.vSyU;
  const unsigned char* vSyt = BACKWARD ? P.vSyU : P.vSyD;
  const float* Pxt_q = BACKWARD ? P.PxL_q : P.PxR_q;
  const float* Pxt_d0 = BACKWARD ? P.PxL_d0 : P.PxR_d0;
  const float* Pxt_a = BACKWARD ? P.PxL_a : P.PxR_a;
  const float* Pyt_q = BACKWARD ? P.PyU_q : P.PyD_q;
  const float* Pyt_d0 = BACKWARD ? P.PyU_d0 : P.PyD_d0;
  const float* Pyt_a = BACKWARD ? P.PyU_a : P.PyD_a;

  int hlo, hhi, tlo, thi;
  live_range(P, t, hlo, hhi);
  live_range(P, BACKWARD ? t - 1 : t + 1, tlo, thi);
  // x-seam sends act on the yb group xg, y-seam sends on the lane2 group yg
  const int xg = BACKWARD ? t - (P.Bw - 1) : t;
  const int yg = BACKWARD ? t - (P.Bh - 1) : t;
  // lane of the y-seam node in the step's column: group 0 or group Bh - 1
  const int ybase = BACKWARD ? (P.Bh - 1) * nb : 0;
  const int n_h = tiles(hhi - hlo), n_t = tiles(thi - tlo);
  const int n_x = (xg >= 0 && xg < P.Bh) ? tiles(nb) : 0;
  const int n_y = (yg >= 0 && yg < P.Bw) ? tiles(nb) : 0;
  const int n_seg[8] = {n_h, n_h, n_t, n_t, n_x, n_x, n_y, n_y};
  const int njobs = 2 * (n_h + n_t + n_x + n_y);

  for (int job = blockIdx.x; job < njobs; job += gridDim.x) {
    int seg = 0, tile = job;
    while (tile >= n_seg[seg]) tile -= n_seg[seg++];
    const int i = tile * TILE + threadIdx.x;
    // the lanes of the step's phase A this job waits for (see above)
    int wlo = hlo, whi = hhi;
    if (seg < 2) {
      wlo = hlo + tile * TILE;
      whi = wlo + TILE;
    } else if (seg < 4) {
      const int l0 = tlo + tile * TILE;
      wlo = BACKWARD ? l0 : l0 - nb;
      whi = BACKWARD ? l0 + TILE + nb : l0 + TILE;
    } else if (seg < 6) {
      wlo = xg * nb + tile * TILE - 1;
      whi = wlo + TILE + 2;
    }
    wlo = max(wlo, hlo);
    whi = min(whi, hhi);
    const TileWait wait{P.flags, (wlo - hlo) / TILE,
                        wlo < whi ? (whi - 1 - hlo) / TILE : -1, epoch};

    bool in = false, active = false;
    const float *g = nullptr, *xt = nullptr, *ys = nullptr;
    float* m = nullptr;
    long long m_stride = L, xt_stride = L, ys_stride = L;
    float a = 0.0f;
    int acc_lane = 0;  // where this send's bound term is accumulated
    if (seg < 2) {
      // interior head-send, direction d of the heads' group, at column c
      const int d = seg, l = hlo + i;
      if (l < hhi) {
        in = true;
        active = vh[(2LL * c + d) * L + l] > 0.0f;
        const long long o = (2LL * c + d) * KL + l;
        g = P.gD + l;
        m = Mh + o;
        xt = Qh + o;
        ys = P.D0 + c * KL + l;
        a = ah[(2LL * c + d) * L + l];
        acc_lane = l;
      }
    } else if (seg < 4) {
      // interior tail-send, direction d of the tails' group, into column cn;
      // d = 0 takes the source at the same lane, d = 1 at the vertical
      // neighbour (forward: l - nb, backward: l + nb)
      const int d = seg - 2, l = tlo + i;
      const int ls = d == 0 ? l : (BACKWARD ? l + nb : l - nb);
      if (l < thi && ls >= 0 && ls < L) {
        in = true;
        active = vt[(2LL * cn + d) * L + l] > 0.0f;
        const long long o = (2LL * cn + d) * KL + l;
        g = P.gD + ls;
        m = Mt + o;
        xt = P.D0 + cn * KL + l;
        ys = Qt + o;
        a = at[(2LL * cn + d) * L + l];
        acc_lane = l;
      }
    } else if (seg == 4) {
      // x-seam head-send at the nodes (b, yb = xg, xb = 0 | Bw - 1)
      const int l = xg * nb + i;
      if (i < nb) {
        in = true;
        active = vSxh[l];
        g = P.gD + l;
        m = Sxh + l;
        xt = Qt + (2LL * c) * KL + l;
        ys = P.D0 + c * KL + l;
        a = at[(2LL * c) * L + l];
        acc_lane = l;
      }
    } else if (seg == 5) {
      // x-seam tail-send: source in the neighbouring block, one lane on
      // (forward: l + 1, backward: l - 1)
      const int l = xg * nb + i;
      const int ls = BACKWARD ? l - 1 : l + 1;
      if (i < nb && ls >= 0 && ls < L) {
        in = true;
        active = vSxt[l];
        g = P.gD + ls;
        m = Sxt + l;
        xt = Pxt_d0 + l;
        ys = Pxt_q + l;
        a = Pxt_a[l];
        acc_lane = l;
      }
    } else if (seg == 6) {
      // y-seam head-send at the nodes (b, yb = 0 | Bh - 1, xb = yg): source
      // lane l in the column, buffer at lane2 = yg nb + b
      const int b = i, l = ybase + b, l2 = yg * nb + b;
      if (b < nb) {
        const int gy = b / Gx;
        const bool has = BACKWARD ? gy < P.Gy - 1 : gy > 0;
        in = true;
        active = has && P.pix[(long long)c * L + l] > 0.0f && vSyh[l2];
        g = P.gD + l;
        m = Syh + l2;
        m_stride = Lp;
        xt = Qt + (2LL * c + 1) * KL + l;
        ys = P.D0 + c * KL + l;
        a = at[(2LL * c + 1) * L + l];
        acc_lane = l2;
      }
    } else {
      // y-seam tail-send: source in the block below (forward, its group-0
      // lane b + Gx) or above (backward, its group-(Bh-1) lane b - Gx)
      const int b = i, l2 = yg * nb + b;
      const int bs = BACKWARD ? b - Gx : b + Gx;
      if (b < nb && bs >= 0 && bs < nb) {
        in = true;
        active = vSyt[l2];
        g = P.gD + ybase + bs;
        m = Syt + l2;
        m_stride = Lp;
        xt = Pyt_d0 + l2;
        xt_stride = Lp;
        ys = Pyt_q + l2;
        ys_stride = Lp;
        a = Pyt_a[l2];
        acc_lane = l2;
      }
    }
    // the bound's slot was last written by an earlier step: read it now
    double* lb_slot = P.lbacc + (1 + seg) * (long long)Lp + acc_lane;
    const double lb_old =
        BACKWARD && in && threadIdx.y == 0 ? __ldcg(lb_slot) : 0.0;
    const float vmin = send_lane<KERNEL, true, SMEM>(
        in, active, g, L, m, m_stride, xt, xt_stride, ys, ys_stride, a, P.tol,
        K, m, m_stride, sm, stage, wait);
    if (BACKWARD && active && threadIdx.y == 0)
      *lb_slot = lb_old + (double)vmin;
  }
}

template <int KERNEL, bool SMEM>
__global__ void __launch_bounds__(TILE * MAX_TB)
    banded_sweep_kernel(const Params P) {
  __shared__ float sm[MAX_TB][TILE];
  __shared__ double red[MAX_TB * TILE];
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
  for (long long i = gtid; i < (long long)LB_SLOTS * P.Lp; i += gthreads)
    P.lbacc[i] = 0.0;
  for (long long i = gtid; i < tiles(P.L); i += gthreads) P.flags[i] = 0;
  grid.sync();

  // one grid.sync a step: it orders the step's sends (which write the
  // messages that the next step's beliefs read, and read the gD that they
  // overwrite) before the next step; within a step the ready flags order
  // phase B after phase A
  for (int t = 0; t < P.T; ++t) {
    beliefs_step<false>(P, t, sm, 1 + t);
    sends_step<KERNEL, false, SMEM>(P, t, sm, stage, 1 + t);
    grid.sync();
  }
  for (int t = P.T - 1; t >= 0; --t) {
    beliefs_step<true>(P, t, sm, 2 * P.T - t);
    sends_step<KERNEL, true, SMEM>(P, t, sm, stage, 2 * P.T - t);
    grid.sync();
  }

  // the sweep's lower bound: one block sums the accumulators, in a fixed
  // order (the same bits from run to run)
  if (blockIdx.x == 0) {
    double s = 0.0;
    for (int i = tid; i < LB_SLOTS * P.Lp; i += nthreads)
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

template <int KERNEL>
cudaError_t launch(Params P, float* scratch, long long scratch_floats,
                   long long* need, cudaStream_t st) {
  dim3 block(TILE, target_blocks(P.K));
  // no more blocks than the largest step has jobs, and no more than are
  // resident at once (the cooperative launch refuses a larger grid)
  StagePlan plan;
  cudaError_t err = plan_stage(
      (const void*)banded_sweep_kernel<KERNEL, true>,
      (const void*)banded_sweep_kernel<KERNEL, false>, 0, P.K,
      block.x * block.y, 4 * (tiles(P.L) + 1) + 4 * tiles(P.nb), true, &plan);
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
// dims: {K, Bh, Bw, Gy, Gx}; scratch, scratch_floats, need: the staging
// hand-shake of minplus.cuh::scratch_short.  Returns 0 or the CUDA error
// code.
extern "C" int banded_sweep_f32(const void* const* ptrs, const int* dims,
                                float tol, int kernel, float* scratch,
                                long long scratch_floats, long long* need,
                                void* stream) {
  Params P;
#define FP(i) ((const float*)ptrs[i])
#define MP(i) ((float*)ptrs[i])
#define BP(i) ((const unsigned char*)ptrs[i])
  P.theta = FP(P_THETA); P.D0 = FP(P_D0); P.QA = FP(P_QA); P.QB = FP(P_QB);
  P.aA = FP(P_AA); P.aB = FP(P_AB); P.vA = FP(P_VA); P.vB = FP(P_VB);
  P.pix = FP(P_PIX); P.gamma = FP(P_GAMMA);
  P.PxL_q = FP(P_PXL_Q); P.PxL_d0 = FP(P_PXL_D0); P.PxL_a = FP(P_PXL_A);
  P.PxR_q = FP(P_PXR_Q); P.PxR_d0 = FP(P_PXR_D0); P.PxR_a = FP(P_PXR_A);
  P.PyU_q = FP(P_PYU_Q); P.PyU_d0 = FP(P_PYU_D0); P.PyU_a = FP(P_PYU_A);
  P.PyD_q = FP(P_PYD_Q); P.PyD_d0 = FP(P_PYD_D0); P.PyD_a = FP(P_PYD_A);
  P.vSxL = BP(P_VSXL); P.vSxR = BP(P_VSXR);
  P.vSyU = BP(P_VSYU); P.vSyD = BP(P_VSYD);
  P.MA = MP(P_MA); P.MB = MP(P_MB); P.SxL = MP(P_SXL); P.SxR = MP(P_SXR);
  P.SyU = MP(P_SYU); P.SyD = MP(P_SYD); P.gD = MP(P_GD);
  P.lbacc = (double*)ptrs[P_LBACC]; P.lb = (double*)ptrs[P_LB];
  P.flags = (int*)ptrs[P_FLAGS];
#undef FP
#undef MP
#undef BP
  P.tol = tol;
  P.K = dims[0]; P.Bh = dims[1]; P.Bw = dims[2]; P.Gy = dims[3];
  P.Gx = dims[4];
  P.nb = P.Gy * P.Gx;
  P.L = P.Bh * P.nb;
  P.Lp = (P.Bh > P.Bw ? P.Bh : P.Bw) * P.nb;
  P.T = P.Bh + P.Bw - 1;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(kernel == 1
                   ? launch<1>(P, scratch, scratch_floats, need, st)
                   : launch<2>(P, scratch, scratch_floats, need, st));
}
