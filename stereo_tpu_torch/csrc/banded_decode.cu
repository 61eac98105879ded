// The greedy conditioned decode of the banded TRW-S state in one launch, for
// NVIDIA Hopper (sm_90a), float32.  Replaces no TPU kernel: the JAX package
// runs this decode as one lax.scan (stereo_tpu/solvers/banded.py::
// _decode_state), which XLA compiles into one program; this is that scan as
// a kernel.
//
// What it computes: solvers/banded.py::_decode_state, the T = Bh + Bw - 1
// steps of _decode_step in order, each node conditioned on the solutions of
// its earlier neighbours (interior left and up, seam right and down) plus
// the messages of its later edges; the argmin over the K labels (ties to
// the lowest index, a NaN first, as torch.argmin); the labels [H, W] int32
// and the energy, the sum over real pixels of the conditioned term at the
// chosen label.
//
// Plain C interface (loaded with ctypes): raw device pointers and a CUDA
// stream; one cooperative launch on that stream, no synchronisation, no
// allocation (the wrapper hands in the scratch); returns the CUDA error
// code of the launch.  Built with -fmad=false (ops/_build.py): every term
// is added in the plain version's order and rounds as it does, so the
// labels equal the plain version's bit for bit.  The energy is accumulated
// per lane in double and summed at the end, so it agrees with the plain
// version's float32 sums to their rounding only.
//
// Design.  The problem's skewed column arrays and the message state are
// read where they lie; every roll, pad and seam view of the plain version
// is index arithmetic here (lane l = yb nb + b of step t's column c = t + 1):
//   interior left / up neighbour's solution     sols[c - 1][l], [l - nb]
//   seam right neighbour's (x-seam, xb = Bw-1)  sols[c - Bw + 1][l + 1]
//   seam down neighbour's (y-seam, yb = Bh-1)   sols[c - Bh + 1][b + Gx]
//   its (Q[UP], D0, alpha[UP]) in the Sy layout  PyU_*[x2 nb + b + Gx],
//                                                x2 = t - Bh + 1
//   the x-seam partner buffers                   SxL[l], SxR[l - 1]
//   the y-seam buffers of a yb = 0 lane          SyU[t nb + b], SyD[.. - Gx]
// and every guard that the plain version applies as a mask after a wrapped
// roll is applied here before the load.  A step depends on the solutions of
// steps t - 1, t - Bw + 1 and t - Bh + 1, so the kernel walks t = 0 .. T-1
// itself with one grid.sync() between steps; the kernel is persistent,
// launched with cudaLaunchCooperativeKernel on a grid no larger than what
// is resident at once (a larger grid is refused by the launch, it cannot
// hang).  Only the live lanes of a step are visited (ops/banded_kernel.py::
// live_lanes), in tiles of DTL lanes, one tile a block at a time; a block
// is DTL lanes x ny label rows, thread (x, y) takes the labels y, y + ny,
// ... of lane x and keeps its best (value, label, conditioned term), and
// the block reduces the rows in shared memory.  Per label a thread reads
// eight planes of the step (theta, D0, the two out-edge positions at the
// earlier column, the four later-edge messages), so K holds no shared
// memory and every K is taken.
//
// What bounds it: a decode reads every real pixel's eight K-planes once,
// (8 K + 16) floats a pixel at 3.35 TB/s (0.13 ms at teddy K = 79); the T
// steps, each a grid-wide barrier and a chain of dependent loads (the
// solutions, then the gathers they index), cost more (PERF.md has the
// times).

#include <climits>
#include <cooperative_groups.h>

#include "minplus.cuh"

namespace cg = cooperative_groups;

namespace {

using minplus::trunc_cost;

constexpr int DTL = 16;   // lanes of a tile
constexpr int MAX_Y = 32;  // label rows of a block
constexpr int LABELS_PER_THREAD = 4;

struct Params {
  // problem columns: theta, D0 [T+2, K, L]; QA, QB [T+2, 2, K, L];
  // aA, aB, vA, vB [T+2, 2, L]; pix [T+2, L]
  const float *theta, *D0, *QA, *QB, *aA, *aB, *vA, *vB, *pix;
  // seam problem data of the decode's down and right conditioning:
  // PxL_* [K, L] / [L]; PyU_* [K, Lp] / [Lp]
  const float *PxL_q, *PxL_d0, *PxL_a, *PyU_q, *PyU_d0, *PyU_a;
  // seam buffer validity: vSx* [L] (bytes, 0 or 1)
  const unsigned char *vSxL, *vSxR;
  // the message state (read only): MA, MB [T+2, 2, K, L]; Sx* [K, L];
  // Sy* [K, Lp]
  const float *MA, *MB, *SxL, *SxR, *SyU, *SyD;
  int* sols;       // scratch [T+2, L]: the steps' solutions
  double* eacc;    // scratch [L]: each lane's energy terms
  int* labels;     // out [H, W]
  double* energy;  // out [1]
  float tol;
  int K, H, W, Bh, Bw, Gy, Gx, nb, L, Lp, T;
};

// order of the pointer array handed to banded_decode_f32 (ops/
// banded_decode.py builds it in this order)
enum Ptr {
  P_THETA, P_D0, P_QA, P_QB, P_AA, P_AB, P_VA, P_VB, P_PIX,
  P_PXL_Q, P_PXL_D0, P_PXL_A, P_PYU_Q, P_PYU_D0, P_PYU_A,
  P_VSXL, P_VSXR,
  P_MA, P_MB, P_SXL, P_SXR, P_SYU, P_SYD,
  P_SOLS, P_EACC, P_LABELS, P_ENERGY,
  P_COUNT
};

// torch.argmin's order: a NaN before any number, then the lower value, a
// tie to the lower label.
__device__ __forceinline__ bool before(float a, int ka, float b, int kb) {
  if (a != a) return b == b || ka < kb;
  if (b != b) return false;
  return a == b ? ka < kb : a < b;
}

// One tile of DTL lanes of step t: the lanes' conditioned terms over the K
// labels, their argmin, the solutions, the labels and the energy terms.
// The additions follow solvers/banded.py::_decode_step term by term.
template <int KERNEL>
__device__ void decode_tile(const Params& P, int t, int l, bool active,
                            float (*sv)[DTL], int (*sk)[DTL],
                            float (*sd)[DTL]) {
  const int K = P.K, L = P.L, Lp = P.Lp, nb = P.nb, Gx = P.Gx, c = t + 1;
  const int ny = blockDim.y;
  const long long KL = (long long)K * L;
  const float tol = P.tol;
  float best = CUDART_INF_F, best_db = 0.0f;
  int best_k = INT_MAX;
  if (active) {
    const int yb = l / nb, b = l - yb * nb, gy = b / Gx;
    const float pixc = P.pix[(long long)c * L + l];
    const bool up = l >= nb, dn = l + nb < L;
    const bool mx0 = yb == t && l >= 1 && P.vSxL[l];
    const bool mxW = yb == t - (P.Bw - 1) && l + 1 < L && P.vSxR[l];
    const bool my0 = yb == 0 && gy > 0 && pixc > 0.0f;
    const bool myT = yb == P.Bh - 1 && gy < P.Gy - 1 && pixc > 0.0f;
    // the earlier neighbours' solutions, written by earlier steps in other
    // blocks: read past L1
    const int* prev = P.sols + (long long)(c - 1) * L;
    const int sol_l = __ldcg(prev + l);
    const int sol_u = up ? __ldcg(prev + l - nb) : 0;
    const int sol_r =
        mxW ? __ldcg(P.sols + (long long)(c - (P.Bw - 1)) * L + l + 1) : 0;
    const int i2 = (t - (P.Bh - 1)) * nb + b + Gx;  // Sy lane of the node below
    const int sol_d =
        myT ? __ldcg(P.sols + (long long)(c - (P.Bh - 1)) * L + b + Gx) : 0;
    // the lane's problem data at those solutions
    const long long c0 = 2LL * c * L + l, c1 = c0 + L;  // [c, d, l]
    const long long p0 = 2LL * (c - 1) * L + l;       // [c - 1, 0, l]
    const long long p1 = p0 + L - nb;                 // [c - 1, 1, l - nb]
    const float ab0 = P.aB[c0], vb0 = P.vB[c0];
    const float ab1 = P.aB[c1], vb1 = P.vB[c1];
    const float qb0 = P.QB[(2LL * c * K + sol_l) * L + l];
    const float qb1 = P.QB[((2LL * c + 1) * K + sol_u) * L + l];
    const float ap0 = P.aA[p0], vp0 = P.vA[p0];
    const float d0l = P.D0[((long long)(c - 1) * K + sol_l) * L + l];
    const float ap1 = up ? P.aA[p1] : 0.0f, vp1 = up ? P.vA[p1] : 0.0f;
    const float d0u =
        up ? P.D0[((long long)(c - 1) * K + sol_u) * L + l - nb] : 0.0f;
    const float ac0 = mxW ? P.aA[c0] : 0.0f;
    const float qc0 = mxW ? P.QA[(2LL * c * K + sol_r) * L + l] : 0.0f;
    const float aln = mxW ? P.PxL_a[l + 1] : 0.0f;
    const float d0ln = mxW ? P.PxL_d0[(long long)sol_r * L + l + 1] : 0.0f;
    const float ac1 = myT ? P.aA[c1] : 0.0f;
    const float qc1 = myT ? P.QA[((2LL * c + 1) * K + sol_d) * L + l] : 0.0f;
    const float adn = myT ? P.PyU_a[i2] : 0.0f;
    const float d0dn = myT ? P.PyU_d0[(long long)sol_d * Lp + i2] : 0.0f;
    const int u0 = t * nb + b;  // Sy lane of a yb = 0 node
    const float* th = P.theta + c * KL;
    const float* D0c = P.D0 + c * KL;
    const float* QAp0 = P.QA + 2LL * (c - 1) * KL;
    const float* QAp1 = QAp0 + KL;
    const float* A0 = P.MA + 2LL * c * KL;
    const float* A1 = A0 + KL;
    const float* Bn0 = P.MB + 2LL * (c + 1) * KL;
    const float* Bn1 = Bn0 + KL;
#pragma unroll 4
    for (int k = threadIdx.y; k < K; k += ny) {
      const long long o = (long long)k * L + l;
      const long long o2 = (long long)k * Lp;
      const float d0 = D0c[o];
      // conditioned on the interior earlier neighbours (left, up)
      float db = th[o];
      db = db + ab0 * trunc_cost<KERNEL>(qb0, d0, tol) * vb0;
      db = db + ab1 * trunc_cost<KERNEL>(qb1, d0, tol) * vb1;
      // the out-edges at them: E(left, RT), E(up, DN)
      db = db + ap0 * trunc_cost<KERNEL>(QAp0[o], d0l, tol) * vp0;
      db = db + (up ? ap1 * trunc_cost<KERNEL>(QAp1[o - nb], d0u, tol) * vp1
                    : 0.0f);
      // conditioned on the seam earlier neighbours: right, then down
      db = db + (mxW ? ac0 * trunc_cost<KERNEL>(qc0, d0, tol) : 0.0f);
      db = db + (mxW ? aln * trunc_cost<KERNEL>(P.PxL_q[o + 1], d0ln, tol)
                     : 0.0f);
      db = db + (myT ? ac1 * trunc_cost<KERNEL>(qc1, d0, tol) : 0.0f);
      db = db + (myT ? adn * trunc_cost<KERNEL>(P.PyU_q[o2 + i2], d0dn, tol)
                     : 0.0f);
      // the messages on the later edges
      float di = db + A0[o];
      di = di + A1[o];
      di = di + Bn0[o];
      di = di + (dn ? Bn1[o + nb] : 0.0f);
      di = di + (mx0 ? P.SxL[o] + P.SxR[o - 1] : 0.0f);
      di = di + (my0 ? P.SyU[o2 + u0] + P.SyD[o2 + u0 - Gx] : 0.0f);
      if (before(di, k, best, best_k)) {
        best = di;
        best_k = k;
        best_db = db;
      }
    }
  }
  sv[threadIdx.y][threadIdx.x] = best;
  sk[threadIdx.y][threadIdx.x] = best_k;
  sd[threadIdx.y][threadIdx.x] = best_db;
  __syncthreads();
  if (active && threadIdx.y == 0) {
    for (int y = 1; y < ny; ++y) {
      const float v = sv[y][threadIdx.x];
      const int k = sk[y][threadIdx.x];
      if (before(v, k, best, best_k)) {
        best = v;
        best_k = k;
        best_db = sd[y][threadIdx.x];
      }
    }
    const int yb = l / nb, b = l - yb * nb, gy = b / Gx, gx = b - gy * Gx;
    P.sols[(long long)c * L + l] = best_k;
    if (P.pix[(long long)c * L + l] > 0.0f)
      P.eacc[l] = __ldcg(P.eacc + l) + (double)best_db;
    const int y = gy * P.Bh + yb, x = gx * P.Bw + (t - yb);
    if (y < P.H && x < P.W) P.labels[(long long)y * P.W + x] = best_k;
  }
  __syncthreads();
}

template <int KERNEL>
__global__ void __launch_bounds__(DTL * MAX_Y)
    banded_decode_kernel(const Params P) {
  __shared__ float sv[MAX_Y][DTL];
  __shared__ int sk[MAX_Y][DTL];
  __shared__ float sd[MAX_Y][DTL];
  __shared__ double red[DTL * MAX_Y];
  cg::grid_group grid = cg::this_grid();
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const long long gtid = (long long)blockIdx.x * nthreads + tid;
  const long long gthreads = (long long)gridDim.x * nthreads;
  // every solution starts at label 0 (the plain version's zeros: what a
  // step reads at a lane that holds no node is multiplied by a zero
  // validity), every energy term at zero
  for (long long i = gtid; i < (long long)(P.T + 2) * P.L; i += gthreads)
    P.sols[i] = 0;
  for (long long i = gtid; i < P.L; i += gthreads) P.eacc[i] = 0.0;
  grid.sync();

  // one grid.sync a step: a step reads the solutions of earlier steps,
  // which other blocks wrote
  for (int t = 0; t < P.T; ++t) {
    const int lo = max(0, t - P.Bw + 1) * P.nb;
    const int hi = (min(P.Bh - 1, t) + 1) * P.nb;
    const int ntiles = (hi - lo + DTL - 1) / DTL;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int l = lo + tile * DTL + threadIdx.x;
      decode_tile<KERNEL>(P, t, l, l < hi, sv, sk, sd);
    }
    grid.sync();
  }

  // the energy: one block sums the lanes' terms, in a fixed order (the
  // same bits from run to run)
  if (blockIdx.x == 0) {
    double s = 0.0;
    for (int i = tid; i < P.L; i += nthreads) s += __ldcg(P.eacc + i);
    red[tid] = s;
    __syncthreads();
    if (tid == 0) {
      double total = 0.0;
      for (int i = 0; i < nthreads; ++i) total += red[i];
      *P.energy = total;
    }
  }
}

// The block: DTL lanes x ny label rows, about LABELS_PER_THREAD labels a
// thread; the grid: as many blocks as the widest step has tiles, and no
// more than are resident at once (the cooperative launch refuses a larger
// grid).
template <int KERNEL>
cudaError_t launch(const Params& P, int* grid_out, cudaStream_t st) {
  const int rows = (P.K + LABELS_PER_THREAD - 1) / LABELS_PER_THREAD;
  dim3 block(DTL, rows < 1 ? 1 : (rows > MAX_Y ? MAX_Y : rows));
  const void* fn = (const void*)banded_decode_kernel<KERNEL>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fn, block.x * block.y, 0);
  if (err != cudaSuccess) return err;
  const int widest = (P.Bh < P.Bw ? P.Bh : P.Bw) * P.nb;
  long long grid = (widest + DTL - 1) / DTL;
  if ((long long)per_sm * sms < grid) grid = (long long)per_sm * sms;
  if (grid < 1) return cudaErrorLaunchOutOfResources;
  *grid_out = (int)grid;
  Params p = P;
  void* args[] = {(void*)&p};
  err = cudaLaunchCooperativeKernel(fn, dim3((unsigned)grid), block, args, 0,
                                    st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// ptrs: P_COUNT device pointers in the order of enum Ptr (a host array);
// dims: {K, H, W, Bh, Bw, Gy, Gx}; kernel: the smoothness kernel, 1 or 2;
// grid: out, the blocks of the launch.  Returns 0 or the CUDA error code.
extern "C" int banded_decode_f32(const void* const* ptrs, const int* dims,
                                 float tol, int kernel, int* grid,
                                 void* stream) {
  Params P;
#define FP(i) ((const float*)ptrs[i])
  P.theta = FP(P_THETA); P.D0 = FP(P_D0); P.QA = FP(P_QA); P.QB = FP(P_QB);
  P.aA = FP(P_AA); P.aB = FP(P_AB); P.vA = FP(P_VA); P.vB = FP(P_VB);
  P.pix = FP(P_PIX);
  P.PxL_q = FP(P_PXL_Q); P.PxL_d0 = FP(P_PXL_D0); P.PxL_a = FP(P_PXL_A);
  P.PyU_q = FP(P_PYU_Q); P.PyU_d0 = FP(P_PYU_D0); P.PyU_a = FP(P_PYU_A);
  P.vSxL = (const unsigned char*)ptrs[P_VSXL];
  P.vSxR = (const unsigned char*)ptrs[P_VSXR];
  P.MA = FP(P_MA); P.MB = FP(P_MB); P.SxL = FP(P_SXL); P.SxR = FP(P_SXR);
  P.SyU = FP(P_SYU); P.SyD = FP(P_SYD);
#undef FP
  P.sols = (int*)ptrs[P_SOLS];
  P.eacc = (double*)ptrs[P_EACC];
  P.labels = (int*)ptrs[P_LABELS];
  P.energy = (double*)ptrs[P_ENERGY];
  if (kernel != 1 && kernel != 2) return (int)cudaErrorInvalidValue;
  P.tol = tol;
  P.K = dims[0]; P.H = dims[1]; P.W = dims[2]; P.Bh = dims[3];
  P.Bw = dims[4]; P.Gy = dims[5]; P.Gx = dims[6];
  P.nb = P.Gy * P.Gx;
  P.L = P.Bh * P.nb;
  P.Lp = (P.Bh > P.Bw ? P.Bh : P.Bw) * P.nb;
  P.T = P.Bh + P.Bw - 1;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(kernel == 1 ? launch<1>(P, grid, st) : launch<2>(P, grid, st));
}
