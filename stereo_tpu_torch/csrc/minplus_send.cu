// The column send of the wavefront family of TRW-S schedules for NVIDIA
// Hopper (sm_90a), float32: every send of one solver step in one launch.
// Replaces the TPU kernel stereo_tpu/ops/minplus.py::_send_kernel.
//
// A launch takes up to MAX_PROBLEMS problems that share K, tol and the
// smoothness kernel.  For problem q, its batch entry b and lane l:
//
//   msg[b][t][l] = min_s ( h[b][s][l] + alpha[b][l] * TR(xt[b][t][l] - ys[b][s][l]) )
//                  - vmin[b][l],                               t, s < K
//   vmin[b][l]   = min over t of the un-normalised msg
//   h            = g - m   (or g, where the problem has no m)
//
// Each problem has its own lane count L and batch count B, and every input
// its own batch and label strides in floats (a batch stride of 0 is a
// broadcast operand); lanes are contiguous.  msg is [B, K, L] and vmin
// [B, L], contiguous.  The problems reach the kernel as one by-value
// parameter (a few hundred bytes, no copy to the device), with a prefix
// table of their jobs: a job is one tile of TILE lanes of one batch entry.
//
// Plain C interface (loaded with ctypes): raw device pointers in an int64
// descriptor array and a CUDA stream; launches on that stream without
// synchronising, allocates nothing, returns the launch's error code.  Built
// with -fmad=false (ops/_build.py), so the result equals the plain PyTorch
// version's bit for bit.
//
// The truncation is taken out of the K^2 loop as in csrc/phase_kernel.cu:
// rounding is monotone, so for a >= 0 (-0.0 included)
//
//   min_s (h + a * min(c, tol)) = min( min_s (h + a * c), min_s (h + a * tol) )
//
// bit for bit, and a term is sub, mul (|.| is an operand modifier), add, min:
// four issued float32 instructions (kernel 2: five).  A lane whose
// `a >= 0.0f` is false (a < 0, where the identity fails, or a NaN) walks the
// plain term, truncation inside.
//
// What bounds it: K^2 terms per lane.  A banded step at teddy K = 79 (six
// problems, 12,288 lanes) is 7.7e7 terms, about 9 us at four issued
// instructions a term on 132 SMs; its operands read once and its outputs
// written once take about 5 us at 3.35 TB/s.  Six launches of a one-problem
// kernel cost six times the host's launch path, which is what the step
// paths lost their time to.
//
// Design: a block covers a tile of TILE = 32 lanes (threadIdx.x) and its
// targets in groups of KT per thread (threadIdx.y; a thread holds its
// targets' positions and running minima in registers).  The tile's sources
// (g, m, ys) are copied into shared memory CHUNK at a time with cp.async,
// double-buffered; the thread that copied an element turns it into
// h = g - m beside ys (one 64-bit load a source in the walk) and folds it
// into its part of min_s (h + a * tol).  The minimum over the targets is
// reduced across threadIdx.y and every output is written once, normalised,
// from registers.  No K is refused: above MAX_GROUPS groups the targets are
// walked in passes (earlier passes written un-normalised and corrected once
// the minimum is known), and the staging area does not grow with K.
//
// A launch with fewer than two jobs per SM (a raster-wavefront step: 48
// tiles) would leave most SMs idle, so its tiles are split over a thread
// block cluster of 2 or 4 blocks on neighbouring SMs, each with KT_SPLIT
// targets a thread: every block of the cluster stages all the sources,
// walks its share of the targets, and the minimum over the targets is
// reduced across the cluster through distributed shared memory; then each
// block writes its own outputs.

#include <cooperative_groups.h>

#include "minplus.cuh"

namespace cg = cooperative_groups;

namespace {

using minplus::TILE;
using minplus::block_min_over_y;
using minplus::trunc_cost;

constexpr int MAX_PROBLEMS = 8;  // problems of one launch at most
constexpr int DESC_WORDS = 18;   // int64 words of a problem's descriptor
constexpr int KT = 20;           // targets a thread holds, one block a tile
constexpr int KT_SPLIT = 5;      // the same where a cluster shares a tile
constexpr int MAX_GROUPS = 8;    // warps of targets per block at most
constexpr int CHUNK = 32;        // sources per staged chunk
constexpr int MAX_CLUSTER = 4;   // blocks sharing a tile at most
static_assert(MAX_GROUPS <= minplus::MAX_TB, "block_min_over_y's rows");

struct Problem {
  const float* g;      // [B, K, L] source beliefs (or the heights h)
  const float* m;      // [B, K, L] subtracted from g; nullptr: none
  const float* xt;     // [B, K, L] target positions
  const float* ys;     // [B, K, L] source positions
  const float* alpha;  // [B, L]
  float* msg;          // [B, K, L], contiguous
  float* vmin;         // [B, L], contiguous
  long long g_b, g_k, m_b, m_k, xt_b, xt_k, ys_b, ys_k, a_b;  // strides
  int L, B;
};

struct Launch {
  Problem p[MAX_PROBLEMS];
  int job0[MAX_PROBLEMS + 1];  // first job of each problem; job0[n]: all
  int n, K, cluster;
  float tol;
};

// acc[u] = min(acc[u], h + a * c(xr[u] - y)) over n staged (h, y) pairs, c
// the hoisted |.|^kernel (HOIST) or the truncated cost.
template <int KERNEL, bool HOIST, int KTT>
__device__ __forceinline__ void walk(const float2* hy, int n,
                                     const float (&xr)[KTT], float a,
                                     float tol, float (&acc)[KTT]) {
#pragma unroll 2
  for (int s = 0; s < n; ++s) {
    const float2 v = hy[s * TILE];
#pragma unroll
    for (int u = 0; u < KTT; ++u) {
      float c;
      if (HOIST) {
        const float d = xr[u] - v.y;
        c = (KERNEL == 1) ? fabsf(d) : d * d;
      } else {
        c = trunc_cost<KERNEL>(xr[u], v.y, tol);
      }
      acc[u] = fminf(acc[u], v.x + a * c);
    }
  }
}

// block (TILE, ny) of cluster rank `rank` (of A.cluster) does job
// blockIdx.x / A.cluster: the sends of TILE lanes of one batch entry.
template <int KERNEL, int KTT>
__global__ void __launch_bounds__(MAX_GROUPS * TILE)
minplus_send_kernel(const __grid_constant__ Launch A) {
  // buffer, source s of the chunk, lane x: (g then h, ys) at [s][x], m apart
  __shared__ __align__(16) float hy[2][CHUNK * TILE * 2];
  __shared__ float ms[2][CHUNK * TILE];
  __shared__ float sm[minplus::MAX_TB][TILE];
  __shared__ float xch[TILE];
  const int C = A.cluster, K = A.K;
  const int job = blockIdx.x / C, rank = blockIdx.x % C;
  int q = 0;
  while (q + 1 < A.n && job >= A.job0[q + 1]) ++q;  // uniform
  const Problem& P = A.p[q];
  const int ny = blockDim.y, ty = threadIdx.y, x = threadIdx.x;
  const int per_b = (P.L + TILE - 1) / TILE, local = job - A.job0[q];
  const long long b = local / per_b;
  const int lane = (local % per_b) * TILE + x;
  const bool in = lane < P.L;
  const long long l = in ? lane : P.L - 1;  // a missing lane loads the last
  const bool sub = P.m != nullptr;  // uniform
  const float* g = P.g + b * P.g_b + l;
  const float* m = sub ? P.m + b * P.m_b + l : nullptr;
  const float* xt = P.xt + b * P.xt_b + l;
  const float* ys = P.ys + b * P.ys_b + l;
  const long long gk = P.g_k, mk = P.m_k, xk = P.xt_k, yk = P.ys_k;
  const long long ok = P.L;
  float* out = P.msg + b * K * ok + l;
  const float a = P.alpha[b * P.a_b + l], tol = A.tol;
  const bool hoist = a >= 0.0f;  // false for a < 0 (and a NaN)
  const float at = hoist ? a * tol : CUDART_INF_F;
  const int chunk = min(K, CHUNK), nchunks = (K + chunk - 1) / chunk;
  const int gv = ny * C;  // warps of targets of a pass, over the cluster
  const int npass = ((K + KTT - 1) / KTT + gv - 1) / gv;

  // the copies of chunk c into buffer c & 1: thread (x, ty) copies sources
  // ty, ty + ny, .. of its lane
  auto issue = [&](int c) {
    const int s0 = c * chunk, n = min(chunk, K - s0), bf = c & 1;
    for (int s = ty; s < n; s += ny) {
      const int i = s * TILE + x;
      const long long src = s0 + s;
      __pipeline_memcpy_async(&hy[bf][2 * i], g + src * gk, sizeof(float));
      __pipeline_memcpy_async(&hy[bf][2 * i + 1], ys + src * yk,
                              sizeof(float));
      if (sub)
        __pipeline_memcpy_async(&ms[bf][i], m + src * mk, sizeof(float));
    }
    __pipeline_commit();
  };
  float far = CUDART_INF_F;   // this thread's part of min_s h[s] + a * tol
  float part = CUDART_INF_F;  // min over this thread's targets
  float xr[KTT], acc[KTT];
  int t0 = 0;
  for (int p = 0; p < npass; ++p) {
    if (p > 0) __syncthreads();  // the last pass's chunks are walked
    t0 = (p * gv + rank * ny + ty) * KTT;
    const bool walks = t0 < K;  // uniform over a warp
    issue(0);
    if (walks) {
#pragma unroll
      for (int u = 0; u < KTT; ++u) {
        xr[u] = xt[min(t0 + u, K - 1) * xk];  // ragged: target K - 1 again
        acc[u] = CUDART_INF_F;
      }
    }
    for (int c = 0; c < nchunks; ++c) {
      const int n = min(chunk, K - c * chunk), bf = c & 1;
      // the thread's own copies of chunk c have landed: h = g - m
      __pipeline_wait_prior(0);
      for (int s = ty; s < n; s += ny) {
        const int i = s * TILE + x;
        float h = hy[bf][2 * i];
        if (sub) {
          h = h - ms[bf][i];
          hy[bf][2 * i] = h;
        }
        far = fminf(far, h + at);
      }
      // chunk c is complete for the block and chunk c - 1 walked by all:
      // its buffer takes chunk c + 1
      __syncthreads();
      if (c + 1 < nchunks) issue(c + 1);
      if (walks) {
        const float2* v = reinterpret_cast<const float2*>(hy[bf]) + x;
        if (hoist) walk<KERNEL, true>(v, n, xr, a, tol, acc);
        else walk<KERNEL, false>(v, n, xr, a, tol, acc);
      }
    }
    if (walks) {
#pragma unroll
      for (int u = 0; u < KTT; ++u) part = fminf(part, acc[u]);
      if (p + 1 < npass && in) {  // written again once vmin is known
#pragma unroll
        for (int u = 0; u < KTT; ++u)
          if (t0 + u < K) out[(t0 + u) * ok] = acc[u];
      }
    }
  }
  // every block of a cluster staged all K sources: its `far` is complete
  far = block_min_over_y(far, sm);
  float vmin = block_min_over_y(fminf(part, far), sm);
  if (C > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    if (ty == 0) xch[x] = vmin;
    cluster.sync();
    for (int r = 0; r < C; ++r)
      vmin = fminf(vmin, cluster.map_shared_rank(xch, r)[x]);
    cluster.sync();  // no block leaves while another reads its xch
  }
  if (!in) return;
  for (int p = 0; p + 1 < npass; ++p) {
    const int t = (p * gv + rank * ny + ty) * KTT;
    for (int u = 0; u < KTT && t + u < K; ++u) {
      float* o = out + (t + u) * ok;
      *o = fminf(*o, far) - vmin;
    }
  }
  if (t0 < K) {
#pragma unroll
    for (int u = 0; u < KTT; ++u)
      if (t0 + u < K) out[(t0 + u) * ok] = fminf(acc[u], far) - vmin;
  }
  if (ty == 0 && rank == 0) P.vmin[b * P.L + l] = vmin;
}

// Multiprocessors of the current device, asked once per device.
int sm_count(int* sms) {
  static int cache[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && cache[dev] > 0) {
    *sms = cache[dev];
    return 0;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < 64) cache[dev] = *sms;
  return (int)err;
}

// Warps of a block of a cluster of C for K labels at KTT targets a thread:
// the fewest passes of at most MAX_GROUPS * C warps, the target groups spread
// evenly over the passes and the blocks.
int warps_for(int K, int KTT, int C) {
  const int groups = (K + KTT - 1) / KTT;
  const int passes = (groups + MAX_GROUPS * C - 1) / (MAX_GROUPS * C);
  const int per_pass = (groups + passes - 1) / passes;
  return (per_pass + C - 1) / C;
}

template <int KTT>
int launch(const Launch& A, long long jobs, int kernel, cudaStream_t st) {
  const int C = A.cluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(jobs * C));
  cfg.blockDim = dim3(TILE, warps_for(A.K, KTT, C));
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  cudaError_t err =
      kernel == 1 ? cudaLaunchKernelEx(&cfg, minplus_send_kernel<1, KTT>, A)
                  : cudaLaunchKernelEx(&cfg, minplus_send_kernel<2, KTT>, A);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// desc: n problems of DESC_WORDS int64 each, in the order of Problem's
// fields (the seven pointers, the nine strides, L, B).  Returns 0 or the
// CUDA error code; nothing is launched when there is no lane.
extern "C" int minplus_send_many_f32(const long long* desc, int n, float tol,
                                     int kernel, int K, void* stream) {
  if (n < 1 || n > MAX_PROBLEMS || K < 1 || (kernel != 1 && kernel != 2))
    return (int)cudaErrorInvalidValue;
  Launch A = {};
  A.n = n;
  A.K = K;
  A.tol = tol;
  long long jobs = 0;
  for (int i = 0; i < n; ++i) {
    const long long* d = desc + i * DESC_WORDS;
    Problem& p = A.p[i];
    p.g = (const float*)d[0];
    p.m = (const float*)d[1];
    p.xt = (const float*)d[2];
    p.ys = (const float*)d[3];
    p.alpha = (const float*)d[4];
    p.msg = (float*)d[5];
    p.vmin = (float*)d[6];
    p.g_b = d[7];
    p.g_k = d[8];
    p.m_b = d[9];
    p.m_k = d[10];
    p.xt_b = d[11];
    p.xt_k = d[12];
    p.ys_b = d[13];
    p.ys_k = d[14];
    p.a_b = d[15];
    if (d[16] < 0 || d[17] < 0 || d[16] > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    p.L = (int)d[16];
    p.B = (int)d[17];
    A.job0[i] = (int)jobs;
    jobs += (long long)p.B * ((p.L + TILE - 1) / TILE);
    if (jobs * MAX_CLUSTER > 0x7fffffffLL)
      return (int)cudaErrorInvalidConfiguration;
  }
  A.job0[n] = (int)jobs;
  if (jobs == 0) return 0;
  // fewer than two jobs an SM: split each tile's targets over a cluster
  int sms = 0;
  const int err = sm_count(&sms);
  if (err != 0) return err;
  int C = 1;
  if (jobs < 2LL * sms) {
    const long long want = (2LL * sms + jobs - 1) / jobs;
    const int groups = (K + KT_SPLIT - 1) / KT_SPLIT;
    while (C * 2 <= MAX_CLUSTER && C * 2 <= want && C * 2 <= groups) C *= 2;
  }
  A.cluster = C;
  cudaStream_t st = (cudaStream_t)stream;
  return C > 1 ? launch<KT_SPLIT>(A, jobs, kernel, st)
               : launch<KT>(A, jobs, kernel, st);
}
