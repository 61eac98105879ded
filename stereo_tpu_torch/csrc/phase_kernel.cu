// Checkerboard TRW-S phase kernels for NVIDIA Hopper (sm_90a), float32.
//
// Plain C interface (loaded with ctypes): every function takes raw device
// pointers and a CUDA stream, launches on that stream without synchronising,
// allocates nothing, and returns cudaGetLastError() as an int.
//
// Build (see ops/_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC -o libphase_kernel.so phase_kernel.cu
//
// -fmad=false keeps h + a * c as a separate multiply and add, so every value
// equals the plain PyTorch version's bit for bit (min, abs and the
// subtraction are exact or identically rounded).
//
// Both kernels share one device routine, the "send": for one pixel and one
// directed edge family,
//
//     out[t] = min_s ( (g[s] - m[s]) + a * TR(xt[t], ys[s]) ),   t, s < K
//
// followed by subtraction of min_t out[t] and the border mask.  Variant B of
// the TRW-S phase (the head pixel is the phase's source) has targets t = the
// tail's label i with xt = Q and sources s = the head's label j with ys = D0;
// variant A (the tail is the source) has targets t = j with xt = D0 and
// sources s = i with ys = Q.  TR(q, d0) = min(|q - d0|^kernel, tol).
//
// The truncation is taken out of the K^2 loop.  Rounding is monotone, so for
// a >= 0 (-0.0 included) fl(a * min(c, tol)) = min(fl(a * c), fl(a * tol))
// and fl(h + min(A, B)) = min(fl(h + A), fl(h + B)); hence
//
//     out[t] = min( min_s (h[s] + a * |xt[t] - ys[s]|^kernel), far ),
//     far    = min_s (h[s] + a * tol),
//
// the same bits, with `far` K operations per pixel instead of a term of the
// K^2 loop.  A term is then sub, mul (|.| is an operand modifier), add, min:
// four issued float32 instructions (kernel 2: five, the square is a mul), of
// which only the min is on the half-rate pipe.  With a < 0 the identity
// fails (the min becomes a max), so a pixel whose `a >= 0.0f` is false walks
// the plain term, truncation inside; the branch is per pixel and uniform on
// every solver path, whose alphas are >= 0.
//
// Layout: every array is [.., K, P] with the P pixels of a plane contiguous.
// A block covers a tile of TILE = 32 pixels (threadIdx.x) and the K targets
// in groups of KT (threadIdx.y; a thread keeps its KT running minima and
// target positions in registers).  Above MAX_GROUPS groups the targets are
// walked in passes.  The tile's sources (g, m, ys) are copied into shared
// memory CHUNK sources at a time with cp.async, double-buffered: chunk c + 1
// is in flight while chunk c is walked.  The thread that copied an element
// also turns it into h = g - m (once per source and pixel), stored beside ys
// so that the walk reads the pair (h, y) with one 64-bit load, and folds it
// into its part of `far`.  So every input plane is read from device memory once
// per pass (once for K <= MAX_GROUPS * KT), and every output once: the
// minimum over the targets is reduced across threadIdx.y in shared memory
// and each thread writes (min(acc, far) - vmin) * valid from its registers.
// K and P are runtime arguments; a ragged tile's missing pixels load a
// valid pixel's data and write nothing, a ragged target group recomputes
// target K - 1 and does not write it.  The eight blocks of a tile (four
// directions, two variants or colours) are neighbours in the grid, so what
// they share, and the half of each sector a colour leaves, comes from L2.
//
// What bounds it on an H100 (replacing stereo_tpu/ops/phase_kernel.py's
// _kernel_compact and _kernel): K^2 terms per pixel and direction.  At K = 79
// the compact launch does 8 x 84,600 x 79^2 = 4.22e9 of them; at one issued
// float32 instruction per lane and cycle (132 SMs x 128 lanes x 1.98 GHz)
// four instructions a term take at least 0.505 ms (the operation bound at the
// float32 FMA peak that chip_smoke.py reports counts six a term: 0.378 ms).
// Its (31 K + 24) planes of traffic take 0.25 ms at 3.35 TB/s.  At K = 15 the
// bytes are the larger bound.

#include "minplus.cuh"

namespace {

using minplus::TILE;
using minplus::block_min_over_y;
using minplus::trunc_cost;

constexpr int KT = 20;          // targets a thread holds in registers
constexpr int MAX_GROUPS = 8;   // warps of targets per block at most
constexpr int CHUNK = 32;       // sources per staged chunk
// blocks of MAX_GROUPS warps resident per multiprocessor: ptxas keeps a
// thread to 80 registers (113 unbounded), so that six blocks of four warps
// (K = 79) fit where four did
constexpr int MIN_BLOCKS = 3;
static_assert(MAX_GROUPS <= minplus::MAX_TB, "block_min_over_y's rows");

// Warps of a block for K labels: ceil(K / KT) up to MAX_GROUPS, else the
// fewest passes of MAX_GROUPS warps at most, the groups spread evenly.
int groups_for(int K) { return minplus::blocks_for<KT, MAX_GROUPS>(K); }

// Dynamic shared memory of a block: two buffers of chunk x TILE sources,
// each (g then h, ys) interleaved and m apart.
size_t stage_bytes(int K) {
  return 2 * 3 * (size_t)(K < CHUNK ? K : CHUNK) * TILE * sizeof(float);
}

// The calling thread's pixel: its operands, already offset to the pixel
// (label planes `stride` floats apart), and what it writes.
struct Lane {
  const float* g;   // [K] source beliefs
  const float* m;   // [K] messages subtracted from them
  const float* xt;  // [K] target positions
  const float* ys;  // [K] source positions
  float* out;       // [K] the normalised message
  float* vmin;      // its minimum
  float a, valid;
  bool in;          // the pixel exists (else: loads only, no writes)
  bool tq;          // the targets are the tail's positions Q (variant B)
};

// acc[u] = min(acc[u], h + a * c(xr[u], y)) over n staged sources, c the
// hoisted |x - y|^kernel (HOIST) or the truncated cost.  TQ: the target is
// the first operand (Q first, as the plain version subtracts).
template <int KERNEL, bool TQ, bool HOIST>
__device__ __forceinline__ void walk(const float2* hy, int n,
                                     const float (&xr)[KT], float a,
                                     float tol, float (&acc)[KT]) {
#pragma unroll 2
  for (int s = 0; s < n; ++s) {
    const float2 v = hy[s * TILE];
    const float h = v.x;
    const float y = v.y;
#pragma unroll
    for (int u = 0; u < KT; ++u) {
      float c;
      if (HOIST) {
        const float d = TQ ? xr[u] - y : y - xr[u];
        c = (KERNEL == 1) ? fabsf(d) : d * d;
      } else {
        c = TQ ? trunc_cost<KERNEL>(xr[u], y, tol)
               : trunc_cost<KERNEL>(y, xr[u], tol);
      }
      acc[u] = fminf(acc[u], h + a * c);
    }
  }
}

// One send for each pixel of the block's tile, done together by the
// blockDim.y warps of the tile.  Every thread of the block must call it.
template <int KERNEL>
__device__ __forceinline__ void send_tile(const Lane& L, float tol, int K,
                                          long long stride) {
  extern __shared__ float stage[];  // 2 x ([chunk][TILE][2] + [chunk][TILE])
  __shared__ float sm[minplus::MAX_TB][TILE];
  const int ny = blockDim.y, ty = threadIdx.y, x = threadIdx.x;
  const int chunk = min(K, CHUNK), nchunks = (K + chunk - 1) / chunk;
  const int npass = ((K + KT - 1) / KT + ny - 1) / ny;
  const bool hoist = L.a >= 0.0f;  // false for a < 0 (and a NaN)
  const float at = hoist ? L.a * tol : CUDART_INF_F;
  // buffer b, source s of the chunk: k = 0 g (then h), 1 m, 2 ys
  auto slot = [&](int b, int k, int s) -> float* {
    float* base = stage + b * 3 * chunk * TILE;
    return k == 1 ? base + 2 * chunk * TILE + s * TILE + x
                  : base + (s * TILE + x) * 2 + (k == 2);
  };
  // issue the copies of chunk c into buffer c & 1: thread (x, ty) copies
  // sources ty, ty + ny, .. of its pixel x
  auto issue = [&](int c) {
    const int s0 = c * chunk, n = min(chunk, K - s0), b = c & 1;
    for (int s = ty; s < n; s += ny) {
      const long long off = (long long)(s0 + s) * stride;
      __pipeline_memcpy_async(slot(b, 0, s), L.g + off, sizeof(float));
      __pipeline_memcpy_async(slot(b, 1, s), L.m + off, sizeof(float));
      __pipeline_memcpy_async(slot(b, 2, s), L.ys + off, sizeof(float));
    }
    __pipeline_commit();
  };
  float far = CUDART_INF_F;   // this thread's part of min_s h[s] + a * tol
  float part = CUDART_INF_F;  // min over this thread's targets
  float xr[KT], acc[KT];
  int t0 = 0;
  for (int p = 0; p < npass; ++p) {
    if (p > 0) __syncthreads();  // the last pass's chunks are walked
    t0 = (p * ny + ty) * KT;
    const bool walks = t0 < K;  // uniform over a warp
    issue(0);
    if (walks) {
#pragma unroll
      for (int u = 0; u < KT; ++u) {
        xr[u] = L.xt[min(t0 + u, K - 1) * stride];  // ragged: K - 1 again
        acc[u] = CUDART_INF_F;
      }
    }
    for (int c = 0; c < nchunks; ++c) {
      const int n = min(chunk, K - c * chunk), b = c & 1;
      // the thread's own copies of chunk c have landed: h = g - m in g's slot
      __pipeline_wait_prior(0);
      for (int s = ty; s < n; s += ny) {
        const float h = *slot(b, 0, s) - *slot(b, 1, s);
        *slot(b, 0, s) = h;
        far = fminf(far, h + at);
      }
      // chunk c is complete for the block, and chunk c - 1 walked by all:
      // its buffer takes chunk c + 1
      __syncthreads();
      if (c + 1 < nchunks) issue(c + 1);
      if (walks) {
        const float2* hS = reinterpret_cast<const float2*>(slot(b, 0, 0));
        if (L.tq) {
          if (hoist) walk<KERNEL, true, true>(hS, n, xr, L.a, tol, acc);
          else walk<KERNEL, true, false>(hS, n, xr, L.a, tol, acc);
        } else {
          if (hoist) walk<KERNEL, false, true>(hS, n, xr, L.a, tol, acc);
          else walk<KERNEL, false, false>(hS, n, xr, L.a, tol, acc);
        }
      }
    }
    if (walks) {
#pragma unroll
      for (int u = 0; u < KT; ++u) part = fminf(part, acc[u]);
      if (p + 1 < npass && L.in) {  // written again once vmin is known
#pragma unroll
        for (int u = 0; u < KT; ++u)
          if (t0 + u < K) L.out[(t0 + u) * stride] = acc[u];
      }
    }
  }
  far = block_min_over_y(far, sm);
  const float vmin = block_min_over_y(fminf(part, far), sm);
  if (!L.in) return;
  for (int p = 0; p + 1 < npass; ++p) {
    const int t = (p * ny + ty) * KT;
    for (int u = 0; u < KT && t + u < K; ++u) {
      float* o = L.out + (t + u) * stride;
      *o = (fminf(*o, far) - vmin) * L.valid;
    }
  }
  if (t0 < K) {
#pragma unroll
    for (int u = 0; u < KT; ++u)
      if (t0 + u < K)
        L.out[(t0 + u) * stride] = (fminf(acc[u], far) - vmin) * L.valid;
  }
  if (ty == 0) *L.vmin = vmin;
}

// Compact phase.  Block 8 * tile + 2 * d + variant: the eight sends of a
// tile run side by side, so the arrays they share (gD, D0s, D0o) come from
// L2 after the first.  block = (TILE, groups_for(K)).
template <int KERNEL>
__global__ void __launch_bounds__(MAX_GROUPS * TILE, MIN_BLOCKS)
phase_compact_kernel(const float* __restrict__ gD,   // [K, P]
                     const float* __restrict__ gDn,  // [4, K, P]
                     const float* __restrict__ Ms,   // [4, K, P]
                     const float* __restrict__ Mo,   // [4, K, P]
                     const float* __restrict__ Qs,   // [4, K, P]
                     const float* __restrict__ Qo,   // [4, K, P]
                     const float* __restrict__ D0s,  // [K, P]
                     const float* __restrict__ D0o,  // [K, P]
                     const float* __restrict__ as,   // [4, P]
                     const float* __restrict__ ao,   // [4, P]
                     const float* __restrict__ vs,   // [4, P]
                     const float* __restrict__ vo,   // [4, P]
                     float* __restrict__ newMs,      // [4, K, P]
                     float* __restrict__ newMo,      // [4, K, P]
                     float* __restrict__ vmins,      // [4, P]
                     float* __restrict__ vmino,      // [4, P]
                     float tol, int K, long long P) {
  const long long q = (long long)(blockIdx.x >> 3) * TILE + threadIdx.x;
  const long long p = q < P ? q : P - 1;  // a missing pixel loads the last
  const int d = (blockIdx.x & 7) >> 1;
  const long long dk = (long long)d * K * P + p;  // into a [4, K, P] array
  const long long dp = (long long)d * P + p;      // into a [4, P] array
  const bool in = q < P;
  Lane L;
  if (!(blockIdx.x & 1)) {
    // s-heads: msg[i] = min_j (gD[j] - Ms[d][j]) + a * TR(Qs[d][i], D0s[j])
    L = Lane{gD + p, Ms + dk, Qs + dk, D0s + p, newMs + dk, vmins + dp,
             as[dp], vs[dp], in, true};
  } else {
    // o-heads: msg[j] = min_i (gDn[d][i] - Mo[d][i]) + a * TR(Qo[d][i], D0o[j])
    L = Lane{gDn + dk, Mo + dk, D0o + p, Qo + dk, newMo + dk, vmino + dp,
             ao[dp], vo[dp], in, false};
  }
  send_tile<KERNEL>(L, tol, K, P);
}

// Full-grid phase.  Both variants exist at every pixel and the mask
// src_is_head picks one; a thread evaluates only the picked one.  With the
// checkerboard mask neighbouring pixels alternate, which would split every
// warp between the two branches, so threads are laid out by colour: lane r
// of colour c handles row y = r / Wh, column x = 2 * (r % Wh) + ((y + c) & 1)
// (Wh = ceil(W / 2)); a warp then holds one colour and takes one branch (its
// loads are at stride 2).  Any other mask is still computed correctly, with
// divergence.  Block 8 * tile + 2 * d + c: both colours of a tile run side
// by side, so the sectors one reads half of come from L2 for the other, as
// do gD and D0 for the four directions.  block = (TILE, groups_for(K)).
template <int KERNEL>
__global__ void __launch_bounds__(MAX_GROUPS * TILE, MIN_BLOCKS)
phase_full_kernel(const float* __restrict__ gD,     // [K, P]
                  const float* __restrict__ gDs,    // [4, K, P]
                  const float* __restrict__ M,      // [4, K, P]
                  const float* __restrict__ Q,      // [4, K, P]
                  const float* __restrict__ D0,     // [K, P]
                  const float* __restrict__ alphas, // [4, P]
                  const float* __restrict__ srcm,   // [P]
                  const float* __restrict__ valid,  // [4, P]
                  float* __restrict__ newM,         // [4, K, P]
                  float* __restrict__ vmins,        // [4, P]
                  float tol, int K, int H, int W) {
  const int Wh = (W + 1) >> 1;
  const long long r = (long long)(blockIdx.x >> 3) * TILE + threadIdx.x;
  const int d = (blockIdx.x & 7) >> 1;
  const int c = blockIdx.x & 1;
  const int y = (int)(r / Wh);
  const int x = 2 * (int)(r % Wh) + ((y + c) & 1);
  const bool in = r < (long long)H * Wh && x < W;
  const long long P = (long long)H * W;
  const long long p = in ? (long long)y * W + x : 0;  // missing: pixel 0
  const long long dk = (long long)d * K * P + p;
  const long long dp = (long long)d * P + p;
  Lane L;
  if (srcm[p] != 0.0f) {
    // head is the source (variant B): msg[i] = min_j (gD[j] - M[j]) + a TR
    L = Lane{gD + p, M + dk, Q + dk, D0 + p, newM + dk, vmins + dp,
             alphas[dp], valid[dp], in, true};
  } else {
    // tail is the source (variant A): msg[j] = min_i (gDs[i] - M[i]) + a TR
    L = Lane{gDs + dk, M + dk, D0 + p, Q + dk, newM + dk, vmins + dp,
             alphas[dp], valid[dp], in, false};
  }
  send_tile<KERNEL>(L, tol, K, P);
}

// Launch kernel<1> or kernel<2>: 8 blocks of (TILE, groups_for(K)) threads
// a tile, the staging buffers in dynamic shared memory.
template <typename... Params, typename... Args>
int launch(void (*k1)(Params...), void (*k2)(Params...), int kernel, int K,
           long long tiles, void* stream, Args... args) {
  if (tiles * 8 > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)(tiles * 8)), block(TILE, groups_for(K));
  cudaStream_t st = (cudaStream_t)stream;
  (kernel == 1 ? k1 : k2)<<<grid, block, stage_bytes(K), st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int phase_messages_compact_f32(
    const float* gD, const float* gDn, const float* Ms, const float* Mo,
    const float* Qs, const float* Qo, const float* D0s, const float* D0o,
    const float* as, const float* ao, const float* vs, const float* vo,
    float* newMs, float* newMo, float* vmins, float* vmino, float tol,
    int kernel, int K, long long P, void* stream) {
  return launch(phase_compact_kernel<1>, phase_compact_kernel<2>, kernel, K,
                (P + TILE - 1) / TILE, stream, gD, gDn, Ms, Mo, Qs, Qo, D0s,
                D0o, as, ao, vs, vo, newMs, newMo, vmins, vmino, tol, K, P);
}

extern "C" int phase_messages_f32(
    const float* gD, const float* gDs, const float* M, const float* Q,
    const float* D0, const float* alphas, const float* srcm,
    const float* valid, float* newM, float* vmins, float tol, int kernel,
    int K, int H, int W, void* stream) {
  const long long n = (long long)H * ((W + 1) / 2);
  return launch(phase_full_kernel<1>, phase_full_kernel<2>, kernel, K,
                (n + TILE - 1) / TILE, stream, gD, gDs, M, Q, D0, alphas,
                srcm, valid, newM, vmins, tol, K, H, W);
}
