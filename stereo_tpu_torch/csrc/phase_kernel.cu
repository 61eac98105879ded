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
// -fmad=false keeps h + a * TR(.) as a separate multiply and add, so every
// value equals the plain PyTorch version's bit for bit (min, abs and the
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
// Layout: every array is [.., K, P] with the P = rows * W pixels of a plane
// contiguous, so thread p of a warp reads address base + k * P + p: fully
// coalesced for every label plane k.  A thread owns one pixel of one
// direction; K and P are runtime arguments; the ragged last block is masked.
//
// What bounds it on an H100: K^2 min-plus steps per pixel and direction, six
// float32 instructions each (sub, abs or mul, min, mul, add, min), against
// (31 K + 24) planes of traffic for the compact phase and (18 K + 13) for
// the full grid: at K = 79 the arithmetic bound is ~1.5x the byte bound, at
// K = 15 the byte bound is the larger.  The design keeps KT running minima
// and their target positions in registers and walks the K sources once per
// target block, so each source triple (g, m, ys) is fetched ceil(K / KT)
// times, from L1/L2 after the first pass.  KT is picked per launch from K
// (pick_kt below): a large block re-reads the sources less often, a small
// one wastes less work on the ragged last block.

#include "minplus.cuh"

namespace {

using minplus::trunc_cost;

constexpr int THREADS = 128;  // threads per block, along the pixel axis
// Register-block sizes (targets held per pass over the sources); pick_kt
// below chooses one of the two per launch from K.
constexpr int KT_SMALL = 16;
constexpr int KT_LARGE = 40;

// One send for the calling thread's pixel.  All pointers are already offset
// to the pixel; label planes are `stride` floats apart.  TARGET_IS_Q tells
// which of (xt, ys) is the tail's position Q (the first argument of TR).
// KT: targets held in registers per pass over the sources.
template <int KERNEL, bool TARGET_IS_Q, int KT>
__device__ __forceinline__ void send(const float* __restrict__ g,
                                     const float* __restrict__ m,
                                     const float* __restrict__ xt,
                                     const float* __restrict__ ys, float a,
                                     float valid, float tol, int K,
                                     long long stride,
                                     float* __restrict__ out,
                                     float* __restrict__ vmin_out) {
  float vmin = CUDART_INF_F;
  for (int t0 = 0; t0 < K; t0 += KT) {
    float x[KT];
    float acc[KT];
#pragma unroll
    for (int u = 0; u < KT; ++u) {
      int t = min(t0 + u, K - 1);  // ragged tail: recompute the last target
      x[u] = xt[t * stride];
      acc[u] = CUDART_INF_F;
    }
    for (int s = 0; s < K; ++s) {
      float h = g[s * stride] - m[s * stride];
      float y = ys[s * stride];
#pragma unroll
      for (int u = 0; u < KT; ++u) {
        float tr = TARGET_IS_Q ? trunc_cost<KERNEL>(x[u], y, tol)
                               : trunc_cost<KERNEL>(y, x[u], tol);
        float term = a * tr;
        acc[u] = fminf(acc[u], h + term);
      }
    }
#pragma unroll
    for (int u = 0; u < KT; ++u) {
      if (t0 + u < K) {
        out[(t0 + u) * stride] = acc[u];
        vmin = fminf(vmin, acc[u]);
      }
    }
  }
  // normalise and mask: the thread re-reads only what it wrote itself
  for (int t = 0; t < K; ++t) {
    out[t * stride] = (out[t * stride] - vmin) * valid;
  }
  *vmin_out = vmin;
}

// Compact phase.  grid = (ceil(P / THREADS), 8): blockIdx.y = 2 * d + variant.
template <int KERNEL, int KT>
__global__ void __launch_bounds__(THREADS)
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
  long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (p >= P) return;
  int d = blockIdx.y >> 1;
  bool variant_a = blockIdx.y & 1;
  long long dk = (long long)d * K * P + p;  // offset into a [4, K, P] array
  long long dp = (long long)d * P + p;      // offset into a [4, P] array
  if (!variant_a) {
    // s-heads: msg[i] = min_j (gD[j] - Ms[d][j]) + a * TR(Qs[d][i], D0s[j])
    send<KERNEL, true, KT>(gD + p, Ms + dk, Qs + dk, D0s + p, as[dp], vs[dp],
                           tol, K, P, newMs + dk, vmins + dp);
  } else {
    // o-heads: msg[j] = min_i (gDn[d][i] - Mo[d][i]) + a * TR(Qo[d][i], D0o[j])
    send<KERNEL, false, KT>(gDn + dk, Mo + dk, D0o + p, Qo + dk, ao[dp],
                            vo[dp], tol, K, P, newMo + dk, vmino + dp);
  }
}

// Full-grid phase.  Both variants exist at every pixel and the mask
// src_is_head picks one; a thread evaluates only the picked one.  With the
// checkerboard mask neighbouring pixels alternate, which would split every
// warp between the two branches, so threads are laid out by colour: thread r
// of colour c handles row y = r / Wh, column x = 2 * (r % Wh) + ((y + c) & 1)
// (Wh = ceil(W / 2)); a warp then holds one colour and takes one branch.  Any
// other mask is still computed correctly, with divergence.
// grid = (ceil(H * Wh / THREADS), 8): blockIdx.y = 2 * d + c.
template <int KERNEL, int KT>
__global__ void __launch_bounds__(THREADS)
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
  int Wh = (W + 1) >> 1;
  long long r = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (r >= (long long)H * Wh) return;
  int d = blockIdx.y >> 1;
  int c = blockIdx.y & 1;
  int y = (int)(r / Wh);
  int x = 2 * (int)(r % Wh) + ((y + c) & 1);
  if (x >= W) return;
  long long P = (long long)H * W;
  long long p = (long long)y * W + x;
  long long dk = (long long)d * K * P + p;
  long long dp = (long long)d * P + p;
  if (srcm[p] != 0.0f) {
    // head is the source (variant B): msg[i] = min_j (gD[j] - M[j]) + a TR
    send<KERNEL, true, KT>(gD + p, M + dk, Q + dk, D0 + p, alphas[dp],
                           valid[dp], tol, K, P, newM + dk, vmins + dp);
  } else {
    // tail is the source (variant A): msg[j] = min_i (gDs[i] - M[i]) + a TR
    send<KERNEL, false, KT>(gDs + dk, M + dk, D0 + p, Q + dk, alphas[dp],
                            valid[dp], tol, K, P, newM + dk, vmins + dp);
  }
}

// The register-block size for K labels: the candidate that pads K the least,
// the larger one on a tie (K = 79 -> 40: two passes of 40; K <= 16 -> 16).
int pick_kt(int K) {
  int pad_small = (K + KT_SMALL - 1) / KT_SMALL * KT_SMALL;
  int pad_large = (K + KT_LARGE - 1) / KT_LARGE * KT_LARGE;
  return pad_large <= pad_small ? KT_LARGE : KT_SMALL;
}

}  // namespace

// Launch KERNEL_FN<kernel, kt> for the runtime (kernel, kt) pair.
#define PHASE_DISPATCH(KERNEL_FN, kernel, kt, ...)                            \
  do {                                                                        \
    if ((kernel) == 1 && (kt) == KT_LARGE)                                    \
      KERNEL_FN<1, KT_LARGE><<<grid, THREADS, 0, st>>>(__VA_ARGS__);          \
    else if ((kernel) == 1)                                                   \
      KERNEL_FN<1, KT_SMALL><<<grid, THREADS, 0, st>>>(__VA_ARGS__);          \
    else if ((kt) == KT_LARGE)                                                \
      KERNEL_FN<2, KT_LARGE><<<grid, THREADS, 0, st>>>(__VA_ARGS__);          \
    else                                                                      \
      KERNEL_FN<2, KT_SMALL><<<grid, THREADS, 0, st>>>(__VA_ARGS__);          \
  } while (0)

extern "C" int phase_messages_compact_f32(
    const float* gD, const float* gDn, const float* Ms, const float* Mo,
    const float* Qs, const float* Qo, const float* D0s, const float* D0o,
    const float* as, const float* ao, const float* vs, const float* vo,
    float* newMs, float* newMo, float* vmins, float* vmino, float tol,
    int kernel, int K, long long P, void* stream) {
  dim3 grid((unsigned)((P + THREADS - 1) / THREADS), 8);
  cudaStream_t st = (cudaStream_t)stream;
  PHASE_DISPATCH(phase_compact_kernel, kernel, pick_kt(K), gD, gDn, Ms, Mo,
                 Qs, Qo, D0s, D0o, as, ao, vs, vo, newMs, newMo, vmins, vmino,
                 tol, K, P);
  return (int)cudaGetLastError();
}

extern "C" int phase_messages_f32(
    const float* gD, const float* gDs, const float* M, const float* Q,
    const float* D0, const float* alphas, const float* srcm,
    const float* valid, float* newM, float* vmins, float tol, int kernel,
    int K, int H, int W, void* stream) {
  long long n = (long long)H * ((W + 1) / 2);
  dim3 grid((unsigned)((n + THREADS - 1) / THREADS), 8);
  cudaStream_t st = (cudaStream_t)stream;
  PHASE_DISPATCH(phase_full_kernel, kernel, pick_kt(K), gD, gDs, M, Q, D0,
                 alphas, srcm, valid, newM, vmins, tol, K, H, W);
  return (int)cudaGetLastError();
}
