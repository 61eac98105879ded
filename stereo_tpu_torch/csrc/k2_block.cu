// One block of binary fusion's K = 2 TRW-S in one launch, for NVIDIA Hopper
// (sm_90a), float32.  Replaces no TPU kernel: the JAX package writes the K = 2
// solver in plain jnp (stereo_tpu/solvers/binary.py), which XLA fuses on the
// TPU; in eager PyTorch the same block is some 2,700 small launches, and the
// host issuing them is what a fusion move waits for.
//
// What it computes: solvers/binary.py::_k2_block, the plain version, op for
// op: ``check_every`` pairs of _k2_phase (the black phase, then the white
// phase with its subtraction of the belief minimum before gamma), the bound
// (the last white phase's node and message minima plus the black pixels'
// belief minima under the final messages), _k2_decode (z_black from the
// beliefs, then each white pixel's conditioned argmin) and _k2_energy of the
// decoded labelling.
//
// Plain C interface (loaded with ctypes): raw device pointers and a CUDA
// stream; one cooperative launch on that stream, no synchronisation, no
// allocation (the wrapper hands in the scratch); returns the CUDA error code
// of the launch.  Built with -fmad=false (ops/_build.py): every term is added
// in the plain version's order, with its min and select choices, so the
// messages and the decoded labelling equal the plain version's bit for bit.
// The bound and the energy are summed per thread in double, reduced per block
// in a fixed tree and over the blocks in a fixed order by one block (no
// atomics: the same bits from run to run), and returned as float32; they
// agree with the plain version's float32 sums to their rounding.
//
// Design.  A block of the grid takes a tile of TH x TW pixels, one a thread;
// the grid is persistent (cudaLaunchCooperativeKernel, no larger than what is
// resident at once, which the launch would refuse) and walks the phases
// itself with one grid.sync() between them.  A phase reads its neighbours'
// beliefs, and a belief reads the neighbours' messages: two hops, so the
// messages are ping-ponged between two buffers (the input is never written,
// the last phase lands in the output).  Each tile computes the gamma-scaled
// beliefs of its pixels and of a 1-pixel halo into shared memory, then its
// pixels' four messages from them.  After the last phase: z_black and the
// black minima, a barrier, then the decode of the tile and its halo into
// shared memory and the energy of the tile's pixels; a barrier before one
// block sums the blocks' parts.  Messages written in one phase by other
// blocks are read past L1 (__ldcg); the problem's planes, which no phase
// writes, through the read-only path, and a block keeps its tile from phase
// to phase.
//
// What bounds it: a phase reads about 27 planes (theta, gamma, the
// checkerboard, the 16 pairwise tables, the 4 validity planes, the 4 message
// planes) and writes 4; a block's working set, about 20 MB at teddy's
// 375 x 450, sits in the card's 50 MB L2, so L2 and HBM bytes bound a phase
// (about 6 us at HBM speed) and its real cost is the 2 * check_every + 2
// grid barriers.  PERF.md has the times.

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TW = 32;  // tile columns: one warp a tile row
constexpr int TH = 8;   // tile rows
constexpr int NT = TW * TH;
constexpr int RW = TW + 2, RH = TH + 2;  // the tile with a 1-pixel halo
constexpr int HALO = 2 * RW + 2 * TH;    // the halo's pixels

// geometry.DIRS (dy, dx): left, right, up, down; OPP the opposite direction
__constant__ int DY[4] = {0, 0, -1, 1};
__constant__ int DX[4] = {-1, 1, 0, 0};
__constant__ int OPP[4] = {1, 0, 3, 2};

struct Params {
  const float *theta0, *theta1;  // [H, W]
  const float* Min;              // [4, H, W] the block's starting messages
  const float* V;                // [4, 2, 2, H, W] the pairwise tables
  const float* gamma;            // [H, W]
  const float* valid;            // [4, H, W]
  const int* cb;                 // [H, W] 0 black, 1 white
  float* Ma;                     // scratch [4, H, W]: the even phases' output
  float* Mb;                     // out [4, H, W]: the odd phases', the last
  unsigned char* zb;             // scratch [H, W]: z_black
  unsigned char* z;              // out [H, W]: the decoded labelling
  double* part;                  // scratch [2, grid]: the blocks' sums
  float* out;                    // out [2]: the bound, the energy
  int H, W, check_every, tiles_x, ntiles;
};

// order of the pointer array handed to k2_block_f32 (ops/k2_block.py builds
// it in this order)
enum Ptr {
  P_THETA0, P_THETA1, P_M, P_V, P_GAMMA, P_VALID, P_CB,
  P_MA, P_MB, P_ZB, P_Z, P_PART, P_OUT,
  P_COUNT
};

// torch.clamp_min(x, 0) on the card: a NaN stays, else ::max
__device__ __forceinline__ float relu0(float x) {
  return x != x ? x : fmaxf(x, 0.0f);
}

// torch.minimum on the card: a NaN wins, else ::min
__device__ __forceinline__ float tmin(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fminf(a, b);
}

__device__ __forceinline__ bool inside(const Params& P, int y, int x) {
  return y >= 0 && y < P.H && x >= 0 && x < P.W;
}

// binary.py::_beliefs at pixel (y, x): theta plus its in-edge buffers and
// the neighbours' out-edge buffers, in that order a direction; m gets the
// pixel's own four buffers
__device__ __forceinline__ void beliefs(const Params& P, const float* M,
                                        int y, int x, float& D0b, float& D1b,
                                        float (&m)[4]) {
  const long long HW = (long long)P.H * P.W;
  const long long i = (long long)y * P.W + x;
  float d0 = __ldg(P.theta0 + i), d1 = __ldg(P.theta1 + i);
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    m[d] = __ldcg(M + d * HW + i);
    d0 = d0 + relu0(-m[d]);
    d1 = d1 + relu0(m[d]);
    const int ny = y + DY[d], nx = x + DX[d];
    const float o = inside(P, ny, nx)
                        ? __ldcg(M + OPP[d] * HW + (long long)ny * P.W + nx)
                        : 0.0f;
    d0 = d0 + relu0(-o);
    d1 = d1 + relu0(o);
  }
  D0b = d0;
  D1b = d1;
}

// the gamma-scaled beliefs of _k2_phase at (y, x); the white phase first
// takes the minimum off both (and returns it in vmin)
__device__ __forceinline__ void scaled_beliefs(const Params& P, const float* M,
                                               int y, int x, bool white,
                                               float& g0, float& g1,
                                               float& vmin, float (&m)[4]) {
  float D0b, D1b;
  beliefs(P, M, y, x, D0b, D1b, m);
  vmin = 0.0f;
  if (white) {
    vmin = tmin(D0b, D1b);
    D0b = D0b - vmin;
    D1b = D1b - vmin;
  }
  const float g = __ldg(P.gamma + (long long)y * P.W + x);
  g0 = g * D0b;
  g1 = g * D1b;
}

// the region (r, c) of halo pixel h (0 <= h < HALO): the top and bottom
// rows, then the left and right columns
__device__ __forceinline__ void halo_at(int h, int& r, int& c) {
  if (h < RW) {
    r = 0;
    c = h;
  } else if (h < 2 * RW) {
    r = RH - 1;
    c = h - RW;
  } else {
    const int k = h - 2 * RW;
    r = 1 + (k >> 1);
    c = (k & 1) ? RW - 1 : 0;
  }
}

// One phase of colour ``color`` on one tile: binary.py::_k2_phase.  ``lb``:
// the block's last white phase, whose minima enter the bound.
__device__ void phase_tile(const Params& P, const float* Min, float* Mout,
                           int color, bool lb, int tile, float (*s0)[RW],
                           float (*s1)[RW], double& lbacc) {
  const bool white = color == 1;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int y0 = (tile / P.tiles_x) * TH, x0 = (tile % P.tiles_x) * TW;
  const int y = y0 + ty, x = x0 + tx;
  const bool mine = y < P.H && x < P.W;
  const long long HW = (long long)P.H * P.W;
  const long long i = (long long)y * P.W + x;
  float m[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int cbp = -1;
  if (mine) {
    float g0, g1, vmin;
    scaled_beliefs(P, Min, y, x, white, g0, g1, vmin, m);
    s0[ty + 1][tx + 1] = g0;
    s1[ty + 1][tx + 1] = g1;
    cbp = __ldg(P.cb + i);
    // lb_nodes: the phase colour's belief minima
    if (lb && cbp == color) lbacc += (double)vmin;
  }
  const int h = ty * TW + tx;
  if (h < HALO) {
    int r, c;
    halo_at(h, r, c);
    const int hy = y0 - 1 + r, hx = x0 - 1 + c;
    if (inside(P, hy, hx)) {
      float g0, g1, vmin, mh[4];
      scaled_beliefs(P, Min, hy, hx, white, g0, g1, vmin, mh);
      s0[r][c] = g0;
      s1[r][c] = g1;
    }
  }
  __syncthreads();
  if (mine) {
    const bool head = cbp == color;
    const float gp0 = s0[ty + 1][tx + 1], gp1 = s1[ty + 1][tx + 1];
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const float m0 = relu0(-m[d]), m1 = relu0(m[d]);
      const float* Vd = P.V + 4LL * d * HW + i;
      const float v00 = __ldg(Vd), v01 = __ldg(Vd + HW);
      const float v10 = __ldg(Vd + 2 * HW), v11 = __ldg(Vd + 3 * HW);
      float msg0, msg1;
      if (head) {
        // variant B (source = head p): msg[i] = min_j(gD_j - m_j + V[i, j])
        const float hb0 = gp0 - m0, hb1 = gp1 - m1;
        msg0 = tmin(hb0 + v00, hb1 + v01);
        msg1 = tmin(hb0 + v10, hb1 + v11);
      } else {
        // variant A (source = tail n): msg[j] = min_i(gD'_i - m_i + V[i, j])
        const bool in = inside(P, y + DY[d], x + DX[d]);
        const int r = ty + 1 + DY[d], c = tx + 1 + DX[d];
        const float gn0 = in ? s0[r][c] : 0.0f, gn1 = in ? s1[r][c] : 0.0f;
        const float ha0 = gn0 - m0, ha1 = gn1 - m1;
        msg0 = tmin(ha0 + v00, ha1 + v10);
        msg1 = tmin(ha0 + v01, ha1 + v11);
      }
      const float va = __ldg(P.valid + d * HW + i);
      Mout[d * HW + i] = (msg1 - msg0) * va;
      // lb_msgs: every valid edge's message minimum
      if (lb && va > 0.0f) lbacc += (double)tmin(msg0, msg1);
    }
  }
  __syncthreads();
}

// z_black at every pixel of the tile from the final messages, and the black
// pixels' belief minima for the bound
__device__ void black_tile(const Params& P, const float* M, int tile,
                           double& lbacc) {
  const int y = (tile / P.tiles_x) * TH + threadIdx.y;
  const int x = (tile % P.tiles_x) * TW + threadIdx.x;
  if (y >= P.H || x >= P.W) return;
  const long long i = (long long)y * P.W + x;
  float D0b, D1b, m[4];
  beliefs(P, M, y, x, D0b, D1b, m);
  P.zb[i] = D1b < D0b;
  if (__ldg(P.cb + i) == 0) lbacc += (double)tmin(D0b, D1b);
}

// _k2_decode at (y, x): black pixels keep z_black, the others take their
// argmin conditioned on the neighbours' z_black (ties keep label 0)
__device__ __forceinline__ unsigned char decode_at(const Params& P, int y,
                                                   int x) {
  const long long HW = (long long)P.H * P.W;
  const long long i = (long long)y * P.W + x;
  if (__ldg(P.cb + i) == 0) return __ldcg(P.zb + i);
  float cost0 = __ldg(P.theta0 + i), cost1 = __ldg(P.theta1 + i);
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int ny = y + DY[d], nx = x + DX[d];
    const bool in = inside(P, ny, nx);
    const long long n = (long long)ny * P.W + nx;
    const bool zn = in && __ldcg(P.zb + n);
    // in-edge E(p, d): V(z_n, j)
    const float* Vd = P.V + 4LL * d * HW + i;
    cost0 = cost0 + (zn ? __ldg(Vd + 2 * HW) : __ldg(Vd));
    cost1 = cost1 + (zn ? __ldg(Vd + 3 * HW) : __ldg(Vd + HW));
    // out-edge E(n, OPP(d)) at the neighbour n: V[OPP(d)](i, z_black(n))
    float t0 = 0.0f, t1 = 0.0f;
    if (in) {
      const float* Vo = P.V + 4LL * OPP[d] * HW + n;
      t0 = zn ? __ldg(Vo + HW) : __ldg(Vo);
      t1 = zn ? __ldg(Vo + 3 * HW) : __ldg(Vo + 2 * HW);
    }
    cost0 = cost0 + t0;
    cost1 = cost1 + t1;
  }
  return cost1 < cost0;
}

// The decode of the tile and its halo into shared memory, the tile's
// labelling out, and its pixels' energy (_k2_energy's terms) into eacc.
__device__ void decode_tile(const Params& P, int tile,
                            unsigned char (*zs)[RW], double& eacc) {
  const long long HW = (long long)P.H * P.W;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int y0 = (tile / P.tiles_x) * TH, x0 = (tile % P.tiles_x) * TW;
  const int y = y0 + ty, x = x0 + tx;
  const bool mine = y < P.H && x < P.W;
  const long long i = (long long)y * P.W + x;
  if (mine) {
    const unsigned char zp = decode_at(P, y, x);
    zs[ty + 1][tx + 1] = zp;
    P.z[i] = zp;
  }
  const int h = ty * TW + tx;
  if (h < HALO) {
    int r, c;
    halo_at(h, r, c);
    const int hy = y0 - 1 + r, hx = x0 - 1 + c;
    zs[r][c] = inside(P, hy, hx) ? decode_at(P, hy, hx) : 0;
  }
  __syncthreads();
  if (mine) {
    const bool zp = zs[ty + 1][tx + 1];
    double e = (double)(zp ? __ldg(P.theta1 + i) : __ldg(P.theta0 + i));
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const bool zn = inside(P, y + DY[d], x + DX[d]) &&
                      zs[ty + 1 + DY[d]][tx + 1 + DX[d]];
      // V[d][tail = zn, head = z]
      const float* Vd = P.V + 4LL * d * HW + i;
      e += (double)__ldg(Vd + (zn ? 2 : 0) * HW + (zp ? 1 : 0) * HW);
    }
    eacc += e;
  }
  __syncthreads();
}

// a block's sum of v in a fixed tree (every thread calls it)
__device__ double block_sum(double v, double* red) {
  const int tid = threadIdx.y * TW + threadIdx.x;
  red[tid] = v;
  __syncthreads();
#pragma unroll
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  const double total = red[0];
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(NT, 4) k2_block_kernel(const Params P) {
  __shared__ float s0[RH][RW], s1[RH][RW];
  __shared__ unsigned char zs[RH][RW];
  __shared__ double red[NT];
  cg::grid_group grid = cg::this_grid();
  double lbacc = 0.0, eacc = 0.0;

  // the phases, one grid.sync after each: black reads Min (then Mb) and
  // writes Ma, white reads Ma and writes Mb
  const int phases = 2 * P.check_every;
  const float* src = P.Min;
  for (int k = 0; k < phases; ++k) {
    const int color = k & 1;
    float* dst = color ? P.Mb : P.Ma;
    const bool lb = k == phases - 1;
    for (int t = blockIdx.x; t < P.ntiles; t += gridDim.x)
      phase_tile(P, src, dst, color, lb, t, s0, s1, lbacc);
    grid.sync();
    src = dst;
  }
  for (int t = blockIdx.x; t < P.ntiles; t += gridDim.x)
    black_tile(P, src, t, lbacc);
  grid.sync();
  for (int t = blockIdx.x; t < P.ntiles; t += gridDim.x)
    decode_tile(P, t, zs, eacc);

  // the sums: a fixed tree a block, then the blocks in order in block 0
  const double lb_b = block_sum(lbacc, red);
  const double e_b = block_sum(eacc, red);
  const int tid = threadIdx.y * TW + threadIdx.x;
  if (tid == 0) {
    P.part[blockIdx.x] = lb_b;
    P.part[gridDim.x + blockIdx.x] = e_b;
  }
  grid.sync();
  if (blockIdx.x == 0) {
    double lbs = 0.0, es = 0.0;
    for (int b = tid; b < (int)gridDim.x; b += NT) {
      lbs += __ldcg(P.part + b);
      es += __ldcg(P.part + gridDim.x + b);
    }
    lbs = block_sum(lbs, red);
    es = block_sum(es, red);
    if (tid == 0) {
      P.out[0] = (float)lbs;
      P.out[1] = (float)es;
    }
  }
}

// The grid: one block a tile, and no more than are resident at once (the
// cooperative launch refuses a larger grid).
cudaError_t launch(const Params& P, int parts, int* grid_out,
                   cudaStream_t st) {
  const void* fn = (const void*)k2_block_kernel;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, NT, 0);
  if (err != cudaSuccess) return err;
  long long grid = P.ntiles;
  if ((long long)per_sm * sms < grid) grid = (long long)per_sm * sms;
  if (grid < 1) return cudaErrorLaunchOutOfResources;
  if (grid > parts) return cudaErrorInvalidValue;
  *grid_out = (int)grid;
  Params p = P;
  void* args[] = {(void*)&p};
  err = cudaLaunchCooperativeKernel(fn, dim3((unsigned)grid), dim3(TW, TH),
                                    args, 0, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// ptrs: P_COUNT device pointers in the order of enum Ptr (a host array);
// H, W >= 2; check_every >= 1 phase pairs; parts: the blocks the scratch
// ``part`` has room for (2 doubles each); grid: out, the blocks of the
// launch.  Returns 0 or the CUDA error code.
extern "C" int k2_block_f32(const void* const* ptrs, int H, int W,
                            int check_every, int parts, int* grid,
                            void* stream) {
  if (H < 2 || W < 2 || check_every < 1) return (int)cudaErrorInvalidValue;
  Params P;
  P.theta0 = (const float*)ptrs[P_THETA0];
  P.theta1 = (const float*)ptrs[P_THETA1];
  P.Min = (const float*)ptrs[P_M];
  P.V = (const float*)ptrs[P_V];
  P.gamma = (const float*)ptrs[P_GAMMA];
  P.valid = (const float*)ptrs[P_VALID];
  P.cb = (const int*)ptrs[P_CB];
  P.Ma = (float*)ptrs[P_MA];
  P.Mb = (float*)ptrs[P_MB];
  P.zb = (unsigned char*)ptrs[P_ZB];
  P.z = (unsigned char*)ptrs[P_Z];
  P.part = (double*)ptrs[P_PART];
  P.out = (float*)ptrs[P_OUT];
  P.H = H;
  P.W = W;
  P.check_every = check_every;
  P.tiles_x = (W + TW - 1) / TW;
  P.ntiles = P.tiles_x * ((H + TH - 1) / TH);
  return (int)launch(P, parts, grid, (cudaStream_t)stream);
}

// The tiles of an H x W problem: the most blocks a launch takes.
extern "C" int k2_block_tiles(int H, int W) {
  return ((W + TW - 1) / TW) * ((H + TH - 1) / TH);
}
