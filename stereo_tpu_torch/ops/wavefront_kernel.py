"""The fused raster-order TRW-S sweep (port of
stereo_tpu/ops/wavefront_kernel.py).

``sweep_wavefront(sk, (MA, MB)) -> ((MA, MB), lb)`` — replaces the TPU kernel
    ``stereo_tpu/ops/wavefront_kernel.py::_kernel`` (``sweep_pallas``).
    One whole sweep of solvers/wavefront.py: ``_fwd_col`` for t = 0 .. T-1
    (head-sends of group A = (RT, DN) at column c, tail-sends of group B =
    (LT, UP) into column c+1), then ``_bwd_col`` for t = T-1 .. 0 (head-sends
    of B at c, tail-sends of A into c-1) with the sweep's lower bound, in one
    call of the hand-written CUDA kernel (csrc/wavefront_kernel.cu).  Its
    plain version is ``solvers.wavefront._sweep_steps(sk, M,
    use_kernel=False)``.

**In place.**  On the card the kernel overwrites MA and MB and the returned
state holds the same tensors; a caller that still needs the old state clones
it first.

What bounds it on the card: per sweep 8 sends x K^2 min-plus steps of six
float32 instructions per pixel, against every problem and message entry of a
real pixel moved once per pass (the padding lanes of the skewed columns, more
than half of every column, need not be moved, and this kernel does not touch
them); at teddy K = 79 the operations are the larger bound (chip_smoke.py
states both formulas).  The design does not carry the TPU kernel's packed
problem slab, its padding of K and H to tile multiples, its resident column
windows, DMA semaphores and lane rotations over: it reads the ``_Skewed``
arrays where they lie and turns every shift into index arithmetic, with the
guard before the load.  A step is two phases (beliefs, then the four sends)
and one grid-wide barrier, after the sends; a send job waits only for the
tiles of beliefs it needs, through per-tile ready flags (``wait_lanes``
states the rule, tests/test_torch_wavefront.py checks it), and issues its
problem loads before it waits.  A send job is J = 32, 16 or 8 lanes wide:
each step takes the width whose jobs the resident grid runs soonest
(``step_jobs`` counts them, ``minplus.job_width`` chooses), so the thin
steps of this schedule (at most 4 x ceil(min(H, W) / 32) jobs 32 lanes
wide) reach more blocks; the walk takes the truncation out of the K^2 loop
for a >= 0.  The kernel is persistent and launched
cooperatively, so a grid that could not be resident at once is refused by the
launch instead of hanging.  Only the lanes that hold a pixel at a step are
visited.  Built with ``-fmad=false``: messages equal the plain version's bit
for bit; the bound is accumulated per lane in double and agrees to float32
rounding (rtol 1e-5).  It takes every T >= 1 (``MIN_T``: any grid with a
pixel) and every K: a block has at most 12 warps, and more than 96 labels
take several passes over the targets; sources that do not fit shared memory
(K above about 890) are staged in global scratch (csrc/minplus.cuh::
plan_stage decides).  Inputs must be finite.
No single PyTorch call computes a sweep, so there is no library yardstick.
PERF.md has the times.

The wrapper takes the plain version only when the problem lies on the CPU;
for a CUDA problem it launches the kernel or raises.
``sweep_wavefront.launches`` counts kernel launches;
``sweep_wavefront.grid`` is the last launch's number of blocks.
"""

from __future__ import annotations

import ctypes

import torch

from stereo_tpu_torch.ops._launch import check_tensor, launch_staged
from stereo_tpu_torch.ops.minplus import TILE, check_width

# the least number of anti-diagonals: one, a grid of a single pixel
MIN_T = 1

# the bound's accumulators of the kernel: the node term and the four sends
LB_SLOTS = 5

# problem arrays in the order of csrc/wavefront_kernel.cu's ``enum Ptr``
_PROBLEM = ("theta", "D0", "QA", "QB", "aA", "aB", "vA", "vB", "gamma")

_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument and result types of a built wavefront_kernel
    library."""
    ptr = ctypes.c_void_p
    lib.wavefront_sweep_f32.argtypes = [ptr, ptr, ctypes.c_float,
                                        ctypes.c_int, ctypes.c_int, ptr,
                                        ctypes.c_longlong, ptr, ptr, ptr]
    lib.wavefront_sweep_f32.restype = ctypes.c_int
    return lib


def _library():
    """The compiled kernel, built and bound at first use."""
    global _lib
    if _lib is None:
        from stereo_tpu_torch.ops import _build

        _lib = bind(_build.load("wavefront_kernel"))
    return _lib


def problem_shapes(K: int, H: int, W: int) -> dict:
    """Shape of every array of a skewed problem and its state, by name."""
    T2 = H + W - 1 + 2
    return dict(theta=(T2, K, H), D0=(T2, K, H), QA=(T2, 2, K, H),
                QB=(T2, 2, K, H), aA=(T2, 2, H), aB=(T2, 2, H),
                vA=(T2, 2, H), vB=(T2, 2, H), pix=(T2, H), gamma=(T2, H),
                MA=(T2, 2, K, H), MB=(T2, 2, K, H))


def check_limits(T: int):
    """Raise on a problem the CUDA kernel does not take: it takes every K."""
    if T < MIN_T:
        raise ValueError(f"sweep_wavefront: T = {T} anti-diagonals, the CUDA "
                         f"kernel takes at least {MIN_T}")


def live_lanes(H: int, W: int, t: int) -> tuple[int, int]:
    """Lanes [lo, hi) of step t's column that hold pixels (empty outside
    0 .. T-1); phase A's tile j of the step is lanes lo + 32 j + [0, 32)."""
    if t < 0 or t >= H + W - 1:
        return 0, 0
    return max(0, t - W + 1), min(H - 1, t) + 1


def step_jobs(H: int, W: int, t: int, backward: bool, J: int) -> list[int]:
    """Jobs J lanes wide of each of step t's four phase-B segments (heads
    d = 0, 1 at the step's live lanes; tails d = 0, 1 at those of the step
    they write into), as csrc/wavefront_kernel.cu::sends_width enumerates
    them; job j of the step is ``minplus.job_at(step_jobs(..), j)``."""
    hlo, hhi = live_lanes(H, W, t)
    tlo, thi = live_lanes(H, W, t - 1 if backward else t + 1)
    return [-(-(hhi - hlo) // J)] * 2 + [-(-(thi - tlo) // J)] * 2


def wait_lanes(H: int, W: int, t: int, backward: bool, seg: int,
               tile: int, J: int = TILE) -> tuple[int, int]:
    """Lanes [lo, hi) of step t's phase A that job (seg, tile) of phase B,
    J lanes wide, waits for: it reads their gD, or overwrites a message that
    their beliefs read.  seg 0, 1: the head-sends (directions d = 0, 1); seg
    2, 3: the tail-sends.  The rule of csrc/wavefront_kernel.cu::
    sends_width, clipped to the step's live lanes (the kernel waits for the
    tiles of 32 lanes that cover them, and acquires no flag for a tile that
    the job's own block wrote: its block barrier already orders it)."""
    hlo, hhi = live_lanes(H, W, t)
    if seg < 2:  # head-sends: own lane
        lo = hlo + tile * J
        hi = lo + J
    else:  # tail-sends: own lane and the vertical neighbour
        l0 = live_lanes(H, W, t - 1 if backward else t + 1)[0] + tile * J
        lo, hi = (l0, l0 + J + 1) if backward else (l0 - 1, l0 + J)
    return max(lo, hlo), min(hi, hhi)


def sweep_wavefront(sk, M, width: int = 0):
    """One raster-order sweep (forward + backward) -> (state, lower bound).

    sk: a ``solvers.wavefront._Skewed``; M: ``(MA, MB)`` in that module's
    shapes; width: phase B's job width (32, 16 or 8 lanes), or 0 for the
    kernel's choice a step (the results are the same bits at every width).

    CUDA problem: float32, contiguous state on the problem's device; one
    cooperative kernel launch on the current stream, no synchronisation; MA
    and MB are overwritten and returned.  CPU problem: the plain version."""
    check_width("sweep_wavefront", width)
    if not sk.theta.is_cuda:
        from stereo_tpu_torch.solvers import wavefront

        return wavefront._sweep_steps(sk, M, use_kernel=False)
    K, H, W, dev = sk.K, sk.H, sk.W, sk.device
    check_limits(sk.T)
    MA, MB = M
    shapes = problem_shapes(K, H, W)
    tensors = [getattr(sk, n) for n in _PROBLEM] + [MA, MB]
    for name, t in zip(_PROBLEM + ("MA", "MB"), tensors):
        check_tensor(name, t, shapes[name], dev)
    lib = _library()
    gD = torch.empty((K, H), dtype=torch.float32, device=dev)
    lbacc = torch.empty((LB_SLOTS, H), dtype=torch.float64, device=dev)
    flags = torch.empty((-(-H // TILE),), dtype=torch.int32, device=dev)
    lb = torch.empty((), dtype=torch.float64, device=dev)
    ptrs = (ctypes.c_void_p * (len(tensors) + 4))(
        *(t.data_ptr() for t in tensors), gD.data_ptr(), lbacc.data_ptr(),
        flags.data_ptr(), lb.data_ptr())
    dims = (ctypes.c_int * 3)(K, H, W)
    grid = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        launch_staged("sweep_wavefront", lambda *scratch:
                      lib.wavefront_sweep_f32(ptrs, dims, float(sk.tol),
                                              int(sk.kernel), int(width),
                                              *scratch, ctypes.byref(grid),
                                              stream), dev)
    sweep_wavefront.launches += 1
    sweep_wavefront.grid = grid.value
    return (MA, MB), lb.to(torch.float32)


sweep_wavefront.launches = 0
sweep_wavefront.grid = 0
