"""The fused banded TRW-S sweep (port of stereo_tpu/ops/banded_kernel.py).

``sweep_banded(bp, state) -> (state, lb)`` — replaces the TPU kernel
    ``stereo_tpu/ops/banded_kernel.py::_kernel`` (``sweep_banded_pallas``).
    One whole sweep of solvers/banded.py: ``_fwd_col`` for t = 0 .. T-1, then
    ``_bwd_col`` for t = T-1 .. 0, and the sweep's lower bound, in one call of
    the hand-written CUDA kernel (csrc/banded_kernel.cu).  Its plain version
    is ``solvers.banded._sweep_steps(bp, state, use_kernel=False)``.

**In place.**  On the card the kernel overwrites the state's tensors (MA, MB
and the four seam arrays) and the returned state holds the same tensors; a
caller that still needs the old state clones it first.  (A copy of the two
message arrays per sweep would be half a gigabyte at teddy K = 79.)

What bounds it on the card: per sweep 8 sends x K^2 min-plus steps of six
float32 instructions per pixel, against every problem and message entry of a
real pixel moved once (the padding lanes of the skewed columns, half of every
column, need not be moved, and this kernel does not touch them); at teddy
K = 79 the operations are the larger bound (chip_smoke.py states both
formulas).  The design does not carry the TPU kernel's resident windows,
packed slabs and lane rotations over: it reads the problem's arrays where
they lie and turns every roll into index arithmetic, with the guard before
the load.  A step is two phases (beliefs, then the eight sends) and one
grid-wide barrier, after the sends; a send job waits only for the tiles of
beliefs it needs, through per-tile ready flags (``wait_lanes`` states the
rule, tests/test_torch_any_k.py checks it), and issues its problem loads
before it waits.  A send job is J = 32, 16 or 8 lanes wide: each step takes
the width whose jobs the resident grid runs soonest (``step_jobs`` counts
them, ``minplus.job_width`` chooses), so a thin step is cut into narrow
jobs that reach every block; the walk takes the truncation out of the K^2
loop for a >= 0.  The kernel is persistent and launched cooperatively, so a
grid that could not be resident at once is refused by the launch instead of
hanging.  Only the lanes that hold a node at a step are visited, and a seam
send touches one group of nb lanes.  Built with ``-fmad=false``: messages and
seam arrays equal the plain version's bit for bit; the bound is accumulated
per lane in double and agrees to float32 rounding (rtol 1e-5).  It takes
every T >= 3 and every K: a block has at most 12 warps, more than 96 labels
take several passes over the targets, and sources that do not fit shared
memory (K above about 890) are staged in global scratch
(csrc/minplus.cuh::plan_stage decides).  Inputs must be
finite.  No single PyTorch call computes a sweep, so there is
no library yardstick.  PERF.md has the times.

The wrapper takes the plain version only when the problem lies on the CPU;
for a CUDA problem it launches the kernel or raises.
``sweep_banded.launches`` counts kernel launches; ``sweep_banded.grid`` is
the last launch's number of blocks.
"""

from __future__ import annotations

import ctypes

import torch

from stereo_tpu_torch.ops._launch import check_tensor, launch_staged
from stereo_tpu_torch.ops.minplus import TILE, check_width

# the bound's accumulators of the kernel: the node term and the eight sends
LB_SLOTS = 9

# problem arrays in the order of csrc/banded_kernel.cu's ``enum Ptr``
_PROBLEM_F32 = ("theta", "D0", "QA", "QB", "aA", "aB", "vA", "vB", "pix",
                "gamma", "PxL_q", "PxL_d0", "PxL_a", "PxR_q", "PxR_d0",
                "PxR_a", "PyU_q", "PyU_d0", "PyU_a", "PyD_q", "PyD_d0",
                "PyD_a")
_PROBLEM_MASKS = ("vSxL", "vSxR", "vSyU", "vSyD")

_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument and result types of a built banded_kernel
    library."""
    ptr = ctypes.c_void_p
    lib.banded_sweep_f32.argtypes = [ptr, ptr, ctypes.c_float, ctypes.c_int,
                                     ctypes.c_int, ptr, ctypes.c_longlong,
                                     ptr, ptr, ptr]
    lib.banded_sweep_f32.restype = ctypes.c_int
    return lib


def _library():
    """The compiled kernel, built and bound at first use."""
    global _lib
    if _lib is None:
        from stereo_tpu_torch.ops import _build

        _lib = bind(_build.load("banded_kernel"))
    return _lib


def problem_shapes(spec, K: int) -> dict:
    """Shape of every array of a banded problem and state, by name."""
    T2, L, Lp = spec.T + 2, spec.L, spec.Lp
    shapes = dict(theta=(T2, K, L), D0=(T2, K, L), QA=(T2, 2, K, L),
                  QB=(T2, 2, K, L), aA=(T2, 2, L), aB=(T2, 2, L),
                  vA=(T2, 2, L), vB=(T2, 2, L), pix=(T2, L), gamma=(T2, L),
                  vSxL=(L,), vSxR=(L,), vSyU=(Lp,), vSyD=(Lp,),
                  MA=(T2, 2, K, L), MB=(T2, 2, K, L), SxL=(K, L), SxR=(K, L),
                  SyU=(K, Lp), SyD=(K, Lp))
    for side, n in (("PxL", L), ("PxR", L), ("PyU", Lp), ("PyD", Lp)):
        shapes[side + "_q"] = shapes[side + "_d0"] = (K, n)
        shapes[side + "_a"] = (n,)
    return shapes


def live_lanes(spec, t: int) -> tuple[int, int]:
    """Lanes [lo, hi) of step t's column that hold nodes (empty outside
    0 .. T-1); phase A's tile j of the step is lanes lo + 32 j + [0, 32)."""
    if t < 0 or t >= spec.T:
        return 0, 0
    return (max(0, t - spec.Bw + 1) * spec.nb,
            (min(spec.Bh - 1, t) + 1) * spec.nb)


def step_jobs(spec, t: int, backward: bool, J: int) -> list[int]:
    """Jobs J lanes wide of each of step t's eight phase-B segments (heads
    d = 0, 1; tails d = 0, 1; x-seam head, tail; y-seam head, tail), as
    csrc/banded_kernel.cu::segment_jobs counts them; job j of the step is
    ``minplus.job_at(step_jobs(..), j)``."""
    n = lambda lanes: -(-lanes // J)
    hlo, hhi = live_lanes(spec, t)
    tlo, thi = live_lanes(spec, t - 1 if backward else t + 1)
    xg = t - (spec.Bw - 1) if backward else t
    yg = t - (spec.Bh - 1) if backward else t
    n_x = n(spec.nb) if 0 <= xg < spec.Bh else 0
    n_y = n(spec.nb) if 0 <= yg < spec.Bw else 0
    return [n(hhi - hlo)] * 2 + [n(thi - tlo)] * 2 + [n_x] * 2 + [n_y] * 2


def wait_lanes(spec, t: int, backward: bool, seg: int, tile: int,
               J: int = TILE) -> tuple[int, int]:
    """Lanes [lo, hi) of step t's phase A that job (seg, tile) of phase B,
    J lanes wide, waits for: it reads their gD, or overwrites a message that
    their beliefs read.  The rule of csrc/banded_kernel.cu::sends_width,
    clipped to the step's live lanes (the kernel waits for the tiles of 32
    lanes that cover them)."""
    nb = spec.nb
    hlo, hhi = live_lanes(spec, t)
    if seg < 2:  # head-sends: own lane
        lo = hlo + tile * J
        hi = lo + J
    elif seg < 4:  # tail-sends: own lane and the vertical neighbour
        l0 = live_lanes(spec, t - 1 if backward else t + 1)[0] + tile * J
        lo, hi = (l0, l0 + J + nb) if backward else (l0 - nb, l0 + J)
    elif seg < 6:  # x-seam sends: the lanes either side
        xg = t - (spec.Bw - 1) if backward else t
        lo = xg * nb + tile * J - 1
        hi = lo + J + 2
    else:  # y-seam sends: every tile
        lo, hi = hlo, hhi
    return max(lo, hlo), min(hi, hhi)


def sweep_banded(bp, state, width: int = 0):
    """One banded sweep (forward + backward) -> (state, lower bound).

    bp: a ``solvers.banded._BandedProblem``; state: ``(MA, MB, (SxL, SxR,
    SyU, SyD))`` in that module's shapes; width: phase B's job width (32,
    16 or 8 lanes), or 0 for the kernel's choice a step (the results are the
    same bits at every width).

    CUDA problem: float32, contiguous state on the problem's device; one
    cooperative kernel launch on the current stream, no synchronisation; the
    state's tensors are overwritten and returned.  CPU problem: the plain
    version."""
    check_width("sweep_banded", width)
    if not bp.theta.is_cuda:
        from stereo_tpu_torch.solvers import banded

        return banded._sweep_steps(bp, state, use_kernel=False)
    spec, K, dev = bp.spec, bp.K, bp.device
    MA, MB, (SxL, SxR, SyU, SyD) = state
    shapes = problem_shapes(spec, K)
    tensors = [getattr(bp, n) for n in _PROBLEM_F32 + _PROBLEM_MASKS]
    tensors += [MA, MB, SxL, SxR, SyU, SyD]
    names = _PROBLEM_F32 + _PROBLEM_MASKS + ("MA", "MB", "SxL", "SxR", "SyU",
                                             "SyD")
    for name, t in zip(names, tensors):
        check_tensor(name, t, shapes[name], dev,
                     torch.bool if name in _PROBLEM_MASKS else torch.float32)
    lib = _library()
    gD = torch.empty((K, spec.L), dtype=torch.float32, device=dev)
    lbacc = torch.empty((LB_SLOTS, spec.Lp), dtype=torch.float64, device=dev)
    flags = torch.empty((-(-spec.L // TILE),), dtype=torch.int32, device=dev)
    lb = torch.empty((), dtype=torch.float64, device=dev)
    ptrs = (ctypes.c_void_p * (len(tensors) + 4))(
        *(t.data_ptr() for t in tensors), gD.data_ptr(), lbacc.data_ptr(),
        flags.data_ptr(), lb.data_ptr())
    dims = (ctypes.c_int * 5)(K, spec.Bh, spec.Bw, spec.Gy, spec.Gx)
    grid = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        launch_staged("sweep_banded", lambda *scratch: lib.banded_sweep_f32(
            ptrs, dims, float(bp.tol), int(bp.kernel), int(width), *scratch,
            ctypes.byref(grid), stream), dev)
    sweep_banded.launches += 1
    sweep_banded.grid = grid.value
    return state, lb.to(torch.float32)


sweep_banded.launches = 0
sweep_banded.grid = 0
