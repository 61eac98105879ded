"""The banded TRW-S decode in one launch.

``decode_banded(bp, state) -> (labels [H, W] int32, energy)`` — replaces no
    TPU kernel: the JAX package runs this decode as one ``lax.scan``
    (``stereo_tpu/solvers/banded.py::_decode_state``), which XLA compiles
    into one program.  The port's plain version,
    ``solvers.banded._decode_state``, is a Python loop over the T = Bh + Bw
    - 1 steps of the banded order, about 90 small PyTorch ops a step; on
    the card it is one call of the hand-written CUDA kernel
    (csrc/banded_decode.cu).

What bounds it on the card: a decode reads every real pixel's eight
K-planes once (theta, D0, the two out-edge positions at the earlier column,
the four later-edge messages) and a few scalars, (8 K + 16) floats a pixel
(``decode_bytes``), 0.13 ms at teddy K = 79 on 3.35 TB/s; it does K x about
40 float32 operations a pixel, far below the card's rate.  What it pays on
top is the T steps: a step reads the solutions of steps t - 1, t - Bw + 1
and t - Bh + 1, so the kernel is persistent (launched cooperatively), walks
the steps itself with one grid-wide barrier between them, and visits only a
step's live lanes (``banded_kernel.live_lanes``), in tiles of 16 lanes with
a block's threads spread over the labels.  Every roll, pad and seam view of
the plain version is index arithmetic, with the guard before the load.
Built with ``-fmad=false``, and every term added in ``_decode_step``'s
order: the labels equal the plain version's bit for bit (ties to the
lowest label, as ``torch.argmin``); the energy is accumulated per lane in
double and agrees to float32 rounding (rtol 1e-5).  It takes every K (no
shared memory grows with K) and every T >= 3.  Inputs must be finite.
No single PyTorch call computes the decode, so there is no library
yardstick.  PERF.md has the times.

The wrapper takes the plain version only when the problem lies on the CPU;
for a CUDA problem it launches the kernel or raises.
``decode_banded.launches`` counts kernel launches; ``decode_banded.grid`` is
the last launch's number of blocks.
"""

from __future__ import annotations

import ctypes

import torch

from stereo_tpu_torch.ops._launch import check_tensor, launch_failed
from stereo_tpu_torch.ops.banded_kernel import problem_shapes

# problem arrays in the order of csrc/banded_decode.cu's ``enum Ptr``, then
# the state's
PROBLEM_F32 = ("theta", "D0", "QA", "QB", "aA", "aB", "vA", "vB", "pix",
               "PxL_q", "PxL_d0", "PxL_a", "PyU_q", "PyU_d0", "PyU_a")
PROBLEM_MASKS = ("vSxL", "vSxR")
STATE = ("MA", "MB", "SxL", "SxR", "SyU", "SyD")

_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument and result types of a built banded_decode
    library."""
    ptr = ctypes.c_void_p
    lib.banded_decode_f32.argtypes = [ptr, ptr, ctypes.c_float, ctypes.c_int,
                                      ptr, ptr]
    lib.banded_decode_f32.restype = ctypes.c_int
    return lib


def _library():
    """The compiled kernel, built and bound at first use."""
    global _lib
    if _lib is None:
        from stereo_tpu_torch.ops import _build

        _lib = bind(_build.load("banded_decode"))
    return _lib


def decode_bytes(K: int, pixels: int) -> int:
    """Bytes a decode must move at least: each real pixel's eight K-planes
    and 16 scalars (validities, weights, the gathered positions, its
    label), float32."""
    return pixels * (8 * K + 16) * 4


def decode_banded(bp, state):
    """The greedy conditioned decode of a banded state -> (labels [H, W]
    int32, energy).

    bp: a ``solvers.banded._BandedProblem`` of one device (no stripe);
    state: ``(MA, MB, (SxL, SxR, SyU, SyD))`` in that module's shapes; the
    state is only read.

    CUDA problem: float32, contiguous state on the problem's device; one
    cooperative kernel launch on the current stream, no synchronisation;
    the energy is a float32 0-dim tensor on the device.  CPU problem: the
    plain version."""
    if not bp.theta.is_cuda:
        from stereo_tpu_torch.solvers import banded

        return banded._decode_state(bp, state)
    spec, K, dev = bp.spec, bp.K, bp.device
    if bp.stripe != (0, spec.H, False, False):
        raise ValueError("decode_banded: the kernel decodes a one-device "
                         "problem; a stripe's decode is "
                         "solvers/banded_dist.py's")
    MA, MB, (SxL, SxR, SyU, SyD) = state
    shapes = problem_shapes(spec, K)
    names = PROBLEM_F32 + PROBLEM_MASKS + STATE
    tensors = [getattr(bp, n) for n in PROBLEM_F32 + PROBLEM_MASKS]
    tensors += [MA, MB, SxL, SxR, SyU, SyD]
    for name, t in zip(names, tensors):
        check_tensor(name, t, shapes[name], dev,
                     torch.bool if name in PROBLEM_MASKS else torch.float32)
    lib = _library()
    sols = torch.empty((spec.T + 2, spec.L), dtype=torch.int32, device=dev)
    eacc = torch.empty((spec.L,), dtype=torch.float64, device=dev)
    labels = torch.empty((spec.H, spec.W), dtype=torch.int32, device=dev)
    energy = torch.empty((), dtype=torch.float64, device=dev)
    ptrs = (ctypes.c_void_p * (len(tensors) + 4))(
        *(t.data_ptr() for t in tensors), sols.data_ptr(), eacc.data_ptr(),
        labels.data_ptr(), energy.data_ptr())
    dims = (ctypes.c_int * 7)(K, spec.H, spec.W, spec.Bh, spec.Bw, spec.Gy,
                              spec.Gx)
    grid = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.banded_decode_f32(ptrs, dims, float(bp.tol),
                                     int(bp.kernel), ctypes.byref(grid),
                                     stream)
    if code != 0:
        launch_failed("decode_banded", code)
    decode_banded.launches += 1
    decode_banded.grid = grid.value
    return labels, energy.to(torch.float32)


decode_banded.launches = 0
decode_banded.grid = 0
