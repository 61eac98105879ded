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
with a grid-wide barrier after each; the kernel is persistent and launched
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
``sweep_wavefront.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from stereo_tpu_torch.ops._launch import check_tensor, launch_staged

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
                                        ctypes.c_int, ptr, ctypes.c_longlong,
                                        ptr, ptr]
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


def sweep_wavefront(sk, M):
    """One raster-order sweep (forward + backward) -> (state, lower bound).

    sk: a ``solvers.wavefront._Skewed``; M: ``(MA, MB)`` in that module's
    shapes.

    CUDA problem: float32, contiguous state on the problem's device; one
    cooperative kernel launch on the current stream, no synchronisation; MA
    and MB are overwritten and returned.  CPU problem: the plain version."""
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
    lb = torch.empty((), dtype=torch.float64, device=dev)
    ptrs = (ctypes.c_void_p * (len(tensors) + 3))(
        *(t.data_ptr() for t in tensors), gD.data_ptr(), lbacc.data_ptr(),
        lb.data_ptr())
    dims = (ctypes.c_int * 3)(K, H, W)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        launch_staged("sweep_wavefront", lambda *scratch:
                      lib.wavefront_sweep_f32(ptrs, dims, float(sk.tol),
                                              int(sk.kernel), *scratch,
                                              stream), dev)
    sweep_wavefront.launches += 1
    return (MA, MB), lb.to(torch.float32)


sweep_wavefront.launches = 0
