"""One block of binary fusion's K = 2 TRW-S in one launch.

``k2_block(theta0, theta1, M, V, gamma, valid, cb, check_every) -> (M, lb,
    z, energy)`` — replaces no TPU kernel: the JAX package writes the K = 2
    solver in plain jnp (``stereo_tpu/solvers/binary.py``), which XLA fuses.
    The port's plain version, ``solvers.binary._k2_block``, is
    ``check_every`` pairs of ``_k2_phase``, the bound, ``_k2_decode`` and
    ``_k2_energy``: about 2,700 small PyTorch launches a block at
    ``check_every`` = 5; on the card it is one call of the hand-written CUDA
    kernel (csrc/k2_block.cu).

What bounds it on the card: a phase reads about 27 [H, W] planes and writes
4; a block's working set (about 20 MB at 375 x 450) sits in the 50 MB L2, so
a phase's bytes take a few microseconds and the block's 2 * check_every + 2
grid-wide barriers are its cost.  The kernel is persistent (launched
cooperatively), one tile of 8 x 32 pixels a block of the grid, the messages
ping-ponged between two buffers (a phase reads beliefs two hops away), the
tile's gamma-scaled beliefs with a 1-pixel halo in shared memory.  Built
with ``-fmad=false``, and every term added in the plain version's order: the
messages ``M`` and the labelling ``z`` equal the plain version's bit for bit;
the bound ``lb`` and the ``energy`` are summed in double in a fixed order
(the same bits from run to run) and agree with the plain version's float32
sums to their rounding (rtol 1e-5).  No single PyTorch call computes the
block, so there is no library yardstick.  PERF.md has the times.

The wrapper takes the plain version only when the problem lies on the CPU;
for a CUDA problem it launches the kernel or raises.  ``k2_block.launches``
counts kernel launches; ``k2_block.grid`` is the last launch's number of
blocks.
"""

from __future__ import annotations

import ctypes

import torch

from stereo_tpu_torch.ops._launch import check_tensor, launch_failed

# the pointers in the order of csrc/k2_block.cu's ``enum Ptr``: the inputs,
# then the scratch and the outputs
POINTERS = ("theta0", "theta1", "M", "V", "gamma", "valid", "cb", "MA", "MB",
            "ZB", "Z", "PART", "OUT")

_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument and result types of a built k2_block library."""
    ptr = ctypes.c_void_p
    lib.k2_block_f32.argtypes = [ptr, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_int), ptr]
    lib.k2_block_f32.restype = ctypes.c_int
    lib.k2_block_tiles.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.k2_block_tiles.restype = ctypes.c_int
    return lib


def _library():
    """The compiled kernel, built and bound at first use."""
    global _lib
    if _lib is None:
        from stereo_tpu_torch.ops import _build

        _lib = bind(_build.load("k2_block"))
    return _lib


def block_bytes(H: int, W: int) -> int:
    """Bytes a block must move at least: each input plane read once
    (theta0, theta1, gamma, the checkerboard, the 4 messages, the 16 tables,
    the 4 validities: 28 words a pixel), the 4 messages and the labelling
    written once; float32 and int32, the labelling one byte a pixel."""
    return H * W * ((28 + 4) * 4 + 1)


def k2_block(theta0, theta1, M, V, gamma, valid, cb, check_every: int):
    """``check_every`` K = 2 phase pairs from the messages ``M``, then the
    bound, the decode and the decoded labelling's energy -> (M, lb, z
    [H, W] bool, energy).

    theta0, theta1, gamma [H, W]; M, valid [4, H, W]; V [4, 2, 2, H, W]
    (``binary._tables``); cb [H, W] int32 (``trws.checkerboard``).  ``M`` is
    only read.

    CUDA problem: float32 (cb int32), contiguous, H, W >= 2, check_every >=
    1; one cooperative kernel launch on the current stream, no
    synchronisation; lb and energy are float32 0-dim tensors on the device.
    CPU problem: the plain version."""
    if not theta0.is_cuda:
        from stereo_tpu_torch.solvers import binary

        return binary._k2_block(theta0, theta1, M, V, gamma, valid, cb,
                                check_every)
    dev = theta0.device
    if theta0.dim() != 2:
        raise ValueError(f"k2_block: theta0 of shape {tuple(theta0.shape)}, "
                         "expected [H, W]")
    H, W = theta0.shape
    if H < 2 or W < 2:
        raise ValueError(f"k2_block: the kernel takes H, W >= 2, got "
                         f"{H} x {W}")
    if int(check_every) < 1:
        raise ValueError(f"k2_block: check_every {check_every} < 1")
    for name, t, shape, dtype in (
            ("theta0", theta0, (H, W), torch.float32),
            ("theta1", theta1, (H, W), torch.float32),
            ("M", M, (4, H, W), torch.float32),
            ("V", V, (4, 2, 2, H, W), torch.float32),
            ("gamma", gamma, (H, W), torch.float32),
            ("valid", valid, (4, H, W), torch.float32),
            ("cb", cb, (H, W), torch.int32)):
        check_tensor(name, t, shape, dev, dtype)
    lib = _library()
    parts = lib.k2_block_tiles(H, W)
    M_out = torch.empty_like(M)
    scratch = torch.empty_like(M)
    zb = torch.empty((H, W), dtype=torch.uint8, device=dev)
    z = torch.empty((H, W), dtype=torch.bool, device=dev)
    part = torch.empty((2 * parts,), dtype=torch.float64, device=dev)
    out = torch.empty((2,), dtype=torch.float32, device=dev)
    tensors = dict(theta0=theta0, theta1=theta1, M=M, V=V, gamma=gamma,
                   valid=valid, cb=cb, MA=scratch, MB=M_out, ZB=zb, Z=z,
                   PART=part, OUT=out)
    ptrs = (ctypes.c_void_p * len(POINTERS))(
        *(tensors[n].data_ptr() for n in POINTERS))
    grid = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.k2_block_f32(ptrs, H, W, int(check_every), parts,
                                ctypes.byref(grid), stream)
    if code != 0:
        launch_failed("k2_block", code)
    k2_block.launches += 1
    k2_block.grid = grid.value
    return M_out, out[0], z, out[1]


k2_block.launches = 0
k2_block.grid = 0
