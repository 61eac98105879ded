"""Fused checkerboard-phase message kernels (port of
stereo_tpu/ops/phase_kernel.py).

Two functions, each with a hand-written CUDA kernel (csrc/phase_kernel.cu)
and a plain PyTorch version of the same math beside it:

``phase_messages_compact`` — replaces the TPU kernel
    ``stereo_tpu/ops/phase_kernel.py::_kernel_compact``
    (``phase_messages_compact_pallas``).  One TRW-S half-iteration on the two
    checkerboard-compacted half-grids (ops/checker.py), 4 directions per
    launch:
      s-heads (variant B): msg[i] = min_j gD[j] - Ms[d][j] + a TR(Qs[d][i] - D0s[j])
      o-heads (variant A): msg[j] = min_i gDn[d][i] - Mo[d][i] + a TR(Qo[d][i] - D0o[j])
    each minus its per-pixel minimum, times ``valid``; the minima are returned
    for the lower bound.

``phase_messages`` — replaces ``stereo_tpu/ops/phase_kernel.py::_kernel``
    (``phase_messages_pallas``).  The full-grid phase: at every pixel the
    variant picked by ``src_is_head``, min-normalised and masked.

What bounds them on the card, per launch: the compact kernel moves
(31 K + 24) planes of Hc x W float32 (23 K + 16 read, 8 K + 8 written), the
full-grid kernel (18 K + 13) planes of H x W; both walk K^2 (target, source)
terms per pixel and direction.  The kernels take the truncation out of that
loop: for a >= 0, min_s h + a TR = min(min_s h + a |x - y|^k, min_s h + a tol)
bit for bit (rounding is monotone), so a term is four issued float32
instructions (sub, mul with |.|, add, min; kernel 2 one mul more) and the
second minimum costs K operations per pixel.  A pixel with a < 0, where the
identity fails, walks the plain term.  At K = 79 the issue slots are the
bound (about 0.5 ms for the compact launch on an H100), at K = 15 the bytes.
All inputs must be finite (the kernel's fminf drops a NaN where
torch.minimum would keep it).  The design: a block covers 32 pixels along
the contiguous W axis and all K targets, 20 per thread in registers on
ceil(K / 20) warps (K above 160 in passes); the tile's sources are staged
in shared memory in double-buffered chunks (cp.async), turned into
h = g - m once, and walked once; the minimum over the targets is reduced
across the warps and every output written once, normalised from
registers.  K and the plane size are runtime arguments and the ragged
edges are masked in the kernel, so no input is padded.  The full-grid
kernel lays its threads out by colour so that a warp evaluates one variant
only.  Built with ``-fmad=false``: float32 results equal the plain versions
bit for bit.  No single PyTorch call computes either function, so there is
no library yardstick for them.

A wrapper takes its plain version only when its tensors lie on the CPU; for
CUDA tensors it launches the kernel or raises.  ``<wrapper>.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from stereo_tpu_torch.energy import truncated_kernel
from stereo_tpu_torch.geometry import NUM_DIRS
from stereo_tpu_torch.ops._launch import check_tensor as _check
from stereo_tpu_torch.ops._launch import launch_failed as _launch_failed
from stereo_tpu_torch.ops.minplus import minplus_pair_ref


# ------------------------------------------------------------ plain versions
def phase_messages_compact_ref(gD_s, gDn, M_s, M_o, Q_s, Q_o, D0_s, D0_o,
                               a_s, a_o, valid_s, valid_o, tol, kernel: int):
    """Plain PyTorch compacted phase; same contract as
    ``phase_messages_compact``."""
    K = gD_s.shape[0]
    newMs, newMo, vmins, vmino = [], [], [], []
    for d in range(NUM_DIRS):
        # variant B at s-heads: msg[i] = min_j HB[j] + a*TR(Q_i - D0_j)
        HB = gD_s - M_s[d]
        accB = None
        for j in range(K):
            term = a_s[d][None] * truncated_kernel(
                Q_s[d] - D0_s[j][None], kernel, tol)
            contrib = HB[j][None] + term
            accB = contrib if accB is None else torch.minimum(accB, contrib)
        vminB = torch.min(accB, dim=0).values
        newMs.append((accB - vminB[None]) * valid_s[d][None])
        vmins.append(vminB)
        # variant A at o-heads: msg[j] = min_i HA[i] + a*TR(Q_i - D0_j)
        HA = gDn[d] - M_o[d]
        rows = []
        for j in range(K):
            term = a_o[d][None] * truncated_kernel(
                Q_o[d] - D0_o[j][None], kernel, tol)
            rows.append(torch.min(HA + term, dim=0).values)
        msgA = torch.stack(rows, dim=0)
        vminA = torch.min(msgA, dim=0).values
        newMo.append((msgA - vminA[None]) * valid_o[d][None])
        vmino.append(vminA)
    return (torch.stack(newMs, 0), torch.stack(newMo, 0),
            torch.stack(vmins, 0), torch.stack(vmino, 0))


def phase_messages_ref(gD, gD_shifted, M, Q, D0, alphas, src_is_head, valid,
                       tol, kernel: int):
    """Plain PyTorch full-grid phase; same contract as ``phase_messages``."""
    newM, vmins = [], []
    head = src_is_head > 0
    for d in range(NUM_DIRS):
        H_A = gD_shifted[d] - M[d]
        H_B = gD - M[d]
        msgA, msgB = minplus_pair_ref(H_A, H_B, Q[d], D0, alphas[d], tol,
                                      kernel)
        msg = torch.where(head[None], msgB, msgA)
        vmin = torch.min(msg, dim=0).values
        newM.append((msg - vmin[None]) * valid[d][None])
        vmins.append(vmin)
    return torch.stack(newM, 0), torch.stack(vmins, 0)


# ------------------------------------------------------------------ binding
_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument and result types of a built phase_kernel
    library's two functions."""
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    lib.phase_messages_compact_f32.argtypes = (
        [ptr] * 16 + [f32, i32, i32, i64, ptr])
    lib.phase_messages_compact_f32.restype = i32
    lib.phase_messages_f32.argtypes = (
        [ptr] * 10 + [f32, i32, i32, i32, i32, ptr])
    lib.phase_messages_f32.restype = i32
    return lib


def _library():
    """The compiled kernels, built and bound at first use."""
    global _lib
    if _lib is None:
        from stereo_tpu_torch.ops import _build

        _lib = bind(_build.load("phase_kernel"))
    return _lib


# ----------------------------------------------------------------- wrappers
def phase_messages_compact(gD_s, gDn, M_s, M_o, Q_s, Q_o, D0_s, D0_o,
                           a_s, a_o, valid_s, valid_o, tol, kernel: int):
    """Fused compacted phase (see ops/checker.py for the layout).

    gD_s, D0_*: [K, Hc, W]; gDn (tail beliefs at o-heads), M_*, Q_*:
    [4, K, Hc, W]; a_*, valid_*: [4, Hc, W].  Returns
    (newM_s, newM_o, vmin_s, vmin_o).

    CUDA tensors: float32, contiguous; launches the kernel on the current
    stream without synchronising.  CPU tensors: the plain version."""
    if kernel not in (1, 2):
        raise ValueError(f"Unknown smoothness kernel {kernel!r}")
    if not gD_s.is_cuda:
        return phase_messages_compact_ref(gD_s, gDn, M_s, M_o, Q_s, Q_o,
                                          D0_s, D0_o, a_s, a_o, valid_s,
                                          valid_o, tol, kernel)
    K, Hc, W = gD_s.shape
    dev = gD_s.device
    k3, k4, p3 = (K, Hc, W), (NUM_DIRS, K, Hc, W), (NUM_DIRS, Hc, W)
    args = (("gD_s", gD_s, k3), ("gDn", gDn, k4), ("M_s", M_s, k4),
            ("M_o", M_o, k4), ("Q_s", Q_s, k4), ("Q_o", Q_o, k4),
            ("D0_s", D0_s, k3), ("D0_o", D0_o, k3), ("a_s", a_s, p3),
            ("a_o", a_o, p3), ("valid_s", valid_s, p3),
            ("valid_o", valid_o, p3))
    for name, t, shape in args:
        _check(name, t, shape, dev)
    lib = _library()
    newMs = torch.empty(k4, dtype=torch.float32, device=dev)
    newMo = torch.empty(k4, dtype=torch.float32, device=dev)
    vmins = torch.empty(p3, dtype=torch.float32, device=dev)
    vmino = torch.empty(p3, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.phase_messages_compact_f32(
            *(t.data_ptr() for _, t, _ in args), newMs.data_ptr(),
            newMo.data_ptr(), vmins.data_ptr(), vmino.data_ptr(),
            float(tol), int(kernel), K, Hc * W, stream)
    if code != 0:
        _launch_failed("phase_messages_compact", code)
    phase_messages_compact.launches += 1
    return newMs, newMo, vmins, vmino


phase_messages_compact.launches = 0


def phase_messages(gD, gD_shifted, M, Q, D0, alphas, src_is_head, valid, tol,
                   kernel: int):
    """All-direction fused phase messages.

    gD, D0: [K, H, W]; gD_shifted, M, Q: [4, K, H, W]; alphas, valid:
    [4, H, W]; src_is_head: [H, W] (1.0 where the head pixel is this phase's
    source).  Returns (newM [4, K, H, W], vmins [4, H, W]).

    CUDA tensors: float32, contiguous; launches the kernel on the current
    stream without synchronising.  CPU tensors: the plain version."""
    if kernel not in (1, 2):
        raise ValueError(f"Unknown smoothness kernel {kernel!r}")
    if not gD.is_cuda:
        return phase_messages_ref(gD, gD_shifted, M, Q, D0, alphas,
                                  src_is_head, valid, tol, kernel)
    K, H, W = gD.shape
    dev = gD.device
    k3, k4, p3 = (K, H, W), (NUM_DIRS, K, H, W), (NUM_DIRS, H, W)
    args = (("gD", gD, k3), ("gD_shifted", gD_shifted, k4), ("M", M, k4),
            ("Q", Q, k4), ("D0", D0, k3), ("alphas", alphas, p3),
            ("src_is_head", src_is_head, (H, W)), ("valid", valid, p3))
    for name, t, shape in args:
        _check(name, t, shape, dev)
    lib = _library()
    newM = torch.empty(k4, dtype=torch.float32, device=dev)
    vmins = torch.empty(p3, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.phase_messages_f32(
            *(t.data_ptr() for _, t, _ in args), newM.data_ptr(),
            vmins.data_ptr(), float(tol), int(kernel), K, H, W, stream)
    if code != 0:
        _launch_failed("phase_messages", code)
    phase_messages.launches += 1
    return newM, vmins


phase_messages.launches = 0
