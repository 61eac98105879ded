"""Min-plus message math (port of stereo_tpu/ops/minplus.py).

For every pixel and an edge family with source positions P[K], dest positions
R[K], weight alpha and truncation tol:

    msgA[j] = min_i ( H_A[i] + alpha * TR(|P[i] - R[j]|) )   (source = tail)
    msgB[i] = min_j ( H_B[j] + alpha * TR(|P[i] - R[j]|) )   (source = head)

``minplus_pair`` — replaces the TPU kernel
    ``stereo_tpu/ops/minplus.py::_tile_kernel`` (``minplus_pair_pallas``).
    Both variants of one direction, un-normalised, every term
    ``alpha * TR(P[i] - R[j])`` evaluated once and used for both outputs.
    CUDA tensors go through the hand-written kernel (csrc/minplus_pair.cu),
    one launch; CPU tensors through the plain version ``minplus_pair_ref``
    (the JAX module's ``minplus_pair_xla``), which is also what the plain
    full-grid phase (ops/phase_kernel.py::phase_messages_ref) is made of.

    What bounds it on the card: K^2 label pairs of eight float32
    instructions per pixel (sub, abs or mul, min, mul, add, min, add, min)
    against (4 K + 1) planes read and 2 K written; at K = 79 the operations
    are the larger bound (PERF.md has the times).  Design: a thread block
    owns 32 pixels, thread (x, y) holds the sources i = 8 y .. 8 y + 7 of
    pixel x in registers with eight running minima of msgB (more than 96
    labels: several passes over the sources, at most 12 warps a block), the
    block stages the tile's R and H_B columns in shared memory (in global
    scratch when K is too large for it), walks j over them in chunks of
    eight and reduces each chunk's msgA minima over threadIdx.y in shared
    memory.  It takes every K.  Nothing of the TPU kernel's (K, 8, 128)
    tiles or its padding to them is carried over: K and the plane size are
    runtime arguments and the ragged edges are guarded by index.  Built with
    ``-fmad=false``: float32 results equal the plain version's bit for bit.
    Inputs must be finite (fminf drops a NaN that torch.minimum keeps); a
    pixel whose alpha is 0 still yields finite minima.  No single PyTorch
    call computes the function, so there is no library yardstick.
    ``minplus_pair.launches`` counts kernel launches.

``minplus_send`` — replaces the TPU kernel
    ``stereo_tpu/ops/minplus.py::_send_kernel`` (``minplus_send_pallas``).
    The one-variant send on column-shaped data, for every lane l:

        msg[t] = min_s ( hs[s] + alpha * TR(p[t] - r[s]) )     t, s < K

    minus its minimum over t, and that minimum.  It is every message update
    of the per-step sweeps of the wavefront family (solvers/wavefront.py::
    _send_head / _send_tail).  CUDA tensors go through the hand-written
    kernel (csrc/minplus_send.cu), one launch for the whole leading batch;
    CPU tensors through the plain version ``minplus_send_ref``.  The kernel
    is taken for every K: the JAX dispatcher's ``min_k`` threshold weighs a
    TPU dispatch against XLA's intermediates and does not carry over.

    What bounds it on the card: K^2 min-plus steps of six float32
    instructions per lane against (3 K + 1) planes read and (K + 1) written;
    at [2, 79, 1536] both are under a microsecond, so a launch's latency is
    what one sees (PERF.md has the times).  Design: a thread block owns 32
    lanes, thread (x, y) holds 8 running minima (targets 8 y .. 8 y + 7) of
    lane x in registers and walks the K sources, staged in shared memory (in
    global scratch when K is too large for it), once per pass (more than 96
    labels take several, at most 12 warps a block); the block reduces the
    minimum over targets in shared memory.  It takes every K.  Built with
    ``-fmad=false``: float32 results equal the plain version's bit for bit.  Inputs must be
    finite (fminf drops a NaN that torch.minimum keeps).  No single PyTorch
    call computes the function, so there is no library yardstick.
    ``minplus_send.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from stereo_tpu_torch.energy import truncated_kernel
from stereo_tpu_torch.ops._launch import check_tensor, launch_staged

# the send kernels split the K targets into blocks of KT over threadIdx.y
# (csrc/minplus.cuh): a thread block is TILE lanes x target_blocks(K) warps,
# at most MAX_TB; more than MAX_TB * KT labels take several passes
TILE = 32
KT = 8
MAX_TB = 12


def target_blocks(K: int) -> int:
    """Warps of a send block for K labels (csrc/minplus.cuh's
    ``target_blocks``): ceil(K / KT) up to MAX_TB, else the fewest passes of
    at most MAX_TB warps, the target blocks spread evenly."""
    blocks = -(-K // KT)
    passes = -(-blocks // MAX_TB)
    return -(-blocks // passes)


def minplus_pair_ref(H_A, H_B, P, R, alpha, tol, kernel: int):
    """Plain PyTorch pair; same contract as ``minplus_pair``."""
    K = P.shape[0]
    msgA = []
    accB = torch.full_like(H_B, float("inf"))
    for j in range(K):
        term = alpha[None] * truncated_kernel(P - R[j][None], kernel, tol)
        msgA.append(torch.min(H_A + term, dim=0).values)
        accB = torch.minimum(accB, H_B[j][None] + term)
    return torch.stack(msgA, dim=0), accB


# ------------------------------------------------------------ column send
def _broadcast_send_args(hs, p, r, alpha):
    """All four arguments with one common leading shape: [lead, K, L] x 3
    and [lead, L]."""
    K, L = hs.shape[-2:]
    lead = torch.broadcast_shapes(hs.shape[:-2], p.shape[:-2], r.shape[:-2],
                                  alpha.shape[:-1])
    hs, p, r = (t.expand(lead + (K, L)) for t in (hs, p, r))
    return lead, hs, p, r, alpha.expand(lead + (L,))


def minplus_send_ref(hs, p, r, alpha, tol, kernel: int):
    """Plain PyTorch column send; same contract as ``minplus_send``.  One
    dense [..., K_s, K_t, L] tensor."""
    _, hs, p, r, alpha = _broadcast_send_args(hs, p, r, alpha)
    term = alpha[..., None, None, :] * truncated_kernel(
        p[..., None, :, :] - r[..., :, None, :], kernel, tol)
    acc = torch.min(hs[..., :, None, :] + term, dim=-3).values  # [.., Kt, L]
    vmin = torch.min(acc, dim=-2).values
    return acc - vmin[..., None, :], vmin


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument and result types of a built minplus_send
    library."""
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.minplus_send_f32.argtypes = (
        [ptr] * 6 + [f32, i32, i32, i32, i32, ptr, ctypes.c_longlong, ptr,
                     ptr])
    lib.minplus_send_f32.restype = i32
    return lib


def bind_pair(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument and result types of a built minplus_pair
    library."""
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    i64 = ctypes.c_longlong
    lib.minplus_pair_f32.argtypes = (
        [ptr] * 7 + [f32, i32, i32, i64, ptr, i64, ptr, ptr])
    lib.minplus_pair_f32.restype = i32
    return lib


_BINDERS = {"minplus_send": bind, "minplus_pair": bind_pair}
_libs: dict[str, ctypes.CDLL] = {}


def _library(name: str):
    """The compiled kernel ``csrc/<name>.cu``, built and bound at first
    use."""
    if name not in _libs:
        from stereo_tpu_torch.ops import _build

        _libs[name] = _BINDERS[name](_build.load(name))
    return _libs[name]


def minplus_pair(H_A, H_B, P, R, alpha, tol, kernel: int):
    """Both min-plus variants of one direction.

    H_A, H_B (source heights of the two variants), P, R (positions):
    [K, H, W]; alpha: [H, W].  Returns (msgA, msgB), each [K, H, W],
    un-normalised.

    CUDA tensors: float32, contiguous; one kernel launch on the current
    stream, no synchronisation.  CPU tensors: the plain version."""
    if kernel not in (1, 2):
        raise ValueError(f"Unknown smoothness kernel {kernel!r}")
    if not P.is_cuda:
        return minplus_pair_ref(H_A, H_B, P, R, alpha, tol, kernel)
    K, H, W = P.shape
    dev = P.device
    args = (("H_A", H_A, (K, H, W)), ("H_B", H_B, (K, H, W)),
            ("P", P, (K, H, W)), ("R", R, (K, H, W)),
            ("alpha", alpha, (H, W)))
    for name, t, shape in args:
        check_tensor(name, t, shape, dev)
    lib = _library("minplus_pair")
    msgA = torch.empty((K, H, W), dtype=torch.float32, device=dev)
    msgB = torch.empty((K, H, W), dtype=torch.float32, device=dev)
    if K * H * W > 0:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream

            def call(*scratch):
                return lib.minplus_pair_f32(
                    *(t.data_ptr() for _, t, _ in args), msgA.data_ptr(),
                    msgB.data_ptr(), float(tol), int(kernel), K, H * W,
                    *scratch, stream)

            launch_staged("minplus_pair", call, dev)
        minplus_pair.launches += 1
    return msgA, msgB


minplus_pair.launches = 0


def minplus_send(hs, p, r, alpha, tol, kernel: int):
    """Column send over any leading batch.

    hs (source heights), p (target positions), r (source positions):
    [..., K, L]; alpha: [..., L]; the leading axes broadcast.  Returns
    (msg [..., K, L] with its minimum over K subtracted, vmin [..., L]).

    CUDA tensors: float32; one kernel launch on the current stream for the
    whole batch, no synchronisation (broadcast arguments are copied to the
    common shape first).  CPU tensors: the plain version."""
    if kernel not in (1, 2):
        raise ValueError(f"Unknown smoothness kernel {kernel!r}")
    if not hs.is_cuda:
        return minplus_send_ref(hs, p, r, alpha, tol, kernel)
    K, L = hs.shape[-2:]
    lead, hs, p, r, alpha = _broadcast_send_args(hs, p, r, alpha)
    dev = hs.device
    B = 1
    for n in lead:
        B *= n
    hs, p, r = (t.reshape(B, K, L).contiguous() for t in (hs, p, r))
    alpha = alpha.reshape(B, L).contiguous()
    for name, t, shape in (("hs", hs, (B, K, L)), ("p", p, (B, K, L)),
                           ("r", r, (B, K, L)), ("alpha", alpha, (B, L))):
        check_tensor(name, t, shape, dev)
    lib = _library("minplus_send")
    msg = torch.empty((B, K, L), dtype=torch.float32, device=dev)
    vmin = torch.empty((B, L), dtype=torch.float32, device=dev)
    if B * L > 0:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream

            def call(*scratch):
                return lib.minplus_send_f32(
                    hs.data_ptr(), p.data_ptr(), r.data_ptr(),
                    alpha.data_ptr(), msg.data_ptr(), vmin.data_ptr(),
                    float(tol), int(kernel), B, K, L, *scratch, stream)

            launch_staged("minplus_send", call, dev)
        minplus_send.launches += 1
    return msg.reshape(lead + (K, L)), vmin.reshape(lead + (L,))


minplus_send.launches = 0
