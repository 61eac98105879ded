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

    What bounds it on the card: K^2 label pairs per pixel against (4 K + 1)
    planes read and 2 K written; at K = 79 the pairs are the larger bound
    (PERF.md has the times).  The kernel takes the truncation out of the
    pair loop for both outputs (for alpha >= 0, min_j h + a TR = min(min_j
    h + a |P - R|^k, min_j h + a tol) bit for bit; a pixel with alpha < 0
    walks the plain term), so a pair is six issued float32 instructions.
    Design: a thread block owns 32 pixels, thread (x, y) holds the sources
    i = 20 y .. 20 y + 19 of pixel x in registers with their running minima
    of msgB (more than 160 labels: several passes over the sources), the
    block stages the tile's R and H_B columns in shared memory in
    double-buffered chunks and reduces a chunk's msgA minima over
    threadIdx.y at a time.  It takes every K.  Nothing of the TPU kernel's
    (K, 8, 128) tiles or its padding to them is carried over: K and the
    plane size are runtime arguments and the ragged edges are guarded by
    index.  Built with ``-fmad=false``: float32 results equal the plain
    version's bit for bit.  Inputs must be finite (fminf drops a NaN that
    torch.minimum keeps); a pixel whose alpha is 0 still yields finite
    minima.  No single PyTorch call computes the function, so there is no
    library yardstick.  ``minplus_pair.launches`` counts kernel launches.

``minplus_send_many`` / ``minplus_send`` — replace the TPU kernel
    ``stereo_tpu/ops/minplus.py::_send_kernel`` (``minplus_send_pallas``).
    The one-variant send on column-shaped data, for every lane l:

        msg[t] = min_s ( h[s] + alpha * TR(p[t] - r[s]) )     t, s < K
        h      = g - m

    minus its minimum over t, and that minimum.  ``minplus_send_many`` takes
    the sends of one solver step, up to ``MAX_PROBLEMS`` problems with their
    own lane and batch counts, and makes them in one launch of the
    hand-written kernel (csrc/minplus_send.cu) for CUDA tensors; it is every
    message update of the per-step sweeps of the wavefront family
    (solvers/wavefront.py::_sends).  ``minplus_send`` is the one-problem
    call of the same launch.  CPU tensors go through the plain versions
    ``minplus_send_many_ref`` / ``minplus_send_ref``.  The kernel is taken
    for every K: the JAX dispatcher's ``min_k`` threshold weighs a TPU
    dispatch against XLA's intermediates and does not carry over.

    What bounds it on the card: K^2 terms per lane, four issued float32
    instructions a term once the truncation is out of the loop (as in the
    pair); a banded step at teddy K = 79 is about 9 us of them, and one
    launch in place of six is what the host saves (PERF.md has the times).
    Design: a thread block owns 32 lanes, thread (x, y) holds 20 targets of
    lane x in registers and walks the K sources, staged in shared memory in
    double-buffered chunks; a launch with fewer than two tiles per SM splits
    each tile's targets over a cluster of 2-4 blocks and reduces the minimum
    through distributed shared memory.  Operands are read through their
    strides: a broadcast one (batch stride 0) or a slice along the labels
    is not copied.  It takes every K.  Built with ``-fmad=false``: float32
    results equal the plain version's bit for bit.  Inputs must be finite
    (fminf drops a NaN that torch.minimum keeps).  No single PyTorch call
    computes the function, so there is no library yardstick.
    ``minplus_send.launches`` counts launches of the kernel, from either
    wrapper.
"""

from __future__ import annotations

import ctypes
import math
import struct

import torch

from stereo_tpu_torch.energy import truncated_kernel
from stereo_tpu_torch.ops._launch import check_tensor, launch_failed

# the cooperative send of the fused sweeps (csrc/minplus.cuh::send_lane,
# kernels 5 and 6) splits the K targets into blocks of KT over threadIdx.y: a
# thread block is TILE lanes x target_blocks(K) warps, at most MAX_TB; more
# than MAX_TB * KT labels take several passes
TILE = 32
KT = 8
MAX_TB = 12
# problems of one minplus_send_many launch at most (csrc/minplus_send.cu)
MAX_PROBLEMS = 8


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
def minplus_send_ref(hs, p, r, alpha, tol, kernel: int):
    """Plain PyTorch column send; same contract as ``minplus_send``.  One
    dense [..., K_s, K_t, L] tensor."""
    K, L = hs.shape[-2:]
    lead = torch.broadcast_shapes(hs.shape[:-2], p.shape[:-2], r.shape[:-2],
                                  alpha.shape[:-1])
    hs, p, r = (t.expand(lead + (K, L)) for t in (hs, p, r))
    alpha = alpha.expand(lead + (L,))
    term = alpha[..., None, None, :] * truncated_kernel(
        p[..., None, :, :] - r[..., :, None, :], kernel, tol)
    acc = torch.min(hs[..., :, None, :] + term, dim=-3).values  # [.., Kt, L]
    vmin = torch.min(acc, dim=-2).values
    return acc - vmin[..., None, :], vmin


def minplus_send_many_ref(problems, tol, kernel: int):
    """Plain version of ``minplus_send_many``: ``minplus_send_ref`` of each
    problem, h = g - m formed first."""
    return [minplus_send_ref(g if m is None else g - m, xt, ys, alpha, tol,
                             kernel) for g, m, xt, ys, alpha in problems]


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument and result types of a built minplus_send
    library."""
    lib.minplus_send_many_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.minplus_send_many_f32.restype = ctypes.c_int
    return lib


def bind_pair(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument and result types of a built minplus_pair
    library."""
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.minplus_pair_f32.argtypes = (
        [ptr] * 7 + [f32, i32, i32, ctypes.c_longlong, ptr])
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


def _on_device(dev: torch.device, fn):
    """``fn(stream)`` with ``dev`` current and its current stream; a device
    context only where ``dev`` is not the current device already."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return fn(torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(dev):
        return fn(torch.cuda.current_stream().cuda_stream)


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
        code = _on_device(dev, lambda stream: lib.minplus_pair_f32(
            *(t.data_ptr() for _, t, _ in args), msgA.data_ptr(),
            msgB.data_ptr(), float(tol), int(kernel), K, H * W, stream))
        if code != 0:
            launch_failed("minplus_pair", code)
        minplus_pair.launches += 1
    return msgA, msgB


minplus_pair.launches = 0


def _lead(planes, alpha) -> tuple:
    """The broadcast of the leading shapes of ``planes`` ([..., K, L]) and
    ``alpha`` ([..., L]), without ``torch.broadcast_shapes``'s cost on the
    host's path of a step."""
    ops = planes + [alpha]
    extra = [t.dim() - 2 for t in planes] + [alpha.dim() - 1]
    if max(extra) <= 1:  # a step's operands: one batch axis or none
        sizes = [t.shape[0] for t, e in zip(ops, extra) if e == 1]
        n = max(sizes, default=1)
        if any(b != 1 and b != n for b in sizes):
            raise ValueError(f"send operands do not broadcast: batches "
                             f"{sizes}")
        return (n,) if sizes else ()
    out = ()
    for t, e in zip(ops, extra):
        s = tuple(t.shape[:max(e, 0)])
        n = max(len(out), len(s))
        a, b = (1,) * (n - len(out)) + out, (1,) * (n - len(s)) + s
        if any(x != y and x != 1 and y != 1 for x, y in zip(a, b)):
            raise ValueError(f"send operands do not broadcast: {out} and "
                             f"{s}")
        out = tuple(x if y == 1 else y for x, y in zip(a, b))
    return out


def _operand(name, t, dev, lead, tail):
    """How the send kernel reads operand ``t`` as [B, *tail] (B the
    product of the problem's leading shape ``lead``): (pointer, batch
    stride, label stride, the tensor read), strides in floats.  A batch
    that ``t`` lacks or has once is read at stride 0 and a slice along the
    labels through its stride, so neither is copied; a copy is made only of
    lanes that are not contiguous or of leading axes that cannot be
    flattened into one."""
    if not (isinstance(t, torch.Tensor) and t.dtype == torch.float32
            and t.device == dev):
        check_tensor(name, t, None, dev, contiguous=False)  # raises
    shape, nd = t.shape, len(tail)
    extra = len(shape) - nd
    if extra < 0 or shape[extra:] != tail:
        raise ValueError(f"{name}: shape {tuple(shape)}, expected "
                         f"[..., {', '.join(map(str, tail))}]")
    if extra > 1 or (extra == 1 and len(lead) != 1):
        t = t.expand(lead + tail).reshape((-1,) + tail)  # a view if it can
        shape, extra = t.shape, 1
    st = t.stride()
    if tail[-1] > 1 and st[-1] != 1:
        t = t.contiguous()
        st = t.stride()
    b = st[0] if extra == 1 and shape[0] > 1 else 0
    return t.data_ptr(), b, (st[-2] if nd == 2 else 0), t


_DESC = struct.Struct("<18q")  # a problem (csrc/minplus_send.cu::Problem)


def _describe(problems, dev):
    """The descriptors of ``problems`` for csrc/minplus_send.cu (bytes;
    empty when there is no lane), the (msg, vmin) views of one new output
    buffer, and the tensors the descriptors point into (copies, where an
    operand had to be copied, live until the launch)."""
    K = problems[0][0].shape[-2]
    rows, keep, total = [], [], 0
    for g, m, xt, ys, alpha in problems:
        L = xt.shape[-1]
        lead = _lead([t for t in (g, m, xt, ys) if t is not None], alpha)
        B = math.prod(lead)
        ops = [_operand(name, t, dev, lead, (K, L)) for name, t in
               (("g", g), ("m", m), ("xt", xt), ("ys", ys)) if t is not None]
        if m is None:
            ops.insert(1, (0, 0, 0, None))
        a_ptr, a_b, _, a_t = _operand("alpha", alpha, dev, lead, (L,))
        keep += [op[3] for op in ops] + [a_t]
        rows.append(([op[0] for op in ops] + [a_ptr],
                     [s for op in ops for s in op[1:3]] + [a_b, L, B],
                     lead, L, (B * K * L, B * L), total))
        total += B * (K + 1) * L
    out = torch.empty((total,), dtype=torch.float32, device=dev)
    parts = out.split_with_sizes([n for r in rows for n in r[4]])
    base, desc, results = out.data_ptr(), [], []
    for i, (ptrs, tail, lead, L, sizes, off) in enumerate(rows):
        desc.append(_DESC.pack(*ptrs, base + 4 * off,
                               base + 4 * (off + sizes[0]), *tail))
        results.append((parts[2 * i].view(lead + (K, L)),
                        parts[2 * i + 1].view(lead + (L,))))
    return (b"".join(desc) if total else b""), results, keep


def minplus_send_many(problems, tol, kernel: int):
    """The column sends of one solver step, in one launch.

    ``problems``: 1 to ``MAX_PROBLEMS`` tuples (g, m, xt, ys, alpha) with
    g, m (source beliefs and the messages subtracted from them; m may be
    None), xt (target positions), ys (source positions): [..., K, L] and
    alpha: [..., L]; the leading axes of a problem broadcast, K is shared,
    L and the leading shape are each problem's own.  Returns, per problem,
    (msg [..., K, L] with its minimum over K subtracted, vmin [..., L]),
    as ``minplus_send`` of h = g - m.

    CUDA tensors: float32, lanes contiguous (any batch or label stride);
    one kernel launch on the current stream for all problems, no
    synchronisation.  CPU tensors: the plain version.
    ``minplus_send.launches`` counts the launches."""
    if kernel not in (1, 2):
        raise ValueError(f"Unknown smoothness kernel {kernel!r}")
    n = len(problems)
    if not 1 <= n <= MAX_PROBLEMS:
        raise ValueError(f"{n} problems, 1 to {MAX_PROBLEMS} a launch")
    if not problems[0][0].is_cuda:
        return minplus_send_many_ref(problems, tol, kernel)
    dev = problems[0][0].device
    words, results, keep = _describe(problems, dev)
    if words:
        lib = _library("minplus_send")
        K = problems[0][0].shape[-2]
        code = _on_device(dev, lambda stream: lib.minplus_send_many_f32(
            words, n, float(tol), int(kernel), K, stream))
        if code != 0:
            launch_failed("minplus_send", code)
        minplus_send.launches += 1
    return results


def minplus_send(hs, p, r, alpha, tol, kernel: int):
    """Column send over any leading batch.

    hs (source heights), p (target positions), r (source positions):
    [..., K, L]; alpha: [..., L]; the leading axes broadcast.  Returns (msg
    [..., K, L] with its minimum over K subtracted, vmin [..., L]).

    CUDA tensors: float32; one launch of the send kernel on the current
    stream (``minplus_send_many`` with one problem), no synchronisation.
    CPU tensors: the plain version."""
    if kernel not in (1, 2):
        raise ValueError(f"Unknown smoothness kernel {kernel!r}")
    if not hs.is_cuda:
        return minplus_send_ref(hs, p, r, alpha, tol, kernel)
    return minplus_send_many([(hs, None, p, r, alpha)], tol, kernel)[0]


minplus_send.launches = 0
