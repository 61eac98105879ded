"""Host (native C++) serial TRW-S: oracle and CPU baseline (port of
stereo_tpu/solvers/trws_host.py).

The trws_mex equivalent running the papers' O(K) lower-envelope message
updates on a single core, with a caller-chosen node ordering; the port's own
copy of ``trws.cpp`` (``native.lib("trws")``, built with the host's C++
compiler at first use).  Used for parity checks against the device solvers
and as the CPU reference when timing simultaneous fusion.  numpy float64 in
and out; ``grid_to_edges`` takes the dense grid problem as tensors on any
device (or numpy arrays).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from stereo_tpu_torch import geometry, native


def bipartite_order(H: int, W: int) -> np.ndarray:
    """Blacks (y+x even) before whites: the checkerboard solver's
    ordering."""
    ys, xs = np.mgrid[0:H, 0:W]
    parity = ((ys + xs) % 2).ravel()
    ids = np.arange(H * W)
    return np.concatenate([ids[parity == 0],
                           ids[parity == 1]]).astype(np.int32)


def raster_order(H: int, W: int) -> np.ndarray:
    """Row-major scan: the strong serial ordering for grids."""
    return np.arange(H * W, dtype=np.int32)


def _host(a) -> np.ndarray:
    """A tensor on any device, or an array, as float64 numpy."""
    if isinstance(a, torch.Tensor):
        a = a.detach().to("cpu", torch.float64).numpy()
    return np.asarray(a, np.float64)


def grid_to_edges(theta, D0, Q, alphas):
    """Dense grid problem -> flat host-solver arrays (vectorized).

    theta/D0: [K, H, W]; Q: [4, K, H, W]; alphas: [4, H, W].  Emits one
    directed edge per (direction, valid head pixel): tail n = p + DIRS[d],
    q_src = Q[d, :, p] (the tail's plane evaluated at p), q_dst = D0[:, p]:
    two edges per neighbour pair, the model's doubled edge list.  Returns
    (unary [K, N], tails, heads, q_src [K, E], q_dst [K, E], alphas [E]).
    """
    theta, D0, Q, alphas = map(_host, (theta, D0, Q, alphas))
    K, H, W = theta.shape
    nid = np.arange(H * W).reshape(H, W)
    tails, heads, q_src, q_dst, al = [], [], [], [], []
    for d, (dy, dx) in enumerate(geometry.DIRS):
        valid = geometry.valid_mask(H, W, d, device="cpu").numpy()
        ys, xs = np.nonzero(valid)
        tails.append(nid[ys + dy, xs + dx])
        heads.append(nid[ys, xs])
        al.append(alphas[d, ys, xs])
        q_src.append(Q[d][:, ys, xs])
        q_dst.append(D0[:, ys, xs])
    return (
        theta.reshape(K, -1),
        np.concatenate(tails).astype(np.int32),
        np.concatenate(heads).astype(np.int32),
        np.concatenate(q_src, axis=1),
        np.concatenate(q_dst, axis=1),
        np.concatenate(al),
    )


def solve(kernel, unary, tails, heads, q_src, q_dst, alphas, tol, order,
          maxiter=1000, max_relgap=1e-4, trace=False):
    """unary: [K, N] node costs; q_src/q_dst: [K, E]; returns
    (labels [N], energy, lower_bound, iterations); with ``trace``, also a
    dict of per-iteration (energy, lower_bound, seconds) arrays."""
    unary = np.ascontiguousarray(np.asarray(unary, np.float64).T)  # node-major
    q_src = np.ascontiguousarray(np.asarray(q_src, np.float64).T)  # edge-major
    q_dst = np.ascontiguousarray(np.asarray(q_dst, np.float64).T)
    tails = np.ascontiguousarray(tails, np.int32)
    heads = np.ascontiguousarray(heads, np.int32)
    alphas = np.ascontiguousarray(alphas, np.float64)
    order = np.ascontiguousarray(order, np.int32)
    N, K = unary.shape
    E = len(tails)
    if q_src.shape != (E, K) or q_dst.shape != (E, K):
        raise ValueError(f"q_src / q_dst: {q_src.shape} / {q_dst.shape}, "
                         f"expected {(K, E)} each")
    if len(order) != N or heads.shape != (E,) or alphas.shape != (E,):
        raise ValueError("order, heads or alphas disagree with the problem "
                         "size")
    if not np.array_equal(np.sort(order), np.arange(N, dtype=np.int32)):
        raise ValueError("order is not a permutation of the nodes")
    if E and (min(tails.min(), heads.min()) < 0
              or max(tails.max(), heads.max()) >= N):
        raise ValueError("edge endpoint out of range")

    labels = np.zeros(N, np.int32)
    energy = ctypes.c_double()
    lb = ctypes.c_double()
    L = native.lib("trws")
    f64p = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int32)
    if trace:
        tr_e = np.zeros(maxiter, np.float64)
        tr_lb = np.zeros(maxiter, np.float64)
        tr_t = np.zeros(maxiter, np.float64)
        tr_args = [a.ctypes.data_as(f64p) for a in (tr_e, tr_lb, tr_t)]
    else:
        null = ctypes.cast(None, f64p)
        tr_args = [null, null, null]
    iters = L.trws_serial(
        int(kernel), K, N, E,
        unary.ctypes.data_as(f64p),
        tails.ctypes.data_as(i32p), heads.ctypes.data_as(i32p),
        q_src.ctypes.data_as(f64p), q_dst.ctypes.data_as(f64p),
        alphas.ctypes.data_as(f64p), float(tol),
        order.ctypes.data_as(i32p), int(maxiter), float(max_relgap),
        labels.ctypes.data_as(i32p), ctypes.byref(energy), ctypes.byref(lb),
        *tr_args,
    )
    out = (labels, float(energy.value), float(lb.value), int(iters))
    if trace:
        return out + ({"energy": tr_e[:iters], "lower_bound": tr_lb[:iters],
                       "seconds": tr_t[:iters]},)
    return out
