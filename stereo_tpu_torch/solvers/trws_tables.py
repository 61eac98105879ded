"""Checkerboard TRW-S / BP over *explicit pairwise tables* (port of
stereo_tpu/solvers/trws_tables.py).

The vgg_trw_bp equivalent (the stock MRFEnergy edge types: general, Potts,
truncated linear, truncated quadratic): instead of the stereo papers'
continuous-position potential family, each directed edge E(p, d) carries an
explicit K x K cost table V[d, k_tail, k_head, p].  Tables may be shared:
any shape broadcastable to [4, K, K, H, W] works (e.g. [1, K, K, 1, 1] for a
single homogeneous potential), so Potts and index-distance kernels cost no
per-pixel memory.

Same bipartite ordering, gammas, lower-bound bookkeeping, stopping rule and
decode as solvers/trws.py; only the message min-plus differs.  Plain
PyTorch on the device the tensors live on: the JAX module reaches no TPU
kernel either.
"""

from __future__ import annotations

import torch

from stereo_tpu_torch import geometry
from stereo_tpu_torch.device import DEFAULT_DEVICE, acc_dtype, resolve_device
from stereo_tpu_torch.geometry import NUM_DIRS, OPP, take_plane
from stereo_tpu_torch.solvers.trws import (
    TRWSResult, _gap_open, _node_beliefs, checkerboard, node_gamma)


def potts_table(K: int, lam, dtype=torch.float32,
                device=DEFAULT_DEVICE) -> torch.Tensor:
    """lam * [k_i != k_j] (Potts).  [1, K, K, 1, 1]."""
    eye = torch.eye(K, dtype=dtype, device=resolve_device(device))
    return (lam * (1.0 - eye))[None, :, :, None, None]


def _index_distance(K, dtype, device):
    ks = torch.arange(K, dtype=dtype, device=resolve_device(device))
    return ks[:, None] - ks[None, :]


def truncated_linear_table(K: int, alpha, tol, dtype=torch.float32,
                           device=DEFAULT_DEVICE) -> torch.Tensor:
    """alpha * min(|k_i - k_j|, tol) (truncated linear).  [1, K, K, 1, 1]."""
    d = _index_distance(K, dtype, device)
    t = alpha * torch.clamp(d.abs(), max=float(tol))
    return t[None, :, :, None, None]


def truncated_quadratic_table(K: int, alpha, tol, dtype=torch.float32,
                              device=DEFAULT_DEVICE) -> torch.Tensor:
    """alpha * min((k_i - k_j)^2, tol) (truncated quadratic).
    [1, K, K, 1, 1]."""
    d = _index_distance(K, dtype, device)
    t = alpha * torch.clamp(d ** 2, max=float(tol))
    return t[None, :, :, None, None]


def _table_at(tables, d):
    """Direction-d table view, broadcast-compatible with [K, K, H, W]."""
    if tables.shape[0] == 1:
        return tables[0]
    return tables[d]


def _minplus_tables(H_src, T, source_is_tail: bool):
    """msg over the other endpoint's labels given a table T [K, K, ...].

    source_is_tail: T indexed [k_tail, k_head]; reduce over the source axis.
    H_src: [K, H, W]."""
    K = H_src.shape[0]
    out = []
    for k in range(K):
        Tk = T[:, k] if source_is_tail else T[k, :]
        out.append(torch.min(H_src + Tk, dim=0).values)
    return torch.stack(out, dim=0)


def solve_tables(
    unary: torch.Tensor,  # [K, H, W]
    tables: torch.Tensor,  # broadcastable to [4, K, K, H, W]; [d, k_tail, k_head]
    *,
    maxiter: int = 100,
    max_relgap: float = 1e-4,
    mode: str = "trws",  # "trws" | "bp"
    messages: torch.Tensor | None = None,  # [4, K, H, W]
) -> TRWSResult:
    """TRW-S (or BP) with explicit tables; contract mirrors trws.solve."""
    if mode not in ("trws", "bp"):
        raise ValueError(f"unknown mode {mode!r}")
    K, H, W = unary.shape
    dtype, dev = unary.dtype, unary.device
    theta = unary
    tables = tables.to(dtype)
    cb = checkerboard(H, W, device=dev)
    gamma = (torch.ones((H, W), dtype=dtype, device=dev) if mode == "bp"
             else node_gamma(H, W, dtype, device=dev))
    valid = torch.stack([geometry.valid_mask(H, W, d, dtype=dtype, device=dev)
                         for d in range(NUM_DIRS)], 0)
    acc_t = acc_dtype(dtype)
    zero = torch.zeros((), dtype=acc_t, device=dev)

    def masked_sum(mask, x):
        return torch.where(mask, x, 0.0).sum(dtype=acc_t)

    def phase(M, color, accumulate_lb):
        Dall = _node_beliefs(theta, M)
        phase_mask = cb == color
        lb_nodes = zero
        if accumulate_lb:
            vminD = torch.min(Dall, dim=0).values
            Dall = Dall - vminD[None]
            lb_nodes = masked_sum(phase_mask, vminD)
        gD = gamma[None] * Dall

        newM = []
        lb_msgs = zero
        for d in range(NUM_DIRS):
            T = _table_at(tables, d)
            H_A = geometry.shift_from_neighbor(gD, d, fill=0.0) - M[d]
            msgA = _minplus_tables(H_A, T, source_is_tail=True)
            H_B = gD - M[d]
            msgB = _minplus_tables(H_B, T, source_is_tail=False)
            msg = torch.where(phase_mask[None], msgB, msgA)
            vmin = torch.min(msg, dim=0).values
            newM.append((msg - vmin[None]) * valid[d][None])
            if accumulate_lb:
                lb_msgs = lb_msgs + masked_sum(valid[d] > 0, vmin)
        return torch.stack(newM, 0), lb_nodes, lb_msgs

    def full(T):
        return T.expand(K, K, H, W)

    def decode(M):
        D_black = _node_beliefs(theta, M)
        sol_black = torch.argmin(D_black, dim=0).to(torch.int32)
        cost = theta
        for d in range(NUM_DIRS):
            sol_n = geometry.shift_from_neighbor(sol_black, d, fill=0)
            # in-edge E(p, d): V_d(sol_n, k_p) * valid, over k_head
            col = take_plane(full(_table_at(tables, d)),
                             sol_n[None].expand(K, H, W))
            cost = cost + valid[d][None] * col
            # out-edge E(n, OPP(d)) at the neighbour n = p + DIRS[d]:
            # V_{OPP(d)}(k_p, sol_n) evaluated at n, brought to p
            row_t = take_plane(full(_table_at(tables, OPP[d])).transpose(0, 1),
                               sol_black[None].expand(K, H, W))  # over k_tail
            cost = cost + geometry.shift_from_neighbor(
                valid[OPP[d]][None] * row_t, d, fill=0.0)
        sol_white = torch.argmin(cost, dim=0).to(torch.int32)
        labels = torch.where(cb == 0, sol_black, sol_white)

        # exact energy of the labeling
        E = take_plane(theta, labels).sum(dtype=acc_t)
        for d in range(NUM_DIRS):
            sol_n = geometry.shift_from_neighbor(labels, d, fill=0)
            v1 = take_plane(full(_table_at(tables, d)),
                            sol_n[None].expand(K, H, W))
            v2 = take_plane(v1, labels)
            E = E + (valid[d] * v2).sum(dtype=acc_t)
        return labels, E

    accumulate = mode == "trws"
    M = (torch.zeros((NUM_DIRS, K, H, W), dtype=dtype, device=dev)
         if messages is None else messages.to(dtype))
    energy, lb = zero, zero
    labels = torch.zeros((H, W), dtype=torch.int32, device=dev)
    it = 0
    while it < maxiter and (it == 0 or _gap_open(energy, lb, max_relgap)):
        M, _, _ = phase(M, 0, False)
        M, lb_n, lb_m = phase(M, 1, accumulate)
        if accumulate:
            D_black = _node_beliefs(theta, M)
            lb = lb_n + lb_m + masked_sum(cb == 0,
                                          torch.min(D_black, dim=0).values)
        else:
            lb = zero
        labels, energy = decode(M)
        it += 1
    return TRWSResult(labels, energy, lb, it, M)
