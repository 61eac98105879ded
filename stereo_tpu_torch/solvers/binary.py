"""Binary fusion moves on the pixel grid (port of stereo_tpu/solvers/binary.py).

A fusion move is a 2-label MRF whose pairwise terms are in the same
truncated-distance family as the multi-label problem, so checkerboard TRW-S
doubles as the fusion solver with K = 2.  For binary pairwise MRFs the TRW-S
dual optimum coincides with the roof-duality (QPBO) bound.

K = 2 specialization: a normalized 2-vector message has one degree of
freedom, so each directed-edge buffer is a single signed plane ``md`` with
(msg0, msg1) = (relu(-md), relu(md)); the 2x2 pairwise tables are precomputed
once per move as 16 [H, W] planes.  Every phase is a short chain of
elementwise min/add ops on [H, W] planes.  A block of phases with its bound,
decode and energy (``_k2_block``, plain PyTorch) runs on the card as one
launch of a hand-written kernel (``ops/k2_block.py``); the JAX package has no
kernel here, XLA fuses its plain jnp.

Move acceptance: the decoded labeling's "take" mask is split into 4-connected
components; distinct components share no edge, so the energy delta of
flipping each is independent and exactly additive, and exactly the components
whose delta is <= 0 are accepted.  The never-increase invariant holds by
construction and is enforced unconditionally at the end of ``binary_fuse``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from stereo_tpu_torch import geometry
from stereo_tpu_torch.device import acc_dtype
from stereo_tpu_torch.energy import (default_weights, normalized,
                                     truncated_kernel)
from stereo_tpu_torch.geometry import NUM_DIRS, OPP
from stereo_tpu_torch.ops.k2_block import k2_block
from stereo_tpu_torch.solvers import trws
from stereo_tpu_torch.utils.profiling import span


class FusionResult(NamedTuple):
    take: torch.Tensor  # [H, W] bool: where to adopt the proposal
    energy: torch.Tensor  # energy of the accepted configuration
    lower_bound: torch.Tensor  # TRW-S/roof-duality style lower bound
    iterations: int


def fusion_problem(current_planes, proposal_planes,
                   normalize: tuple | None = None, x0: int = 0):
    """Build the K=2 label geometry for a fusion move.

    Returns (D0 [2,H,W], Q [4,2,H,W]): label 0 = current, 1 = proposal;
    positions are the continuous disparities entering the pairwise terms.
    ``x0``: the global column of column 0 (geometry.grid_points)."""

    def own(planes):
        return normalized(geometry.own_disparity(planes, x0), normalize)

    def nbr(planes, d):
        return normalized(
            geometry.neighbor_plane_disparity(planes, d, fill=0.0, x0=x0),
            normalize)

    D0 = torch.stack([own(current_planes), own(proposal_planes)], dim=0)
    Q = torch.stack(
        [torch.stack([nbr(current_planes, d), nbr(proposal_planes, d)], dim=0)
         for d in range(NUM_DIRS)], dim=0)
    return D0, Q


def _tables(D0, Q, alphas, kernel, tol):
    """Per-direction 2x2 pairwise tables V[d][i, j] = alpha_d * TR(|Q_i - D0_j|).

    i = tail label, j = head label.  Shape [4, 2, 2, H, W]; zero at invalid
    border edges because alphas is zero there."""
    V = []
    for d in range(NUM_DIRS):
        rows = []
        for i in range(2):
            rows.append(torch.stack(
                [alphas[d] * truncated_kernel(Q[d, i] - D0[j], kernel, tol)
                 for j in range(2)], dim=0))
        V.append(torch.stack(rows, dim=0))
    return torch.stack(V, dim=0)


def _split(md):
    """Signed message plane -> (msg0, msg1), both >= 0 with min = 0."""
    return torch.clamp_min(-md, 0), torch.clamp_min(md, 0)


def _beliefs(theta0, theta1, M):
    """Beliefs (D0b, D1b): theta + all 8 incident buffers."""
    D0b, D1b = theta0, theta1
    for d in range(NUM_DIRS):
        m0, m1 = _split(M[d])
        D0b = D0b + m0
        D1b = D1b + m1
        o0, o1 = _split(geometry.shift_from_neighbor(M[OPP[d]], d, fill=0.0))
        D0b = D0b + o0
        D1b = D1b + o1
    return D0b, D1b


def _k2_phase(theta0, theta1, M, V, gamma, valid, phase_mask, accumulate_lb,
              own=None):
    """One checkerboard half-iteration at K=2 (mirrors trws._phase; ``own``
    limits the lb terms to a column shard's pixels)."""
    acc_t = acc_dtype(theta0.dtype)
    D0b, D1b = _beliefs(theta0, theta1, M)

    lb_nodes = torch.zeros((), dtype=acc_t, device=theta0.device)
    if accumulate_lb:
        vminD = torch.minimum(D0b, D1b)
        D0b = D0b - vminD
        D1b = D1b - vminD
        lb_nodes = trws._masked_sum(trws._and_own(phase_mask, own), vminD)

    gD0 = gamma * D0b
    gD1 = gamma * D1b

    newM = []
    lb_msgs = torch.zeros((), dtype=acc_t, device=theta0.device)
    for d in range(NUM_DIRS):
        m0, m1 = _split(M[d])
        # variant B (source = head p): msg[i] = min_j(gD_j - m_j + V[i, j])
        HB0 = gD0 - m0
        HB1 = gD1 - m1
        bmsg0 = torch.minimum(HB0 + V[d, 0, 0], HB1 + V[d, 0, 1])
        bmsg1 = torch.minimum(HB0 + V[d, 1, 0], HB1 + V[d, 1, 1])
        # variant A (source = tail n): msg[j] = min_i(gD'_i - m_i + V[i, j])
        HA0 = geometry.shift_from_neighbor(gD0, d, fill=0.0) - m0
        HA1 = geometry.shift_from_neighbor(gD1, d, fill=0.0) - m1
        amsg0 = torch.minimum(HA0 + V[d, 0, 0], HA1 + V[d, 1, 0])
        amsg1 = torch.minimum(HA0 + V[d, 0, 1], HA1 + V[d, 1, 1])

        msg0 = torch.where(phase_mask, bmsg0, amsg0)
        msg1 = torch.where(phase_mask, bmsg1, amsg1)
        vmin = torch.minimum(msg0, msg1)
        newM.append((msg1 - msg0) * valid[d])
        if accumulate_lb:
            lb_msgs = lb_msgs + trws._masked_sum(
                trws._and_own(valid[d] > 0, own), vmin)
    return torch.stack(newM, dim=0), lb_nodes + lb_msgs


def _k2_decode(theta0, theta1, M, V, cb):
    """Greedy conditioned decode (mirrors trws._decode at K=2)."""
    D0b, D1b = _beliefs(theta0, theta1, M)
    z_black = D1b < D0b

    cost0, cost1 = theta0, theta1
    for d in range(NUM_DIRS):
        zn = geometry.shift_from_neighbor(z_black, d, fill=False)
        # in-edge E(p, d): V(z_n, j)
        cost0 = cost0 + torch.where(zn, V[d, 1, 0], V[d, 0, 0])
        cost1 = cost1 + torch.where(zn, V[d, 1, 1], V[d, 0, 1])
        # out-edge E(n, OPP(d)) at neighbor n: V[OPP(d)](i, z_black(n'))
        t0 = torch.where(z_black, V[OPP[d], 0, 1], V[OPP[d], 0, 0])
        t1 = torch.where(z_black, V[OPP[d], 1, 1], V[OPP[d], 1, 0])
        cost0 = cost0 + geometry.shift_from_neighbor(t0, d, fill=0.0)
        cost1 = cost1 + geometry.shift_from_neighbor(t1, d, fill=0.0)
    z_white = cost1 < cost0
    return torch.where(cb == 0, z_black, z_white)


def _edge_cost(Vd, zn, z):
    """Directed-edge cost V[d][tail=zn, head=z] for boolean labelings."""
    return torch.where(
        zn,
        torch.where(z, Vd[1, 1], Vd[1, 0]),
        torch.where(z, Vd[0, 1], Vd[0, 0]),
    )


def _k2_energy(z, theta0, theta1, V, own=None):
    """Exact energy of a 0/1 labeling under the precomputed tables (with
    ``own``, the part at a column shard's pixels: see trws.labeling_energy).
    """
    E = trws._own_sum(own, torch.where(z, theta1, theta0))
    for d in range(NUM_DIRS):
        zn = geometry.shift_from_neighbor(z, d, fill=False)
        E = E + trws._own_sum(own, _edge_cost(V[d], zn, z))
    return E


def _k2_block(theta0, theta1, M, V, gamma, valid, cb, check_every: int):
    """One block of the K = 2 TRW-S: ``check_every`` phase pairs from the
    messages ``M``, the bound, the decode and the decoded labelling's energy
    -> (M, lb, z, energy).  The plain version of ops/k2_block.py::k2_block,
    which binary_fuse calls (this on a CPU problem, the kernel on the
    card)."""
    black = cb == 0
    white = cb == 1
    for _ in range(check_every):
        M, _ = _k2_phase(theta0, theta1, M, V, gamma, valid, black,
                         accumulate_lb=False)
        M, lb_sweep = _k2_phase(theta0, theta1, M, V, gamma, valid, white,
                                accumulate_lb=True)
    # blacks contribute their belief minima (as in trws.solve)
    D0b, D1b = _beliefs(theta0, theta1, M)
    lb = lb_sweep + trws._masked_sum(black, torch.minimum(D0b, D1b))
    z = _k2_decode(theta0, theta1, M, V, cb)
    return M, lb, z, _k2_energy(z, theta0, theta1, V)


def _shift_in(v, k, axis, fill):
    """Bring ``v[i - k]`` to position ``i`` along ``axis`` (k may be
    negative); vacated entries get ``fill``.  No wrap."""
    n = v.shape[axis]
    out = torch.full_like(v, fill)
    if abs(k) >= n:
        return out
    if k >= 0:
        out.narrow(axis, k, n - k).copy_(v.narrow(axis, 0, n - k))
    else:
        out.narrow(axis, 0, n + k).copy_(v.narrow(axis, -k, n + k))
    return out


def _segmented_min_scan(m, live, axis, reverse):
    """Running min of ``m`` within contiguous runs of ``live`` along ``axis``.

    Dead (not live) entries break runs.  Associative monoid on (min, wall):
    combine(a, b) = (b.wall ? b.min : min(a.min, b.min), a.wall | b.wall),
    computed by explicit shift-doubling: each of the log2(n) steps is two
    shifts + select/min."""
    big = (torch.iinfo(m.dtype).max if not m.dtype.is_floating_point
           else float("inf"))
    v = m
    b = ~live
    n = m.shape[axis]
    k = 1
    d = -1 if reverse else 1
    while k < n:
        # prefix contribution from distance k: identity (big, False) when
        # out of range, so border entries keep their value
        vs = _shift_in(v, d * k, axis, big)
        bs = _shift_in(b, d * k, axis, False)
        v = torch.where(b, v, torch.minimum(v, vs))
        b = b | bs
        k *= 2
    return v


def connected_components(z: torch.Tensor) -> torch.Tensor:
    """4-connected component ids of a boolean mask.

    Returns [H, W] int32: for z pixels, the smallest flat pixel index in the
    component; H*W elsewhere.  Each round floods the current min id along
    entire rows and columns via segmented scans; converges in O(#bends of the
    windiest component) rounds, which is 1-3 for real fusion take-masks.  One
    host synchronisation per round (the convergence test)."""
    H, W = z.shape
    N = H * W
    idx = torch.arange(N, dtype=torch.int32, device=z.device).reshape(H, W)
    n_t = torch.full((), N, dtype=torch.int32, device=z.device)
    comp = torch.where(z, idx, n_t)

    def flood(comp):
        for axis in (1, 0):
            for reverse in (False, True):
                s = _segmented_min_scan(comp, z, axis, reverse)
                comp = torch.where(z, torch.minimum(comp, s), n_t)
        return comp

    def not_uniform(comp):
        bad = torch.zeros((), dtype=torch.bool, device=z.device)
        for d in range(NUM_DIRS):
            zn = geometry.shift_from_neighbor(z, d, fill=False)
            cn = geometry.shift_from_neighbor(comp, d, fill=N)
            bad = bad | torch.any(z & zn & (comp != cn))
        return bool(bad)

    # Cap the rounds at H + W (covers any spiral; real masks take 1-3).  An
    # early exit can split a component into edge-adjacent pieces — still safe:
    # accept_components then decides the pieces independently, and the
    # never-increase backstop in binary_fuse guards the (pathological) case
    # where that split accept would be worse than keeping the incumbent.
    comp = flood(comp)
    rounds = 0
    while rounds < H + W and not_uniform(comp):
        comp = flood(comp)
        rounds += 1
    return comp


def _segment_verdicts_sorted(comp_flat, delta_flat, acc_t):
    """Per-pixel verdict (segment sum <= 0) via a stable sort + segmented
    scan — deterministic on a CUDA device (no atomics):

      1. stable sort of (comp, delta, iota) by comp
      2. within-segment prefix sums by shift-doubling over the monoid
         (boundary flag, sum) — no subtraction of running totals, so no
         cancellation
      3. each segment's total is the prefix at its end; every element looks
         it up through the index of the next segment end (reverse cummin)
      4. the verdicts go back through the sort permutation (unique indices)
    """
    N = comp_flat.shape[0]
    dev = comp_flat.device
    skeys, sidx = torch.sort(comp_flat, stable=True)
    v = delta_flat.to(acc_t)[sidx]
    change = skeys[1:] != skeys[:-1]
    one = torch.ones((1,), dtype=torch.bool, device=dev)
    f = torch.cat([one, change])  # segment starts
    k = 1
    while k < N:
        vs = _shift_in(v, k, 0, 0.0)
        fs = _shift_in(f, k, 0, True)
        v = torch.where(f, v, v + vs)
        f = f | fs
        k *= 2
    ends = torch.cat([change, one])
    iota = torch.arange(N, device=dev)
    end_pos = torch.where(ends, iota, torch.full_like(iota, N))
    end_pos = torch.cummin(end_pos.flip(0), dim=0).values.flip(0)
    good_sorted = v[end_pos] <= 0.0
    good = torch.zeros((N,), dtype=torch.bool, device=dev)
    good[sidx] = good_sorted
    return good


def _flip_delta(z, theta0, theta1, V):
    """Per-pixel energy delta of flipping ``z``'s pixels, every contribution
    folded onto one z pixel (accumulated in promote(dtype, float32)):

      - a z pixel owns its unary delta and all incident edge deltas,
      - an edge whose head keeps but whose tail flips is pushed back to the
        tail pixel (the only flipping endpoint) elementwise.

    A pixel's value reads z two columns away."""
    acc_t = acc_dtype(theta0.dtype)
    zero = torch.zeros((), dtype=acc_t, device=z.device)
    delta = torch.where(z, theta1 - theta0, zero.to(theta0.dtype)).to(acc_t)
    for d in range(NUM_DIRS):
        zn = geometry.shift_from_neighbor(z, d, fill=False)
        dE = (_edge_cost(V[d], zn, z) - V[d, 0, 0]).to(acc_t)
        delta = delta + torch.where(z, dE, zero)
        push = torch.where(~z & zn, dE, zero)
        # out[p + DIRS[d]] = push[p]: the inverse shift brings the delta to
        # the tail pixel
        delta = delta + geometry.shift_from_neighbor(push, OPP[d], fill=0.0)
    return delta


def accept_components(z, theta0, theta1, V, method: str | None = None):
    """Filter a decoded take-mask to its energy-improving components.

    Flipping a 4-connected component S of ``z`` changes the energy by a sum
    of per-pixel unary deltas plus per-edge deltas; distinct components share
    no edge, so the deltas are independent.

    ``method``: 'scatter' (one ``index_add_`` segment sum + verdict gather)
    or 'sort' (stable sort + segmented scan, see _segment_verdicts_sorted).
    Default: 'sort' on a CUDA device, where ``index_add_`` sums float32 with
    atomics in an order that changes from run to run while the verdict
    ``sums <= 0`` is a knife-edge; 'scatter' on the CPU, where it is
    sequential and therefore deterministic (and what the JAX package runs
    off the TPU)."""
    if method is None:
        method = "sort" if z.is_cuda else "scatter"
    H, W = z.shape
    N = H * W
    comp = connected_components(z)
    acc_t = acc_dtype(theta0.dtype)
    delta = _flip_delta(z, theta0, theta1, V)

    if method == "sort":
        good_px = _segment_verdicts_sorted(comp.reshape(-1),
                                           delta.reshape(-1), acc_t)
        return z & good_px.reshape(H, W)
    if method != "scatter":
        raise ValueError(f"unknown accept method {method!r}")
    comp_l = comp.reshape(-1).long()
    sums = torch.zeros((N + 1,), dtype=acc_t, device=z.device)
    sums.index_add_(0, comp_l, delta.reshape(-1))
    good = sums <= 0.0
    return z & good[comp_l].reshape(H, W)


def icm_polish(z, theta0, theta1, V, cb, n_sweeps: int):
    """Checkerboard ICM on a take-mask: set every phase-color pixel to its
    exact conditional argmin given the (fixed) opposite color.  The energy is
    non-increasing per phase (no two resolved pixels share an edge)."""
    d_unary = theta1 - theta0

    def phase(z, color_mask):
        delta = d_unary
        for d in range(NUM_DIRS):
            zn = geometry.shift_from_neighbor(z, d, fill=False)
            # in-edge E(p, d): head p flips, tail fixed at zn
            delta = delta + torch.where(zn, V[d, 1, 1] - V[d, 1, 0],
                                        V[d, 0, 1] - V[d, 0, 0])
            # out-edge at q = p - DIRS[d] (p is its tail; head fixed at z_q)
            g = torch.where(z, V[d, 1, 1] - V[d, 0, 1],
                            V[d, 1, 0] - V[d, 0, 0])
            delta = delta + geometry.shift_from_neighbor(g, OPP[d], fill=0.0)
        return torch.where(color_mask, delta < 0, z)

    for _ in range(n_sweeps):
        z = phase(z, cb == 0)
        z = phase(z, cb == 1)
    return z


def _attributed_cost(z, theta0, theta1, V, in_blk):
    """Per-pixel cost map whose sum over any pixel set S = in_blk counts
    every edge touching S exactly once: head-in edges at the head (internal
    edges included once there), tail-in/head-out edges at the tail."""
    zero = torch.zeros((), dtype=theta0.dtype, device=z.device)
    c = torch.where(z, theta1, theta0)
    for d in range(NUM_DIRS):
        zn = geometry.shift_from_neighbor(z, d, fill=False)
        ec = _edge_cost(V[d], zn, z)
        c = c + torch.where(in_blk, ec, zero)
        in_n = geometry.shift_from_neighbor(in_blk, d, fill=False)
        push = torch.where(~in_blk & in_n, ec, zero)
        c = c + geometry.shift_from_neighbor(push, OPP[d], fill=0.0)
    return c


def _block_resolve_aligned(z, theta0, theta1, V, par):
    """Exactly resolve every (0,0)-aligned 2x2 block of parity ``par``:
    each active block picks the best of its 16 cell patterns given the rest
    of the labeling fixed.  Blocks of one parity share no 4-edges, so the
    simultaneous argmin is the exact conditional optimum and never increases
    the energy.  H, W must be even (block_polish pads)."""
    H, W = z.shape
    dev = z.device
    yi = torch.arange(H, device=dev)[:, None]
    xi = torch.arange(W, device=dev)[None, :]
    cell = (yi % 2) * 2 + xi % 2
    active = (yi // 2 + xi // 2) % 2 == par
    zero = torch.zeros((), dtype=theta0.dtype, device=dev)
    sums = []
    for p in range(16):
        bit = (torch.full_like(cell, p) >> cell) & 1
        zp = torch.where(active, bit == 1, z)
        ac = torch.where(active,
                         _attributed_cost(zp, theta0, theta1, V, active),
                         zero)
        sums.append(ac.reshape(H // 2, 2, W // 2, 2).sum(dim=(1, 3)))
    pbest = torch.argmin(torch.stack(sums, 0), dim=0)
    pb = pbest.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
    bit = (pb >> cell) & 1
    return torch.where(active, bit == 1, z)


def block_polish(z, theta0, theta1, V, rounds: int = 1):
    """Exact 2x2-block resolve over a block-checkerboard, all 4 offsets.

    Where icm_polish resolves single pixels, this resolves every 2x2 window
    (at each of the 4 alignments) exactly.  Monotone by construction: every
    phase is an exact conditional argmin over non-adjacent blocks."""
    H, W = z.shape
    for _ in range(rounds):
        for oy in (0, 1):
            for ox in (0, 1):
                Hp = -(-(H + oy) // 2) * 2
                Wp = -(-(W + ox) // 2) * 2
                pads = (ox, Wp - W - ox, oy, Hp - H - oy)
                # zero-padding V makes pad-edges free and pad unaries equal,
                # so padded cells ride in their blocks at zero cost
                pz = F.pad(z, pads)
                pt0 = F.pad(theta0, pads)
                pt1 = F.pad(theta1, pads)
                pV = F.pad(V, pads)
                for par in (0, 1):
                    pz = _block_resolve_aligned(pz, pt0, pt1, pV, par)
                z = pz[oy:oy + H, ox:ox + W]
    return z


def binary_fuse(
    unary0: torch.Tensor,  # [H, W] unary cost of keeping the current label
    unary1: torch.Tensor,  # [H, W] unary cost of taking the proposal
    D0: torch.Tensor,  # [2, H, W] from fusion_problem
    Q: torch.Tensor,  # [4, 2, H, W]
    alphas: torch.Tensor,  # [4, H, W]
    *,
    kernel: int,
    tol,
    maxiter: int = 50,
    max_relgap: float = 1e-6,
    current_energy=None,
    check_every: int = 5,
    improve: int = 0,
    accept_method: str | None = None,
) -> FusionResult:
    """One fusion move; never increases the energy.

    The never-increase guarantee is enforced unconditionally: the energy of
    keeping the incumbent (all-False take) is one extra table evaluation, and
    the whole move reverts whenever the accepted configuration would exceed
    it — this covers both float32 rounding of the per-component sums and the
    (pathological) case where the connected-component flood hits its round
    cap.  ``current_energy``, when provided, additionally caps the reported
    energy at the caller's incumbent value.  ``improve`` > 0 runs that many
    checkerboard-ICM polish sweeps plus one 2x2-block resolve on the decoded
    mask before acceptance."""
    H, W = unary0.shape
    dtype, dev = unary0.dtype, unary0.device
    # the card's block kernel reads raw pointers
    theta0, theta1 = unary0.contiguous(), unary1.contiguous()
    with span("fusion.k2_pack"):
        V = _tables(D0, Q, alphas, kernel, tol)
        cb = trws.checkerboard(H, W, device=dev)
        gamma = trws.node_gamma(H, W, dtype, device=dev)
        valid = default_weights(H, W, dtype, device=dev)
        M = torch.zeros((NUM_DIRS, H, W), dtype=dtype, device=dev)
        acc_t = acc_dtype(dtype)
        zero = torch.zeros((), dtype=acc_t, device=dev)
        energy, lb = zero, zero
        z = torch.zeros((H, W), dtype=torch.bool, device=dev)
    it = 0
    while it < maxiter and (it == 0 or trws._gap_open(
            energy, lb, max_relgap, "fusion.k2_stop")):
        with span("fusion.k2_sweeps"):
            M, lb, z, energy = k2_block(theta0, theta1, M, V, gamma, valid,
                                        cb, check_every)
        it += check_every

    with span("fusion.accept"):
        if improve:
            z = icm_polish(z, theta0, theta1, V, cb, improve)
            z = block_polish(z, theta0, theta1, V, rounds=1)
        # per-component acceptance: flip exactly the improving components
        take = accept_components(z, theta0, theta1, V, method=accept_method)
        energy = _k2_energy(take, theta0, theta1, V)
        # unconditional never-increase backstop (see docstring): revert to
        # the incumbent whenever the accepted configuration is worse than
        # keeping it
        e_keep = _k2_energy(torch.zeros_like(take), theta0, theta1, V)
        incumbent = e_keep if current_energy is None else torch.minimum(
            e_keep, torch.as_tensor(current_energy, dtype=e_keep.dtype,
                                    device=dev))
        worse = energy > incumbent
        take = torch.where(worse, torch.zeros_like(take), take)
        energy = torch.where(worse, e_keep, energy)
    return FusionResult(take, energy, lb, it)
