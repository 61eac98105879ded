"""Scanline-ordered TRW-S: row-sequential sweeps (port of
stereo_tpu/solvers/scanline.py).

The checkerboard schedule (solvers/trws.py) is maximally parallel but its
single-edge monotonic chains propagate information one pixel per sweep.
This module runs TRW-S under the *scanline ordering*

    rank(y, x) = (y, parity(x), x)  — rows top to bottom; within a row, even
                                       columns before odd columns —

which gives image-spanning vertical chains while keeping W/2-wide data
parallelism in every step: within a phase the source pixels are mutually
non-adjacent and share no buffers, so the parallel update equals the
sequential one and this is *exact* TRW-S for this ordering (monotone lower
bound, the same stopping rule, greedy conditioned decode).

Edge conventions as in solvers/trws.py: E(p, d) is the in-edge of p from its
DIRS[d] neighbour, with potential V(k_tail, k_head) = alpha * TR(|Q_d[k_tail]
- D0[k_head]|) measured at p; one message buffer per edge stored at the head.
Update variants, on the [K, W] row of a buffer (lanes = the W columns):
  B (source = head p):  msg[i] = min_j( gD_p[j] - M[j] + a*TR(|Q_d[i]-D0[j]|) )
  A (source = tail n):  msg[j] = min_i( gD_n[i] - M[i] + a*TR(|Q_d[i]-D0[j]|) )
Both are the column send of ``ops.minplus.minplus_send_many`` (the port of
the TPU kernel ``stereo_tpu/ops/minplus.py::_send_kernel``): B with target
positions Q_d and source positions D0, A with the two swapped (TR is even).

Forward sweep, row y: even phase: lateral pairs (E(p,L/R) B at even, A at
odd) + down pair at even (E(p,DN) B; next row E(n,UP) A); odd phase: down
pair at odd.  The backward sweep mirrors it with the up pairs, odd phase
first, accumulating the lower bound.  Every send of a phase goes through
one ``minplus_send_many`` call (6, 2, 6 and 2 problems): a row makes four
calls, a sweep 4 H.  The kernel computes every lane; the phase's column
mask and the edge validity are applied after the send, as the JAX module
does.

Layout: one ghost row of zero weights on top and bottom; four
per-direction message buffers [K, H+2, W], rows updated in place (a row
slice is read through its label stride, not copied).  The loops over
sweeps and rows are Python loops; the stopping rule costs one host
synchronisation per ``check_every`` sweeps.  With CUDA tensors the sends
launch the hand-written kernel (csrc/minplus_send.cu) or raise;
``use_kernel=False`` runs the plain version of the same calls (a comparison
aid for the tests and the on-device smoke run); CPU tensors always take
the plain version.
"""

from __future__ import annotations

import torch

from stereo_tpu_torch import geometry
from stereo_tpu_torch.device import DEFAULT_DEVICE, acc_dtype, resolve_device
from stereo_tpu_torch.energy import truncated_kernel
from stereo_tpu_torch.geometry import take_plane
from stereo_tpu_torch.ops.minplus import (minplus_send_many,
                                          minplus_send_many_ref)
from stereo_tpu_torch.solvers.trws import TRWSResult, _gap_open
from stereo_tpu_torch.utils.profiling import span

# direction indices (geometry.DIRS order)
LT, RT, UP, DN = 0, 1, 2, 3


def scanline_gamma(H: int, W: int, dtype=torch.float32,
                   device=DEFAULT_DEVICE) -> torch.Tensor:
    """gamma = 1/max(nFwd, nBwd) under the scanline ordering (two directed
    edges per neighbour pair).  [H, W]."""
    dev = resolve_device(device)
    xs = torch.arange(W, device=dev)[None, :].expand(H, W)
    ys = torch.arange(H, device=dev)[:, None].expand(H, W)
    has_l = (xs >= 1).to(dtype)
    has_r = (xs <= W - 2).to(dtype)
    has_u = (ys >= 1).to(dtype)
    has_d = (ys <= H - 2).to(dtype)
    even = xs % 2 == 0
    n_fwd = torch.where(even, 2 * (has_l + has_r + has_d), 2 * has_d)
    n_bwd = torch.where(even, 2 * has_u, 2 * (has_u + has_l + has_r))
    return 1.0 / torch.clamp(torch.maximum(n_fwd, n_bwd), min=1.0)


def _roll_cols(x, shift: int):
    """Shift along the column axis, vacated entries zero. x: [..., W]."""
    out = torch.zeros_like(x)
    if shift > 0:
        out[..., shift:] = x[..., :-shift]
    else:
        out[..., :shift] = x[..., -shift:]
    return out


def _masked(new, old, mask_w):
    """Select new where mask (over columns), else old. new/old: [K, W]."""
    return torch.where(mask_w[None, :], new, old)


def _pad_row(a):
    """One zero ghost row on top and bottom of the trailing [H, W]."""
    return torch.nn.functional.pad(a, (0, 0, 1, 1))


class _Rows:
    """The padded problem of one solve ([..., H+2, W]) and its per-row
    views."""

    def __init__(self, unary, positions, nbr_positions, alphas, kernel, tol,
                 use_kernel):
        K, H, W = unary.shape
        dev, dtype = unary.device, unary.dtype
        self.K, self.H, self.W = K, H, W
        self.kernel, self.tol = kernel, tol
        self.device, self.dtype = dev, dtype
        self.acc_t = acc_dtype(dtype)
        self.theta = _pad_row(unary)  # [K, H+2, W]
        self.D0 = _pad_row(positions)
        self.Q = _pad_row(nbr_positions)  # [4, K, H+2, W]
        self.alphas = _pad_row(alphas)  # [4, H+2, W]
        valid = torch.stack([geometry.valid_mask(H, W, d, dtype=dtype,
                                                 device=dev)
                             for d in range(4)], 0)
        self.valid = _pad_row(valid)
        self.valid_b = self.valid > 0
        self.gamma = _pad_row(scanline_gamma(H, W, dtype, device=dev))
        even = torch.arange(W, device=dev) % 2 == 0
        self.even_w, self.odd_w = even, ~even
        self.send = minplus_send_many if use_kernel else minplus_send_many_ref

    def sends(self, problems):
        """One call of the column send for a phase's problems
        (g, m, xt, ys, alpha): [(msg, vmin)]."""
        return self.send(problems, self.tol, self.kernel)

    def beliefs(self, M, r):
        """Beliefs of padded row r: theta + all 8 incident buffers. [K, W].
        Out-edge buffers: at the left neighbour E(n,RT); right E(n,LT); up
        neighbour E(n,DN) (row r-1); down neighbour E(n,UP) (row r+1)."""
        D = self.theta[:, r]
        for d in range(4):
            D = D + M[d][:, r]
        D = D + _roll_cols(M[RT][:, r], 1)
        D = D + _roll_cols(M[LT][:, r], -1)
        D = D + M[DN][:, r - 1]
        D = D + M[UP][:, r + 1]
        return D

    # ------------------------------------------------------------ sweeps
    def fwd_row(self, M, y):
        """Forward step for real row y (padded r = y + 1)."""
        r = y + 1
        even_w, odd_w = self.even_w, self.odd_w
        gD = self.gamma[r][None, :] * self.beliefs(M, r)
        Qm = [self.Q[d][:, r] for d in range(4)]
        Qn_up = self.Q[UP][:, r + 1]
        D0m, D0n = self.D0[:, r], self.D0[:, r + 1]
        am = [self.alphas[d][r] for d in range(4)]
        an_up = self.alphas[UP][r + 1]
        vm = [self.valid[d][r] for d in range(4)]
        vn_up = self.valid[UP][r + 1]
        ML, MR, MD = M[LT][:, r], M[RT][:, r], M[DN][:, r]
        MU_next = M[UP][:, r + 1]

        # ---- even phase (sources: even columns of row y)
        (bL, _), (aL, _), (bR, _), (aR, _), (bD, _), (aU, _) = self.sends([
            (gD, ML, Qm[LT], D0m, am[LT]),  # E(p,LT) B at even
            (_roll_cols(gD, 1), ML, D0m, Qm[LT], am[LT]),  # A at odd
            (gD, MR, Qm[RT], D0m, am[RT]),
            (_roll_cols(gD, -1), MR, D0m, Qm[RT], am[RT]),
            (gD, MD, Qm[DN], D0m, am[DN]),  # E(p,DN) B at even
            # next row E(n,UP) A at even (tail = this row's pixel)
            (gD, MU_next, D0n, Qn_up, an_up)])
        newL = torch.where(even_w[None, :], bL, aL) * vm[LT][None, :]
        newR = torch.where(even_w[None, :], bR, aR) * vm[RT][None, :]
        newD = _masked(bD * vm[DN][None, :], MD, even_w)
        newUn = _masked(aU * vn_up[None, :], MU_next, even_w)
        M[LT][:, r] = newL
        M[RT][:, r] = newR
        M[DN][:, r] = newD
        M[UP][:, r + 1] = newUn

        # ---- odd phase (sources: odd columns), beliefs recomputed
        gD2 = self.gamma[r][None, :] * self.beliefs(M, r)
        (bD2, _), (aU2, _) = self.sends([
            (gD2, MD, Qm[DN], D0m, am[DN]),
            (gD2, MU_next, D0n, Qn_up, an_up)])
        newD2 = _masked(bD2 * vm[DN][None, :], MD, odd_w)
        newUn2 = _masked(aU2 * vn_up[None, :], MU_next, odd_w)
        M[DN][:, r] = newD2
        M[UP][:, r + 1] = newUn2

    def bwd_row(self, M, y):
        """Backward step for real row y; returns its lower-bound
        contribution (a scalar tensor)."""
        r = y + 1
        even_w, odd_w = self.even_w, self.odd_w
        Qm = [self.Q[d][:, r] for d in range(4)]
        Qn_dn = self.Q[DN][:, r - 1]
        D0m, D0p = self.D0[:, r], self.D0[:, r - 1]
        am = [self.alphas[d][r] for d in range(4)]
        ap_dn = self.alphas[DN][r - 1]
        vm = [self.valid[d][r] for d in range(4)]
        vbm = [self.valid_b[d][r] for d in range(4)]
        vp_dn = self.valid[DN][r - 1]
        vbp_dn = self.valid_b[DN][r - 1]
        gamma_row = self.gamma[r]
        acc_t = self.acc_t

        def lb_sum(mask, v):
            return torch.where(mask, v, 0.0).sum(dtype=acc_t)

        def phase(mask_w, lateral):
            """Process the masked pixels of row y as backward sources."""
            Dmid = self.beliefs(M, r)
            vminD = torch.min(Dmid, dim=0).values
            lb = lb_sum(mask_w, vminD)
            gD = gamma_row[None, :] * (Dmid - vminD[None, :])
            ML, MR = M[LT][:, r], M[RT][:, r]
            MU, MD_prev = M[UP][:, r], M[DN][:, r - 1]
            problems = []
            if lateral:  # lateral sends happen in the odd phase only
                problems += [
                    (gD, ML, Qm[LT], D0m, am[LT]),  # E(p,LT) B at odd
                    (gD, MR, Qm[RT], D0m, am[RT]),  # E(p,RT) B at odd
                    # A-sends into the even neighbours' lateral in-edges
                    (_roll_cols(gD, -1), MR, D0m, Qm[RT], am[RT]),
                    (_roll_cols(gD, 1), ML, D0m, Qm[LT], am[LT])]
            problems += [(gD, MU, Qm[UP], D0m, am[UP]),  # E(p,UP) B
                         # prev row E(n,DN) A at the masked columns
                         (gD, MD_prev, D0p, Qn_dn, ap_dn)]
            out = self.sends(problems)
            if lateral:
                (bL, vL), (bR, vR), (aR, vaR), (aL, vaL) = out[:4]
                newL = _masked(bL * vm[LT][None, :], ML, odd_w)
                lb = lb + lb_sum(odd_w & vbm[LT], vL)
                newR = _masked(bR * vm[RT][None, :], MR, odd_w)
                lb = lb + lb_sum(odd_w & vbm[RT], vR)
                newR = _masked(aR * vm[RT][None, :], newR, even_w)
                lb = lb + lb_sum(even_w & vbm[RT], vaR)
                newL = _masked(aL * vm[LT][None, :], newL, even_w)
                lb = lb + lb_sum(even_w & vbm[LT], vaL)
            (bU, vU), (aD, vaD) = out[-2:]
            newU = _masked(bU * vm[UP][None, :], MU, mask_w)
            lb = lb + lb_sum(mask_w & vbm[UP], vU)
            newDp = _masked(aD * vp_dn[None, :], MD_prev, mask_w)
            lb = lb + lb_sum(mask_w & vbp_dn, vaD)
            if lateral:
                M[LT][:, r] = newL
                M[RT][:, r] = newR
            M[UP][:, r] = newU
            M[DN][:, r - 1] = newDp
            return lb

        lb1 = phase(odd_w, True)
        lb2 = phase(even_w, False)
        return lb1 + lb2

    def sweep(self, M):
        """One forward and one backward pass over the rows, in place ->
        the backward pass's lower bound."""
        for y in range(self.H):
            self.fwd_row(M, y)
        lb = torch.zeros((), dtype=self.acc_t, device=self.device)
        for y in range(self.H - 1, -1, -1):
            lb = lb + self.bwd_row(M, y)
        return lb

    # ------------------------------------------------------------ decode
    def decode(self, M):
        """Greedy conditioned decode in rank order + exact energy."""
        kernel, tol = self.kernel, self.tol
        even_w = self.even_w
        H, W = self.H, self.W
        TR = lambda d: truncated_kernel(d, kernel, tol)  # noqa: E731
        sol_up = torch.zeros((W,), dtype=torch.int32, device=self.device)
        E = torch.zeros((), dtype=self.acc_t, device=self.device)
        rows = []
        for y in range(H):
            r = y + 1
            th = self.theta[:, r]
            D0m = self.D0[:, r]
            Qm = [self.Q[d][:, r] for d in range(4)]
            am = [self.alphas[d][r] for d in range(4)]
            # previous-row quantities for the out-edge up-pair term
            D0p = self.D0[:, r - 1]
            Qp_dn = self.Q[DN][:, r - 1]
            ap_dn = self.alphas[DN][r - 1]

            # up-pair terms conditioned on sol_up
            Q_up_sel = take_plane(Qm[UP], sol_up)
            db = th + am[UP][None, :] * TR(Q_up_sel[None, :] - D0m)
            D0p_sel = take_plane(D0p, sol_up)
            db = db + ap_dn[None, :] * TR(Qp_dn - D0p_sel[None, :])

            # forward messages into this row's pixels
            ML, MR = M[LT][:, r], M[RT][:, r]
            fwd_down = M[DN][:, r] + M[UP][:, r + 1]

            # even pixels: db + all six forward-edge messages -- in-laterals
            # at p, out-laterals stored at the odd neighbours (indexed by
            # p's labels after their backward B-sends), down pair
            Di_even = (db + ML + MR + _roll_cols(MR, 1) + _roll_cols(ML, -1)
                       + fwd_down)
            sol_even = torch.argmin(Di_even, dim=0).to(torch.int32)

            # odd pixels: condition laterals on the even solutions
            sol_l = _roll_cols(sol_even, 1)
            sol_r = _roll_cols(sol_even, -1)
            QL_sel = take_plane(Qm[LT], sol_l)
            db_o = db + am[LT][None, :] * TR(QL_sel[None, :] - D0m)
            QR_sel = take_plane(Qm[RT], sol_r)
            db_o = db_o + am[RT][None, :] * TR(QR_sel[None, :] - D0m)
            # out-lateral: V(k_p', sol_n) at the even neighbour n
            D0_sel_e = take_plane(D0m, sol_even)
            t_r = am[RT][None, :] * TR(Qm[RT] - D0_sel_e[None, :])
            db_o = db_o + _roll_cols(t_r, 1)  # from n = p'-1: E(n,RT)
            t_l = am[LT][None, :] * TR(Qm[LT] - D0_sel_e[None, :])
            db_o = db_o + _roll_cols(t_l, -1)  # from n = p'+1: E(n,LT)
            sol_odd = torch.argmin(db_o + fwd_down, dim=0).to(torch.int32)

            sol = torch.where(even_w, sol_even, sol_odd)
            db_final = torch.where(even_w[None, :], db, db_o)
            E = E + take_plane(db_final, sol).sum(dtype=self.acc_t)
            rows.append(sol)
            sol_up = sol
        return torch.stack(rows, 0), E


def solve_scanline(
    unary: torch.Tensor,  # [K, H, W]
    positions: torch.Tensor,  # D0 [K, H, W]
    nbr_positions: torch.Tensor,  # Q [4, K, H, W]
    alphas: torch.Tensor,  # [4, H, W]
    *,
    kernel: int,
    tol,
    maxiter: int = 1000,
    max_relgap: float = 1e-4,
    messages: torch.Tensor | None = None,  # [4, K, H, W]
    check_every: int = 1,
    use_kernel: bool = True,
) -> TRWSResult:
    """TRW-S with the scanline ordering, on the device the tensors live on;
    a drop-in alternative to trws.solve (same message layout [4, K, H, W],
    so messages warm-start across calls)."""
    with span("trws.pack"):
        rows = _Rows(unary, positions, nbr_positions, alphas, kernel, tol,
                     use_kernel)
        K, H, W = rows.K, rows.H, rows.W
        if messages is None:
            messages = torch.zeros((4, K, H, W), dtype=rows.dtype,
                                   device=rows.device)
        Mp = _pad_row(messages.to(rows.dtype))
        M = [Mp[d].contiguous() for d in range(4)]
        zero = torch.zeros((), dtype=rows.acc_t, device=rows.device)
        energy, lb = zero, zero
        labels = torch.zeros((H, W), dtype=torch.int32, device=rows.device)
    it = 0
    while it < maxiter and (it == 0 or _gap_open(energy, lb, max_relgap)):
        for _ in range(check_every):
            with span("trws.sweep"):
                lb = rows.sweep(M)
        with span("trws.decode"):
            labels, energy = rows.decode(M)
        it += check_every
    with span("trws.finish"):
        out = torch.stack(M, 0)[:, :, 1:-1, :]
    return TRWSResult(labels, energy, lb, it, out)
