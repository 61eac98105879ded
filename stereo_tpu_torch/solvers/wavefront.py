"""Wavefront (anti-diagonal) TRW-S: the reference's *raster ordering*,
exactly, data-parallel (port of stereo_tpu/solvers/wavefront.py).

Serial TRW-S processes pixels in raster order; its monotonic chains span
whole rows *and* whole columns, so the lower bound converges in far fewer
sweeps than under the checkerboard ordering (solvers/trws.py), whose chains
are single edges.

Under raster order pixel (y, x) depends only on (y, x-1) and (y-1, x), both
on the previous anti-diagonal t-1 = y+x-1, and two pixels of one
anti-diagonal share no read or write buffer.  So sweeping the diagonals
t = 0 .. H+W-2 with all of diagonal t updated in parallel is *bitwise* the
sequential raster sweep.  This module does it on *skewed* arrays
(S[y, t] = A[y, t - y]: anti-diagonals become columns), stored *t-leading*
with one zero column each side, so every step touches contiguous [., K, H]
column slabs:

  - problem data: theta, D0 [T+2, K, H]; Q [T+2, 2, K, H] per direction
    group; alphas and validity [T+2, 2, H]; gamma, pix [T+2, H];
  - messages, split by the direction group each pass *writes*:
      MA [T+2, 2, K, H] = (RT, DN), written at column c by the forward pass,
      MB [T+2, 2, K, H] = (LT, UP), written at column c by the backward pass.

Exactness is pinned against the sequential oracle run in raster order
(tests/test_torch_wavefront.py).

Message and edge conventions are those of solvers/trws.py: buffer
``M[d][k]`` at pixel p holds the message on the edge (tail = p + DIRS[d] ->
head p); the potential is ``alpha * TR(|Q[d][k_tail] - D0[k_head]|)`` with
Q, D0 and alpha taken at the head.  gamma(p) = 1 / max(nFwd, nBwd): under
raster order nFwd = 2 #(later neighbours), nBwd = 2 #(earlier neighbours).

State.  ``(MA, MB)``.  **A sweep updates both tensors in place** (0.39 GB at
teddy K = 79) and returns them: clone a state that is still needed.

Two sweeps, selected by ``sweep=`` on ``solve_wavefront``:

  ``"fused"`` (the default, what the model runs): one call of
      ``ops.wavefront_kernel.sweep_wavefront`` per sweep, on the card one
      launch of the hand-written kernel (csrc/wavefront_kernel.cu).
  ``"steps"``: a Python loop over the 2 T anti-diagonal steps with PyTorch
      glue, a step's two sends through one call of
      ``ops.minplus.minplus_send_many`` (on the card one launch of the
      hand-written column send kernel, csrc/minplus_send.cu): the
      counterpart of the JAX package's scan path.

``use_kernel=False`` turns every kernel of either sweep into its plain
PyTorch version, a comparison aid for the tests and the on-device smoke run.
With CUDA tensors a kernel path launches its kernel or raises; CPU tensors
take the plain versions.  Both sweeps and both values of ``use_kernel`` give
the same messages (bit for bit in float32 on the card); the fused kernel's
lower bound is summed in another order and agrees to float32 rounding.

The one driver of solvers/trws.py runs ``solve_wavefront`` through
``_Raster``, which holds the chosen sweep.

``skew`` / ``unskew``, ``_head`` / ``_tail`` / ``_sends``, ``pick_sweep``
(the check of ``sweep=``) and the direction constants are shared with
solvers/banded.py.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stereo_tpu_torch import geometry
from stereo_tpu_torch.device import DEFAULT_DEVICE, acc_dtype, resolve_device
from stereo_tpu_torch.energy import truncated_kernel
from stereo_tpu_torch.geometry import take_plane
from stereo_tpu_torch.ops import wavefront_kernel
from stereo_tpu_torch.ops.minplus import (minplus_send_many,
                                          minplus_send_many_ref)
from stereo_tpu_torch.solvers.trws import Packed, TRWSResult, drive

LT, RT, UP, DN = 0, 1, 2, 3
# direction groups: A = (RT, DN), written by the forward pass; B = (LT, UP)
GROUP_A = (RT, DN)
GROUP_B = (LT, UP)

_SWEEPS = ("fused", "steps")


def skew(a: torch.Tensor, W: int) -> torch.Tensor:
    """[..., H, W] -> [..., H, T]: S[..., y, t] = A[..., y, t - y], zero
    where t - y is outside [0, W).  T = H + W - 1."""
    H = a.shape[-2]
    T = H + W - 1
    y = torch.arange(H, device=a.device)[:, None]
    t = torch.arange(T, device=a.device)[None, :]
    x = t - y
    valid = (x >= 0) & (x < W)
    idx = x.clamp(0, W - 1).expand(a.shape[:-1] + (T,))
    out = torch.gather(a, -1, idx)
    return torch.where(valid, out, torch.zeros((), dtype=a.dtype,
                                               device=a.device))


def unskew(s: torch.Tensor, W: int) -> torch.Tensor:
    """Inverse of skew: [..., H, T] -> [..., H, W]."""
    H = s.shape[-2]
    y = torch.arange(H, device=s.device)[:, None]
    x = torch.arange(W, device=s.device)[None, :]
    idx = (x + y).expand(s.shape[:-1] + (W,))
    return torch.gather(s, -1, idx)


def _head(gD, Mold, Q, D0, alpha):
    """Head-send: msg'[k_t] = min_{k_h}(gD[k_h] - Mold[k_h]
    + a TR(Q[k_t] - D0[k_h])), as a problem (g, m, xt, ys, alpha) of
    ``_sends``.

    gD/Mold/Q/D0: [..., K, L] (leading axes broadcast); alpha: [..., L]."""
    return gD, Mold, Q, D0, alpha


def _tail(gD_tail, Mold, Q, D0, alpha):
    """Tail-send: msg'[k_h] = min_{k_t}(gD_tail[k_t] - Mold[k_t]
    + a TR(Q[k_t] - D0[k_h])), as a problem of ``_sends``.

    The targets are the heads, so D0 and Q change places in the send (TR is
    even: |D0 - Q| = |Q - D0| exactly, and so are their squares)."""
    return gD_tail, Mold, D0, Q, alpha


def _sends(problems, kernel, tol, use_kernel=True):
    """The sends of one step (``_head`` / ``_tail`` problems), each read
    from the state before the step: one launch of the send kernel for CUDA
    tensors (``ops.minplus.minplus_send_many``), or with ``use_kernel=False``
    the plain version of the same call.  Returns, per problem, (message
    minus its minimum over the targets, that minimum)."""
    send = minplus_send_many if use_kernel else minplus_send_many_ref
    return send(problems, tol, kernel)


# ------------------------------------------------------- t-leading columns
def _tlead(a: torch.Tensor, W: int) -> torch.Tensor:
    """Skew the trailing [H, W] axes, pad one zero column each side, and move
    the t axis to the front: [..., H, W] -> [T+2, ..., H], contiguous."""
    s = F.pad(skew(a, W), (1, 1))
    return s.movedim(-1, 0).contiguous()


def _tlead_inv(a: torch.Tensor, W: int) -> torch.Tensor:
    """[T+2, ..., H] -> [..., H, W]: drop the pad columns and unskew."""
    return unskew(a.movedim(0, -1)[..., 1:-1], W)


def raster_gamma(H: int, W: int, dtype=torch.float32,
                 device=DEFAULT_DEVICE) -> torch.Tensor:
    """gamma = 1 / max(nFwd, nBwd) under raster order.  [H, W]."""
    dev = resolve_device(device)
    ys = torch.arange(H, device=dev)[:, None].expand(H, W)
    xs = torch.arange(W, device=dev)[None, :].expand(H, W)
    n_fwd = 2.0 * ((xs <= W - 2).to(dtype) + (ys <= H - 2).to(dtype))
    n_bwd = 2.0 * ((xs >= 1).to(dtype) + (ys >= 1).to(dtype))
    return 1.0 / torch.maximum(torch.maximum(n_fwd, n_bwd),
                               torch.ones((), dtype=dtype, device=dev))


def _shift_down(v):
    """v[..., y] -> v[..., y-1] (row y reads row y-1), zero at y = 0."""
    return F.pad(v, (1, 0))[..., :-1]


def _shift_up(v):
    """v[..., y] -> v[..., y+1], zero at y = H-1."""
    return F.pad(v, (0, 1))[..., 1:]


class _Skewed:
    """Skewed, t-leading, column-padded problem data on the device of
    ``theta``; every array is contiguous (the fused kernel reads them where
    they lie)."""

    def __init__(self, theta, D0, Q, alphas, kernel, tol):
        if kernel not in (1, 2):
            raise ValueError(f"Unknown smoothness kernel {kernel!r}")
        K, H, W = theta.shape
        dtype, dev = theta.dtype, theta.device
        self.K, self.H, self.W = K, H, W
        self.T = H + W - 1
        self.kernel, self.tol = kernel, tol
        self.dtype, self.device = dtype, dev
        self.theta = _tlead(theta, W)  # [T+2, K, H]
        self.D0 = _tlead(D0, W)
        # per-group problem data: [T+2, 2, K, H] / [T+2, 2, H]
        self.QA = _tlead(torch.stack([Q[d] for d in GROUP_A], 0), W)
        self.QB = _tlead(torch.stack([Q[d] for d in GROUP_B], 0), W)
        self.aA = _tlead(torch.stack([alphas[d] for d in GROUP_A], 0), W)
        self.aB = _tlead(torch.stack([alphas[d] for d in GROUP_B], 0), W)
        valid = [geometry.valid_mask(H, W, d, dtype=dtype, device=dev)
                 for d in range(4)]
        self.vA = _tlead(torch.stack([valid[d] for d in GROUP_A], 0), W)
        self.vB = _tlead(torch.stack([valid[d] for d in GROUP_B], 0), W)
        self.pix = _tlead(torch.ones((H, W), dtype=dtype, device=dev), W)
        self.gamma = _tlead(raster_gamma(H, W, dtype, dev), W)  # [T+2, H]


def messages_to_groups(messages: torch.Tensor, W: int):
    """[4, K, H, W] -> (MA, MB), t-leading [T+2, 2, K, H], new tensors."""
    MA = _tlead(torch.stack([messages[d] for d in GROUP_A], 0), W)
    MB = _tlead(torch.stack([messages[d] for d in GROUP_B], 0), W)
    return MA, MB


def groups_to_messages(MA: torch.Tensor, MB: torch.Tensor,
                       W: int) -> torch.Tensor:
    """(MA, MB) -> [4, K, H, W] in the trws.py direction order."""
    A = _tlead_inv(MA, W)  # [2, K, H, W]
    B = _tlead_inv(MB, W)
    return torch.stack([B[0], A[0], B[1], A[1]], 0)  # LT, RT, UP, DN


# ------------------------------------------------------------------ decode
def decode_raster(sk: _Skewed, M):
    """Greedy conditioned decode in raster order + exact energy, on a message
    state M = (MA, MB).

    Each pixel conditions on the labels of its earlier neighbours (left, up)
    and adds the messages of its later edges.  It can be run on any message
    state that follows the trws.py buffer conventions, but it is only
    meaningful under the ordering whose forward messages it conditions on:
    on a banded-schedule state it decodes worse than that schedule's own
    decode (solvers/banded.py, ``decode="raster"``).  Plain PyTorch, one
    Python step per column.  -> (labels [H, W] int32, energy)."""
    MA, MB = M
    T, W = sk.T, sk.W
    acc_t = acc_dtype(sk.dtype)
    tr = lambda diff: truncated_kernel(diff, sk.kernel, sk.tol)

    sols = torch.zeros((T + 2, sk.H), dtype=torch.int64, device=sk.device)
    E = torch.zeros((), dtype=acc_t, device=sk.device)
    for t in range(T):
        c = t + 1
        D0c, D0p = sk.D0[c], sk.D0[c - 1]
        QB_c, aB_c, vB_c = sk.QB[c], sk.aB[c], sk.vB[c]
        QA_p, aA_p, vA_p = sk.QA[c - 1], sk.aA[c - 1], sk.vA[c - 1]
        sol_prev = sols[c - 1]

        # conditioned on the earlier neighbours (left, up)
        sol_l = sol_prev  # the left neighbour shares the skew row
        sol_u = _shift_down(sol_prev)  # the up neighbour is skew row y-1
        # E(p, LT): V[sol_l, k_p] at p
        Q_sel = take_plane(QB_c[0], sol_l)
        Db = sk.theta[c] + aB_c[0][None, :] * tr(Q_sel[None, :] - D0c) \
            * vB_c[0][None, :]
        # E(p, UP): V[sol_u, k_p] at p
        Q_sel = take_plane(QB_c[1], sol_u)
        Db = Db + aB_c[1][None, :] * tr(Q_sel[None, :] - D0c) \
            * vB_c[1][None, :]
        # E(ln, RT): V[k_p, sol_l] at the left neighbour (column c-1)
        D0_sel = take_plane(D0p, sol_l)
        Db = Db + aA_p[0][None, :] * tr(QA_p[0] - D0_sel[None, :]) \
            * vA_p[0][None, :]
        # E(un, DN): V[k_p, sol_u] at the up neighbour, evaluated at the
        # neighbour's own skew row (y-1) of column c-1, where sol_prev holds
        # its label, then shifted down to row y
        D0_un = take_plane(D0p, sol_prev)
        t_un = aA_p[1][None, :] * tr(QA_p[1] - D0_un[None, :]) \
            * vA_p[1][None, :]
        Db = Db + _shift_down(t_un)

        # messages on the later edges
        Ac, Bn = MA[c], MB[c + 1]
        Di = Db + Ac[0] + Ac[1] + Bn[0] + _shift_up(Bn[1])

        sol = torch.argmin(Di, dim=0)  # ties: the lowest index
        E = E + torch.where(sk.pix[c] > 0, take_plane(Db, sol),
                            0.0).sum(dtype=acc_t)
        sols[c] = sol
    labels = unskew(sols[1:-1].movedim(0, -1), W).to(torch.int32)
    return labels, E


# ------------------------------------------------------------------ sweeps
def _beliefs_col(sk: _Skewed, MA, MB, c):
    """Beliefs of padded column c: theta + all 8 incident buffers.  [K, H].
    The order of the additions is part of the contract: the fused kernel
    adds in the same order."""
    Ac, Bc, Acm1, Bcp1 = MA[c], MB[c], MA[c - 1], MB[c + 1]
    D = sk.theta[c] + Ac[0] + Ac[1] + Bc[0] + Bc[1]
    # out-buffers at the neighbours (zero at neighbours that do not exist):
    # RT at the left neighbour (same skew row), DN at the up neighbour (skew
    # row y-1), LT at the right neighbour, UP at the down neighbour
    D = D + Acm1[0] + _shift_down(Acm1[1])
    D = D + Bcp1[0] + _shift_up(Bcp1[1])
    return D


def _fwd_col(sk: _Skewed, M, t, use_kernel=True):
    """One forward step: all pixels of anti-diagonal t.  Writes column c of
    MA and column c+1 of MB in place, after both sends have read them."""
    MA, MB = M
    ktol = (sk.kernel, sk.tol, use_kernel)
    c = t + 1  # padded column index
    Ac, Bcp1 = MA[c], MB[c + 1]
    gD = sk.gamma[c][None, :] * _beliefs_col(sk, MA, MB, c)

    # E(p, RT) / E(p, DN): head-sends at this column (group A); E(rn, LT) /
    # E(dn, UP): tail-sends into column c+1 (group B; the right neighbour
    # shares the skew row, the down neighbour's source is row y-1)
    gDt = torch.stack([gD, _shift_down(gD)], 0)
    (mh, _), (mt, _) = _sends([
        _head(gD[None], Ac, sk.QA[c], sk.D0[c][None], sk.aA[c]),
        _tail(gDt, Bcp1, sk.QB[c + 1], sk.D0[c + 1][None], sk.aB[c + 1])],
        *ktol)
    # a dead edge keeps its old message
    MA[c] = torch.where(sk.vA[c][:, None, :] > 0, mh, Ac)
    MB[c + 1] = torch.where(sk.vB[c + 1][:, None, :] > 0, mt, Bcp1)
    return MA, MB


def _msum(mask, x, acc_t):
    return torch.where(mask, x, 0.0).sum(dtype=acc_t)


def _bwd_col(sk: _Skewed, M, t, use_kernel=True):
    """One backward step with its lower-bound terms.  Writes column c of MB
    and column c-1 of MA in place.  -> (state, lb of this step)."""
    MA, MB = M
    ktol = (sk.kernel, sk.tol, use_kernel)
    acc_t = acc_dtype(sk.dtype)
    c = t + 1
    Bc, Acm1 = MB[c], MA[c - 1]
    D = _beliefs_col(sk, MA, MB, c)
    vminD = torch.min(D, dim=0).values
    lb = _msum(sk.pix[c] > 0, vminD, acc_t)
    gD = sk.gamma[c][None, :] * (D - vminD[None, :])

    # E(p, LT) / E(p, UP): head-sends at this column (group B); E(ln, RT) /
    # E(un, DN): tail-sends into column c-1 (group A; the left neighbour
    # shares the skew row, the up neighbour's source is row y+1)
    gDt = torch.stack([gD, _shift_up(gD)], 0)
    (mh, vminh), (mt, vmint) = _sends([
        _head(gD[None], Bc, sk.QB[c], sk.D0[c][None], sk.aB[c]),
        _tail(gDt, Acm1, sk.QA[c - 1], sk.D0[c - 1][None], sk.aA[c - 1])],
        *ktol)
    vh = sk.vB[c]
    lb = lb + _msum(vh > 0, vminh, acc_t)
    vt = sk.vA[c - 1]
    lb = lb + _msum(vt > 0, vmint, acc_t)
    MB[c] = torch.where(vh[:, None, :] > 0, mh, Bc)
    MA[c - 1] = torch.where(vt[:, None, :] > 0, mt, Acm1)
    return (MA, MB), lb


def _sweep_steps(sk: _Skewed, M, use_kernel=True):
    """One full (forward + backward) pass, step by step -> (state, lb).
    With ``use_kernel=False`` this is the plain version of the fused sweep
    kernel (ops/wavefront_kernel.py).  Updates the state in place."""
    for t in range(sk.T):
        M = _fwd_col(sk, M, t, use_kernel)
    lb = torch.zeros((), dtype=acc_dtype(sk.dtype), device=sk.device)
    for t in range(sk.T - 1, -1, -1):
        M, lb_t = _bwd_col(sk, M, t, use_kernel)
        lb = lb + lb_t
    return M, lb


def sends_per_sweep(T: int) -> int:
    """Launches of the send kernel (calls of ``_sends``) in one
    ``sweep="steps"`` pass: one per step, its batched head-send and its
    batched tail-send (a direction pair each) together, over T forward and
    T backward steps."""
    return 2 * T


def pick_sweep(sweep: str, use_kernel: bool, fused, steps):
    """The sweep ``sweep`` names, of a schedule with both (this one and
    solvers/banded.py): ``fused`` (state -> (state, lb), one kernel launch)
    for "fused" with the kernels on, else ``steps``."""
    if sweep not in _SWEEPS:
        raise ValueError(f"unknown sweep {sweep!r}; one of {_SWEEPS}")
    return fused if sweep == "fused" and use_kernel else steps


class _Raster(Packed):
    """The skewed problem in the one driver's terms (trws.Packed), with the
    sweep that ``sweep`` and ``use_kernel`` choose."""

    def __init__(self, unary, positions, nbr_positions, alphas, kernel, tol,
                 use_kernel, sweep):
        super().__init__(unary)
        sk = self.sk = _Skewed(unary, positions, nbr_positions, alphas,
                               kernel, tol)
        self.sweep = pick_sweep(
            sweep, use_kernel,
            lambda M: wavefront_kernel.sweep_wavefront(sk, M),
            lambda M: _sweep_steps(sk, M, use_kernel))

    def decode(self, M):
        return decode_raster(self.sk, M)

    def to_state(self, messages):
        return messages_to_groups(messages, self.W)

    def messages(self, M):
        return groups_to_messages(*M, self.W)


def solve_wavefront(
    unary: torch.Tensor,  # [K, H, W]
    positions: torch.Tensor,  # D0 [K, H, W]
    nbr_positions: torch.Tensor,  # Q [4, K, H, W]
    alphas: torch.Tensor,  # [4, H, W]
    *,
    kernel: int,
    tol,
    maxiter: int = 1000,
    max_relgap: float = 1e-4,
    messages: torch.Tensor | None = None,  # [4, K, H, W] warm start
    check_every: int = 1,
    use_kernel: bool = True,
    sweep: str = "fused",
) -> TRWSResult:
    """Raster-order TRW-S via anti-diagonal wavefronts, on the device the
    tensors live on; drop-in for trws.solve.

    ``sweep`` and ``use_kernel``: see the module docstring.  The stopping
    rule (one host synchronisation per ``check_every`` sweeps) is
    the one driver's, trws.drive."""
    return drive(
        lambda: _Raster(unary, positions, nbr_positions, alphas, kernel, tol,
                        use_kernel, sweep),
        messages, maxiter=maxiter, max_relgap=max_relgap,
        check_every=check_every)
