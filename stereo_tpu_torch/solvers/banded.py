"""Banded (2-D blocked) wavefront TRW-S: short exact sweeps (port of
stereo_tpu/solvers/banded.py).

The raster-order wavefront runs sequential TRW-S in T = H + W - 1
anti-diagonal steps per pass.  This module shortens that critical path by
changing the *node ordering*, not the algorithm: partition the grid into
Bh x Bw blocks and order nodes by

    t(p) = yb + xb            (within-block anti-diagonal index),

ties broken arbitrarily.  For Bh, Bw >= 2 no two 4-neighbours share a t, so
this is a valid TRW-S total order: every block's wavefront advances in
lockstep and one pass takes only T = Bh + Bw - 1 steps, with about
Gy * Gx * min(Bh, Bw) lanes of parallel work per step.

This is *exact* TRW-S under that order (pinned per iteration against the
sequential oracle run with ``banded_order``): the lower bound is a valid dual
value and is non-decreasing.  What changes is mixing: monotonic chains span
single blocks, so information crosses the image in about #blocks-per-axis
passes instead of one.

Seam edges (block boundaries) flip their forward/backward role: for the pair
(pL at xb = Bw-1 | pR at xb = 0 of the next block), t(pR) = yb < t(pL) =
yb + Bw - 1, so pR precedes pL even though it sits to the *right* — and
likewise for y-seams.  The four per-direction message buffers of seam edges
are therefore kept out of the skewed column arrays, in four small side arrays
(one K-vector per seam node), updated with masked sends at the step that
processes their sequentially-correct endpoint:

  forward pass, step t:
    F-head: M[LT]@(.,yb=t,xb=0)     and M[UP]@(.,0,xb=t)      (head-sends)
    F-tail: M[RT]@(.,t,Bw-1) <- its right-block source (.,t,0)   and
            M[DN]@(.,Bh-1,t) <- its down-block source (.,0,t)   (tail-sends)
  backward pass, step t: the mirror four, accumulating their bound terms.

Layouts.  Columns are [K, L] with lane = yb * nb + b (b = gy*Gx + gx,
nb = Gy*Gx), so within-block vertical neighbours are +-nb lanes and whole
yb-groups are contiguous.  Sx* seam arrays share that lane layout (their
nodes have fixed xb); Sy* arrays use lane2 = xb * nb + b.

State.  ``(MA, MB, (SxL, SxR, SyU, SyD))``: MA, MB [T+2, 2, K, L] hold the
interior messages of GROUP_A = (RT, DN) and GROUP_B = (LT, UP), one padded
column per step; the four seam arrays are [K, L] and [K, Lp].  **A sweep
updates the state's tensors in place** (the two message arrays are half a
gigabyte at teddy K = 79) and returns them: do not use a state again after
handing it to a sweep, clone it first if it is needed.

Two sweeps, selected by ``sweep=`` on ``solve_banded`` and ``BandedRun``:

  ``"fused"`` (the default, what the model runs): one call of
      ``ops.banded_kernel.sweep_banded`` per sweep — on the card one launch
      of the hand-written kernel (csrc/banded_kernel.cu).  It takes every
      T >= 3, so short sweeps need no other path.
  ``"steps"``: a Python loop over the 2 T anti-diagonal steps with PyTorch
      glue, a step's six sends through one call of
      ``ops.minplus.minplus_send_many`` (on the card one launch of the
      hand-written column send kernel, csrc/minplus_send.cu): the
      counterpart of the JAX package's scan path.

The decode (``solve_banded``'s and ``BandedRun``'s ``decode="banded"``) is
``ops.banded_decode.decode_banded``, on the card one launch of the
hand-written kernel (csrc/banded_decode.cu), whichever the sweep; its plain
version is ``_decode_state``, a Python loop over the T steps.

``use_kernel=False`` turns every kernel of either sweep, and the decode's,
into its plain PyTorch version — a comparison aid for the tests and the
on-device smoke run, as in solvers/trws.py.  With CUDA tensors a kernel path
launches its kernel or raises; CPU tensors take the plain versions.  Both
sweeps and both values of ``use_kernel`` give the same messages and labels
(bit for bit in float32 on the card); the fused kernels' lower bound and
energy are summed in another order and agree to float32 rounding.

``_BandedProblem(stripe=...)`` builds one gy-stripe of a taller image for
the distributed solver (solvers/banded_dist.py).  The JAX package's
banded solver has no narrow message storage (only its checkerboard solver
takes ``message_dtype``), so the port's has none either.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from stereo_tpu_torch.device import DEFAULT_DEVICE, acc_dtype, resolve_device
from stereo_tpu_torch.energy import truncated_kernel
from stereo_tpu_torch.geometry import take_plane
from stereo_tpu_torch.ops import banded_decode, banded_kernel
from stereo_tpu_torch.solvers.trws import TRWSResult, _gap_open
from stereo_tpu_torch.solvers import wavefront
from stereo_tpu_torch.utils.profiling import span
from stereo_tpu_torch.solvers.wavefront import (
    DN, GROUP_A, GROUP_B, LT, RT, UP, _head, _sends, _tail, skew, unskew)

__all__ = ["solve_banded", "banded_order", "BandedSpec", "BandedRun"]

_SWEEPS = ("fused", "steps")


@dataclass(frozen=True)
class BandedSpec:
    H: int
    W: int
    Bh: int
    Bw: int

    @property
    def Gy(self):
        return -(-self.H // self.Bh)

    @property
    def Gx(self):
        return -(-self.W // self.Bw)

    @property
    def nb(self):
        return self.Gy * self.Gx

    @property
    def L(self):
        return self.Bh * self.nb

    @property
    def L2(self):
        return self.Bw * self.nb

    @property
    def Lp(self):
        return max(self.L, self.L2)

    @property
    def T(self):
        return self.Bh + self.Bw - 1

    @property
    def Hp(self):
        return self.Gy * self.Bh

    @property
    def Wp(self):
        return self.Gx * self.Bw

    def __post_init__(self):
        if self.Bh < 2 or self.Bw < 2:
            raise ValueError("banded order needs Bh, Bw >= 2 "
                             "(adjacent nodes must not tie)")


def banded_order(H, W, Bh, Bw):
    """Total order (row-major node ids) matching the parallel sweeps: sort by
    t = yb + xb, ties by (block, yb) — any tie order is equivalent because no
    two nodes of one step are adjacent or share a message buffer."""
    spec = BandedSpec(H, W, Bh, Bw)
    keyed = []
    for y in range(H):
        for x in range(W):
            gy, yb = divmod(y, Bh)
            gx, xb = divmod(x, Bw)
            b = gy * spec.Gx + gx
            keyed.append((yb + xb, b, yb, y * W + x))
    keyed.sort()
    return [k[-1] for k in keyed]


# ------------------------------------------------------------------ layouts
def _to_blocks(a, spec):
    """[..., H, W] -> [..., nb, Bh, Bw] (zero-padded image)."""
    lead = a.shape[:-2]
    ap = F.pad(a, (0, spec.Wp - spec.W, 0, spec.Hp - spec.H))
    r = ap.reshape(lead + (spec.Gy, spec.Bh, spec.Gx, spec.Bw))
    r = r.movedim(-2, -3)  # [..., Gy, Gx, Bh, Bw]
    return r.reshape(lead + (spec.nb, spec.Bh, spec.Bw))


def _from_blocks(r, spec):
    """Inverse of _to_blocks (crops padding)."""
    lead = r.shape[:-3]
    r = r.reshape(lead + (spec.Gy, spec.Gx, spec.Bh, spec.Bw))
    r = r.movedim(-3, -2)  # [..., Gy, Bh, Gx, Bw]
    a = r.reshape(lead + (spec.Hp, spec.Wp))
    return a[..., : spec.H, : spec.W]


def to_cols(a, spec):
    """[..., H, W] -> [T+2, ..., L] skewed, t-leading, lane = yb*nb + b."""
    r = _to_blocks(a, spec)  # [..., nb, Bh, Bw]
    s = skew(r, spec.Bw)  # [..., nb, Bh, T]
    s = s.movedim(-1, 0)  # [T, ..., nb, Bh]
    s = s.transpose(-1, -2)  # [T, ..., Bh, nb]
    s = s.reshape(s.shape[:-2] + (spec.L,))
    return F.pad(s, (0, 0) * (s.ndim - 1) + (1, 1)).contiguous()


def from_cols(cols, spec):
    """[T+2, ..., L] -> [..., H, W]."""
    s = cols[1:-1]
    s = s.reshape(s.shape[:-1] + (spec.Bh, spec.nb))
    s = s.transpose(-1, -2)  # [T, ..., nb, Bh]
    s = s.movedim(0, -1)  # [..., nb, Bh, T]
    r = unskew(s, spec.Bw)  # [..., nb, Bh, Bw]
    return _from_blocks(r, spec)


def _x_lanes(a, spec, xb):
    """[..., H, W] -> [..., L]: values at within-block column xb, lane layout
    (yb, b) — the Sx side-array layout."""
    r = _to_blocks(a, spec)[..., xb]  # [..., nb, Bh]
    r = r.transpose(-1, -2)  # [..., Bh, nb]
    return r.reshape(r.shape[:-2] + (spec.L,))


def _y_lanes(a, spec, yb):
    """[..., H, W] -> [..., Lp]: values at within-block row yb, lane2 layout
    (xb, b) — the Sy side-array layout (zero-padded L2 -> Lp)."""
    r = _to_blocks(a, spec)[..., yb, :]  # [..., nb, Bw]
    r = r.transpose(-1, -2)
    r = r.reshape(r.shape[:-2] + (spec.L2,))
    return F.pad(r, (0, spec.Lp - spec.L2))


def _x_lanes_back(v, spec, xb):
    """[..., L] -> [..., H, W]: scatter Sx-layout lanes back to column xb."""
    lead = v.shape[:-1]
    r = v.reshape(lead + (spec.Bh, spec.nb)).transpose(-1, -2)
    full = v.new_zeros(lead + (spec.nb, spec.Bh, spec.Bw))
    full[..., xb] = r
    return _from_blocks(full, spec)


def _y_lanes_back(v, spec, yb):
    """[..., Lp] -> [..., H, W]: scatter Sy-layout lanes back to row yb."""
    lead = v.shape[:-1]
    r = v[..., : spec.L2].reshape(lead + (spec.Bw, spec.nb))
    r = r.transpose(-1, -2)  # [..., nb, Bw]
    full = v.new_zeros(lead + (spec.nb, spec.Bh, spec.Bw))
    full[..., yb, :] = r
    return _from_blocks(full, spec)


def _grid(spec, device, row0: int = 0):
    """Global row and column indices [H, W] of a spec's pixels, its rows
    starting at image row ``row0``."""
    ys = torch.arange(row0, row0 + spec.H,
                      device=device)[:, None].expand(spec.H, spec.W)
    xs = torch.arange(spec.W, device=device)[None, :].expand(spec.H, spec.W)
    return ys, xs


def banded_gamma(spec, dtype=torch.float32, device=DEFAULT_DEVICE,
                 row0: int = 0, Himg: int | None = None):
    """gamma = 1/max(nFwd, nBwd) under the banded order, [H, W].

    Each neighbour pair carries two directed edges, so n* = 2 * #neighbours
    on that side; seam neighbours swap sides relative to raster order.

    ``row0`` / ``Himg`` place the spec's rows inside a taller image (the
    gy-stripes of solvers/banded_dist.py): neighbour existence is judged
    against the global rows ``row0 + y`` of an ``Himg``-row image, so a
    stripe's gammas equal the matching rows of the full image's bit for
    bit."""
    device = resolve_device(device)
    H, W, Bh, Bw = spec.H, spec.W, spec.Bh, spec.Bw
    if Himg is None:
        Himg = H
    ys, xs = _grid(spec, device, row0)
    yb = ys % Bh
    xb = xs % Bw
    has_l = xs >= 1
    has_r = xs <= W - 2
    has_u = ys >= 1
    has_d = ys <= Himg - 2
    # later neighbours: interior right/down, seam left/up
    n_f = ((has_r & (xb < Bw - 1)).to(dtype)
           + (has_d & (yb < Bh - 1)).to(dtype)
           + (has_l & (xb == 0)).to(dtype)
           + (has_u & (yb == 0)).to(dtype))
    # earlier neighbours: interior left/up, seam right/down
    n_b = ((has_l & (xb > 0)).to(dtype)
           + (has_u & (yb > 0)).to(dtype)
           + (has_r & (xb == Bw - 1)).to(dtype)
           + (has_d & (yb == Bh - 1)).to(dtype))
    return 1.0 / torch.maximum(torch.maximum(2 * n_f, 2 * n_b),
                               torch.ones((), dtype=dtype, device=device))


class _BandedProblem:
    """Skewed, t-leading problem data + static masks for the banded order,
    on the device of ``theta``; every array is contiguous (the fused kernel
    reads them where they lie).

    ``stripe=(row0, Himg, has_above, has_below)`` builds the problem as one
    gy-stripe of a taller ``Himg``-row image starting at global row ``row0``
    (solvers/banded_dist.py): validity / seam masks and gammas are judged
    against global rows, rows at or past ``Himg`` (the padding of the last
    stripe) are masked out, and the y-seam edges to the stripes above and
    below become live side-array entries.  ``stripe=None`` is the
    one-device problem."""

    def __init__(self, theta, D0, Q, alphas, spec: BandedSpec, kernel, tol,
                 stripe=None):
        if kernel not in (1, 2):
            raise ValueError(f"Unknown smoothness kernel {kernel!r}")
        K, H, W = theta.shape
        if (H, W) != (spec.H, spec.W):
            raise ValueError(f"problem is {H}x{W}, spec {spec.H}x{spec.W}")
        dtype, dev = theta.dtype, theta.device
        self.spec = spec
        self.K, self.kernel, self.tol = K, kernel, tol
        self.dtype, self.device = dtype, dev
        if stripe is None:
            stripe = (0, H, False, False)
        row0, Himg, has_above, has_below = stripe
        self.stripe = stripe
        Bh, Bw, Gy, Gx, nb = spec.Bh, spec.Bw, spec.Gy, spec.Gx, spec.nb

        tc = lambda a: to_cols(a, spec)
        self.theta = tc(theta)  # [T+2, K, L]
        self.D0 = tc(D0)
        self.QA = tc(torch.stack([Q[d] for d in GROUP_A], 0))  # [T+2,2,K,L]
        self.QB = tc(torch.stack([Q[d] for d in GROUP_B], 0))
        self.aA = tc(torch.stack([alphas[d] for d in GROUP_A], 0))
        self.aB = tc(torch.stack([alphas[d] for d in GROUP_B], 0))

        ys, xs = _grid(spec, dev, row0)
        yb, xb = ys % Bh, xs % Bw
        inim = ys < Himg  # the last stripe's pad rows are out
        # interior (non-seam) directed-edge validity, image space
        vLT = (xs >= 1) & (xb > 0) & inim
        vRT = (xs <= W - 2) & (xb < Bw - 1) & inim
        vUP = (ys >= 1) & (yb > 0) & inim
        vDN = (ys <= Himg - 2) & (yb < Bh - 1) & inim
        self.vA = tc(torch.stack([vRT, vDN], 0).to(dtype))  # [T+2, 2, L]
        self.vB = tc(torch.stack([vLT, vUP], 0).to(dtype))
        self.pix = tc(inim.to(dtype))  # [T+2, L]
        self.gamma = tc(banded_gamma(spec, dtype, dev, row0, Himg))

        # ---- static seam data (side-array layouts) ----
        xl = lambda a, x: _x_lanes(a, spec, x).contiguous()
        yl = lambda a, y: _y_lanes(a, spec, y).contiguous()
        # x-seam pair: pL = (., yb, Bw-1) | pR = (., yb, 0) of the next block.
        # M[LT]@pR needs (Q[LT], D0, alpha[LT]) at pR; M[RT]@pL at pL.
        self.PxL_q = xl(Q[LT], 0)  # [K, L]
        self.PxL_d0 = xl(D0, 0)
        self.PxL_a = xl(alphas[LT], 0)  # [L]
        self.PxR_q = xl(Q[RT], Bw - 1)
        self.PxR_d0 = xl(D0, Bw - 1)
        self.PxR_a = xl(alphas[RT], Bw - 1)
        # y-seam pair: pU = (., Bh-1, xb) | pD = (., 0, xb) of the block below.
        self.PyU_q = yl(Q[UP], 0)  # [K, Lp]
        self.PyU_d0 = yl(D0, 0)
        self.PyU_a = yl(alphas[UP], 0)
        self.PyD_q = yl(Q[DN], Bh - 1)
        self.PyD_d0 = yl(D0, Bh - 1)
        self.PyD_a = yl(alphas[DN], Bh - 1)

        # static lane index fields & seam validity masks
        lane = torch.arange(spec.L, device=dev)
        self.lane_yb = lane // nb  # [L]
        lane_b = lane % nb
        lane_gy = lane_b // Gx
        lane_gx = lane_b % Gx
        yimg = row0 + lane_gy * Bh + self.lane_yb  # the lane node's image row
        # [L] whether the lane's node has a real neighbour across the y-seam
        # (at a stripe's border when a neighbour stripe exists)
        self.has_up = (lane_gy > 0) | ((lane_gy == 0) & has_above)
        self.has_dn = (lane_gy < Gy - 1) | ((lane_gy == Gy - 1) & has_below)
        # node-level static validity of the seam edge buffers (lane layout)
        self.vSxL = (lane_gx > 0) & (yimg < Himg) & (lane_gx * Bw < W)
        self.vSxR = ((lane_gx < Gx - 1) & (yimg < Himg)
                     & ((lane_gx + 1) * Bw < W))
        lane2 = torch.arange(spec.Lp, device=dev)
        l2_xb = lane2 // nb
        l2_b = lane2 % nb
        l2_gy = l2_b // Gx
        l2_gx = l2_b % Gx
        in2 = (lane2 < spec.L2) & (l2_gx * Bw + l2_xb < W)
        self.l2_grp = l2_xb
        # seam-edge validity: the pair's lower node pD must be a real pixel
        # (every block-row holds a real row, so a live neighbour stripe means
        # pD's row is inside the image at the stripe border)
        self.vSyU = (in2 & ((l2_gy > 0) | has_above)
                     & (row0 + l2_gy * Bh < Himg))
        self.vSyD = (in2 & ((l2_gy < Gy - 1) | ((l2_gy == Gy - 1)
                                                 & has_below))
                     & (row0 + (l2_gy + 1) * Bh < Himg))


def _sdownb(v, nb):
    """v[..., lane] -> v[..., lane - nb] (row yb reads yb-1), zero at yb=0."""
    return F.pad(v, (nb, 0))[..., : v.shape[-1]]


def _supb(v, nb):
    """v[..., lane] -> v[..., lane + nb], zero at yb = Bh-1."""
    return F.pad(v, (0, nb))[..., nb:]


def _padLp(v, Lp):
    return F.pad(v, (0, Lp - v.shape[-1]))


def _roll(v, shift):
    return torch.roll(v, shift, dims=-1)


def _seam_views(bp: _BandedProblem, S, t):
    """Column-space views of the seam buffers touched at step t.

    Returns (syu0, syd0, sydT, syuT): [K, L] tensors whose
      group 0 lanes   hold SyU[(t, b)]        / SyD[(t, b - Gx)]
      group Bh-1 lanes hold SyD[(t-Bh+1, b)]  / SyU[(t-Bh+1, b + Gx)].
    Junk outside those groups; callers mask."""
    spec = bp.spec
    nb, Gx, Bh, L = spec.nb, spec.Gx, spec.Bh, spec.L
    _, _, SyU, SyD = S
    syu0 = _roll(SyU, -t * nb)[..., :L]
    syd0 = _roll(SyD, -t * nb + Gx)[..., :L]
    sydT = _roll(SyD, (2 * Bh - 2 - t) * nb)[..., :L]
    syuT = _roll(SyU, (2 * Bh - 2 - t) * nb - Gx)[..., :L]
    return syu0, syd0, sydT, syuT


def _beliefs(bp: _BandedProblem, MA, MB, c, t, S, views):
    """Node beliefs of padded column c (step t): theta + all 8 incident
    message buffers, seams included.  [K, L].  The order of the additions is
    part of the contract: the fused kernel adds in the same order."""
    spec = bp.spec
    nb, Bh, Bw = spec.nb, spec.Bh, spec.Bw
    SxL, SxR, _, _ = S
    syu0, syd0, sydT, syuT = views
    Ac, Bc, Acm1, Bcp1 = MA[c], MB[c], MA[c - 1], MB[c + 1]
    D = bp.theta[c] + Ac[0] + Ac[1] + Bc[0] + Bc[1]
    D = D + Acm1[0] + _sdownb(Acm1[1], nb)
    D = D + Bcp1[0] + _supb(Bcp1[1], nb)
    # seam contributions (in-buffer + the partner buffer stored at the nbr)
    pix_c = bp.pix[c]
    mx0 = (bp.lane_yb == t) & bp.vSxL
    mxW = (bp.lane_yb == t - (Bw - 1)) & bp.vSxR
    D = D + torch.where(mx0, SxL + _roll(SxR, 1), 0.0)
    D = D + torch.where(mxW, SxR + _roll(SxL, -1), 0.0)
    my0 = (bp.lane_yb == 0) & bp.has_up & (pix_c > 0)
    myT = (bp.lane_yb == Bh - 1) & bp.has_dn & (pix_c > 0)
    D = D + torch.where(my0, syu0 + syd0, 0.0)
    D = D + torch.where(myT, sydT + syuT, 0.0)
    return D, (Ac, Bc, Acm1, Bcp1), (mx0, mxW, my0, myT)


def _fwd_gd(bp: _BandedProblem, state, t, views):
    """Forward step t's scaled beliefs gD [K, L] and seam masks."""
    MA, MB, S = state
    c = t + 1
    D, _, masks = _beliefs(bp, MA, MB, c, t, S, views)
    return bp.gamma[c][None, :] * D, masks


def _fwd_y_src(bp: _BandedProblem, gD, t):
    """The F-tail y sends' source beliefs: M[DN]@(., Bh-1, t) reads the
    down-block's node (b + Gx, 0, t).  [K, Lp] in lane2 layout."""
    spec = bp.spec
    return _roll(_padLp(gD, spec.Lp), t * spec.nb - spec.Gx)


def _fwd_sends(bp: _BandedProblem, state, t, views, gD, masks, src_y,
               use_kernel=True):
    """Forward step t's six sends, each from the state before the step, and
    their writes (the two message columns in place)."""
    spec = bp.spec
    nb, Lp = spec.nb, spec.Lp
    MA, MB, S = state
    SxL, SxR, SyU, SyD = S
    c = t + 1
    Ac, Bcp1 = MA[c], MB[c + 1]
    mx0, mxW, my0, myT = masks
    QB_c, D0_c, aB_c = bp.QB[c], bp.D0[c], bp.aB[c]
    gDt = torch.stack([gD, _sdownb(gD, nb)], 0)
    (mh, _), (mt, _), (mlt, _), (mup, _), (mrt, _), (mdn, _) = _sends([
        # interior head-sends, group A (RT, DN) at column c
        _head(gD[None], Ac, bp.QA[c], bp.D0[c][None], bp.aA[c]),
        # interior tail-sends, group B (LT, UP) into column c+1
        _tail(gDt, Bcp1, bp.QB[c + 1], bp.D0[c + 1][None], bp.aB[c + 1]),
        # F-head x: M[LT]@(., t, 0), stored in SxL at group t
        _head(gD, SxL, QB_c[0], D0_c, aB_c[0]),
        # F-head y: M[UP]@(., 0, t), SyU group t (computed at group-0 lanes)
        _head(gD, views[0], QB_c[1], D0_c, aB_c[1]),
        # F-tail x: M[RT]@(., t, Bw-1) <- source (b+1, t, 0)
        _tail(_roll(gD, -1), SxR, bp.PxR_q, bp.PxR_d0, bp.PxR_a),
        # F-tail y: M[DN]@(., Bh-1, t) <- source (b+Gx down-block, 0, t)
        _tail(src_y, SyD, bp.PyD_q, bp.PyD_d0, bp.PyD_a),
    ], bp.kernel, bp.tol, use_kernel)
    MA[c] = torch.where(bp.vA[c][:, None, :] > 0, mh, Ac)
    MB[c + 1] = torch.where(bp.vB[c + 1][:, None, :] > 0, mt, Bcp1)
    upd = _roll(_padLp(torch.where(my0, mup, 0.0), Lp), t * nb)
    wy = (bp.l2_grp == t) & bp.vSyU
    wx = (bp.lane_yb == t) & bp.vSxR
    wy2 = (bp.l2_grp == t) & bp.vSyD
    S = (torch.where(mx0, mlt, SxL), torch.where(wx, mrt, SxR),
         torch.where(wy, upd, SyU), torch.where(wy2, mdn, SyD))
    return MA, MB, S


def _fwd_col(bp: _BandedProblem, state, t, use_kernel=True):
    """One forward step: process all nodes of (real) column t.  Writes the
    two message columns in place."""
    views = _seam_views(bp, state[2], t)
    gD, masks = _fwd_gd(bp, state, t, views)
    return _fwd_sends(bp, state, t, views, gD, masks, _fwd_y_src(bp, gD, t),
                      use_kernel)


def _msum(mask, x, acc_t):
    return torch.where(mask, x, 0.0).sum(dtype=acc_t)


def _bwd_gd(bp: _BandedProblem, state, t, views):
    """Backward step t's min-normalised scaled beliefs gD [K, L], seam
    masks, and the step's node term of the bound."""
    MA, MB, S = state
    c = t + 1
    D, _, masks = _beliefs(bp, MA, MB, c, t, S, views)
    vminD = torch.min(D, dim=0).values
    lb = _msum(bp.pix[c] > 0, vminD, acc_dtype(bp.dtype))
    return bp.gamma[c][None, :] * (D - vminD[None, :]), masks, lb


def _bwd_y_src(bp: _BandedProblem, gD, t):
    """The B-tail y sends' source beliefs: M[UP]@(., 0, t-Bh+1) reads the
    node (b, Bh-1, t-Bh+1) of the block above.  [K, Lp], lane2 layout."""
    spec = bp.spec
    return _roll(_padLp(gD, spec.Lp),
                 (t - 2 * spec.Bh + 2) * spec.nb + spec.Gx)


def _bwd_sends(bp: _BandedProblem, state, t, views, gD, masks, lb, src_y,
               use_kernel=True):
    """Backward step t's six sends and their writes (in place), adding their
    bound terms to ``lb``.  -> (state, lb of this step)."""
    spec = bp.spec
    nb, Lp, Bh, Bw = spec.nb, spec.Lp, spec.Bh, spec.Bw
    acc_t = acc_dtype(bp.dtype)
    MA, MB, S = state
    SxL, SxR, SyU, SyD = S
    c = t + 1
    Bc, Acm1 = MB[c], MA[c - 1]
    mx0, mxW, my0, myT = masks
    QA_c, D0_c, aA_c = bp.QA[c], bp.D0[c], bp.aA[c]
    gDt = torch.stack([gD, _supb(gD, nb)], 0)
    # the step's six sends, each from the state before the step:
    sends = _sends([
        # interior head-sends, group B (LT, UP) at column c
        _head(gD[None], Bc, bp.QB[c], bp.D0[c][None], bp.aB[c]),
        # interior tail-sends, group A (RT, DN) into column c-1
        _tail(gDt, Acm1, bp.QA[c - 1], bp.D0[c - 1][None], bp.aA[c - 1]),
        # B-head x: M[RT]@(., t-Bw+1, Bw-1), SxR at group t-Bw+1
        _head(gD, SxR, QA_c[0], D0_c, aA_c[0]),
        # B-head y: M[DN]@(., Bh-1, t-Bh+1), computed at group Bh-1 lanes
        _head(gD, views[2], QA_c[1], D0_c, aA_c[1]),
        # B-tail x: M[LT]@(., t-Bw+1, 0) <- source (b-1, t-Bw+1, Bw-1)
        _tail(_roll(gD, 1), SxL, bp.PxL_q, bp.PxL_d0, bp.PxL_a),
        # B-tail y: M[UP]@(., 0, t-Bh+1) <- source (b, Bh-1, t-Bh+1),
        # target SyU at lane2 (t-Bh+1, b+Gx)
        _tail(src_y, SyU, bp.PyU_q, bp.PyU_d0, bp.PyU_a),
    ], bp.kernel, bp.tol, use_kernel)
    (mh, vminh), (mt, vmint), (mrt, vrt), (mdn, vdn), (mlt, vlt), \
        (mup, vup) = sends
    vh, vt = bp.vB[c], bp.vA[c - 1]
    wxl = (bp.lane_yb == t - (Bw - 1)) & bp.vSxL
    wyu = (bp.l2_grp == t - (Bh - 1)) & bp.vSyU
    wyd = (bp.l2_grp == t - (Bh - 1)) & bp.vSyD
    for mask, v in ((vh > 0, vminh), (vt > 0, vmint), (mxW, vrt),
                    (myT, vdn), (wxl, vlt), (wyu, vup)):
        lb = lb + _msum(mask, v, acc_t)
    MB[c] = torch.where(vh[:, None, :] > 0, mh, Bc)
    MA[c - 1] = torch.where(vt[:, None, :] > 0, mt, Acm1)
    upd = _roll(_padLp(torch.where(myT, mdn, 0.0), Lp),
                -(2 * Bh - 2 - t) * nb)
    S = (torch.where(wxl, mlt, SxL), torch.where(mxW, mrt, SxR),
         torch.where(wyu, mup, SyU), torch.where(wyd, upd, SyD))
    return (MA, MB, S), lb


def _bwd_col(bp: _BandedProblem, state, t, use_kernel=True):
    """One backward step with its lower-bound terms.  Writes the two message
    columns in place.  -> (state, lb of this step)."""
    views = _seam_views(bp, state[2], t)
    gD, masks, lb = _bwd_gd(bp, state, t, views)
    return _bwd_sends(bp, state, t, views, gD, masks, lb,
                      _bwd_y_src(bp, gD, t), use_kernel)


def _sweep_steps(bp: _BandedProblem, state, use_kernel=True):
    """One full (forward + backward) pass, step by step -> (state, lb).
    With ``use_kernel=False`` this is the plain version of the fused sweep
    kernel (ops/banded_kernel.py).  Updates the state in place."""
    T = bp.spec.T
    for t in range(T):
        state = _fwd_col(bp, state, t, use_kernel)
    lb = torch.zeros((), dtype=acc_dtype(bp.dtype), device=bp.device)
    for t in range(T - 1, -1, -1):
        state, lb_t = _bwd_col(bp, state, t, use_kernel)
        lb = lb + lb_t
    return state, lb


def sends_per_sweep(spec: BandedSpec) -> int:
    """Launches of the send kernel (calls of ``_sends``) in one
    ``sweep="steps"`` pass: one per step for its batched interior head-send,
    its batched interior tail-send and its four seam sends, over T forward
    and T backward steps."""
    return 2 * spec.T


def _decode_consts(bp: _BandedProblem):
    """Seam problem data of the decode, brought to the lanes that read it."""
    return (_roll(bp.PxL_q, -1), _roll(bp.PxL_d0, -1), _roll(bp.PxL_a, -1))


def _down_seam(bp: _BandedProblem, sols, t):
    """The decode's down-seam data at step t: the solutions of the nodes
    below the yb = Bh-1 nodes and their (Q[UP], D0, alpha[UP]), at those
    nodes' lanes.  Junk elsewhere; callers mask."""
    spec = bp.spec
    nb, Gx, L, Lp, Bh = spec.nb, spec.Gx, spec.L, spec.Lp, spec.Bh
    c = t + 1
    sol_d = _roll(_padLp(sols[c - (Bh - 1)], Lp), (Bh - 1) * nb - Gx)[..., :L]
    sh = (2 * Bh - 2 - t) * nb - Gx
    return (sol_d, _roll(bp.PyU_q, sh)[..., :L],
            _roll(bp.PyU_d0, sh)[..., :L], _roll(bp.PyU_a, sh)[..., :L])


def _decode_step(bp: _BandedProblem, state, t, sols, views, consts, down):
    """One step of the greedy conditioned decode: the nodes of column t
    condition on their *earlier* neighbours' solutions (interior left/up +
    seam right/down; ``down`` from _down_seam) and add the messages of their
    later edges.  -> (solutions [L], energy terms of the step)."""
    spec = bp.spec
    nb, Bh, Bw = spec.nb, spec.Bh, spec.Bw
    acc_t = acc_dtype(bp.dtype)
    tr = lambda diff: truncated_kernel(diff, bp.kernel, bp.tol)  # noqa: E731
    MA, MB, S = state
    SxL, SxR, _, _ = S
    qln, d0ln_full, aln = consts
    sol_d, qdn, d0dn_full, adn = down
    c = t + 1
    syu0, syd0, _, _ = views
    pix_c = bp.pix[c]
    D0c = bp.D0[c]
    QB_c, aB_c, vB_c = bp.QB[c], bp.aB[c], bp.vB[c]
    QA_c, aA_c = bp.QA[c], bp.aA[c]
    QA_p, aA_p, vA_p = bp.QA[c - 1], bp.aA[c - 1], bp.vA[c - 1]
    D0p = bp.D0[c - 1]
    sol_prev = sols[c - 1]

    mx0 = (bp.lane_yb == t) & bp.vSxL
    mxW = (bp.lane_yb == t - (Bw - 1)) & bp.vSxR
    my0 = (bp.lane_yb == 0) & bp.has_up & (pix_c > 0)
    myT = (bp.lane_yb == Bh - 1) & bp.has_dn & (pix_c > 0)

    Db = bp.theta[c]
    # conditioned on interior earlier nbrs (left, up)
    sol_l = sol_prev
    sol_u = _sdownb(sol_prev, nb)
    Q_sel = take_plane(QB_c[0], sol_l)
    Db = Db + aB_c[0][None, :] * tr(Q_sel[None, :] - D0c) \
        * vB_c[0][None, :]
    Q_sel = take_plane(QB_c[1], sol_u)
    Db = Db + aB_c[1][None, :] * tr(Q_sel[None, :] - D0c) \
        * vB_c[1][None, :]
    # out-edges at interior earlier nbrs: E(ln, RT), E(un, DN)
    D0_sel = take_plane(D0p, sol_l)
    Db = Db + aA_p[0][None, :] * tr(QA_p[0] - D0_sel[None, :]) \
        * vA_p[0][None, :]
    D0_un = take_plane(D0p, sol_prev)
    t_un = aA_p[1][None, :] * tr(QA_p[1] - D0_un[None, :]) \
        * vA_p[1][None, :]
    Db = Db + _sdownb(t_un, nb)
    # conditioned on seam earlier nbrs: right (xb = Bw-1 nodes)
    sol_r = _roll(sols[c - (Bw - 1)], -1)
    Q_sel = take_plane(QA_c[0], sol_r)
    Db = Db + torch.where(mxW, aA_c[0] * tr(Q_sel[None] - D0c), 0.0)
    d0ln = take_plane(d0ln_full, sol_r)
    Db = Db + torch.where(mxW, aln * tr(qln - d0ln[None]), 0.0)
    # conditioned on seam earlier nbrs: down (yb = Bh-1 nodes)
    Q_sel = take_plane(QA_c[1], sol_d)
    Db = Db + torch.where(myT, aA_c[1] * tr(Q_sel[None] - D0c), 0.0)
    d0dn = take_plane(d0dn_full, sol_d)
    Db = Db + torch.where(myT, adn * tr(qdn - d0dn[None]), 0.0)

    # messages on later edges
    Ac = MA[c]
    Bn = MB[c + 1]
    Di = Db + Ac[0] + Ac[1] + Bn[0] + _supb(Bn[1], nb)
    Di = Di + torch.where(mx0, SxL + _roll(SxR, 1), 0.0)
    Di = Di + torch.where(my0, syu0 + syd0, 0.0)

    sol = torch.argmin(Di, dim=0)
    return sol, _msum(pix_c > 0, take_plane(Db, sol), acc_t)


def _decode_state(bp: _BandedProblem, state):
    """Greedy conditioned decode in banded order + exact energy.

    Plain PyTorch, one Python step per column (_decode_step): the plain
    version of ops.banded_decode.decode_banded.  -> (labels [H, W] int32,
    energy)."""
    spec = bp.spec
    sols = torch.zeros((spec.T + 2, spec.L), dtype=torch.int64,
                       device=bp.device)
    E = torch.zeros((), dtype=acc_dtype(bp.dtype), device=bp.device)
    consts = _decode_consts(bp)
    for t in range(spec.T):
        sol, e = _decode_step(bp, state, t, sols,
                              _seam_views(bp, state[2], t), consts,
                              _down_seam(bp, sols, t))
        E = E + e
        sols[t + 1] = sol
    labels = from_cols(sols.to(bp.dtype), spec).to(torch.int32)
    return labels, E


def _check_sweep(sweep: str):
    if sweep not in _SWEEPS:
        raise ValueError(f"unknown sweep {sweep!r}; one of {_SWEEPS}")


def _make_sweep_fn(bp: _BandedProblem, use_kernel: bool, sweep: str):
    _check_sweep(sweep)
    if sweep == "fused" and use_kernel:
        return lambda state: banded_kernel.sweep_banded(bp, state)
    return lambda state: _sweep_steps(bp, state, use_kernel)


def _make_decode_fn(bp: _BandedProblem, use_kernel: bool):
    if use_kernel:
        return lambda state: banded_decode.decode_banded(bp, state)
    return lambda state: _decode_state(bp, state)


def solve_banded(
    unary: torch.Tensor,  # [K, H, W]
    positions: torch.Tensor,  # D0 [K, H, W]
    nbr_positions: torch.Tensor,  # Q [4, K, H, W]
    alphas: torch.Tensor,  # [4, H, W]
    *,
    kernel: int,
    tol,
    Bh: int,
    Bw: int,
    maxiter: int = 1000,
    max_relgap: float = 1e-4,
    messages: torch.Tensor | None = None,  # [4, K, H, W] warm start
    check_every: int = 1,
    use_kernel: bool = True,
    sweep: str = "fused",
) -> TRWSResult:
    """Banded-order TRW-S on the device the tensors live on; drop-in for
    trws.solve.

    Bh x Bw is the block size: T = Bh + Bw - 1 parallel steps per pass.
    ``sweep`` and ``use_kernel``: see the module docstring.  The stopping
    rule (one host synchronisation per ``check_every`` sweeps) is trws.solve's.

    For repeated chunked solves of one problem use BandedRun, which packs
    the problem once instead of per call."""
    K, H, W = unary.shape
    with span("trws.pack"):
        spec = BandedSpec(H, W, Bh, Bw)
        bp = _BandedProblem(unary, positions, nbr_positions, alphas, spec,
                            kernel, tol)
        sweep_fn = _make_sweep_fn(bp, use_kernel, sweep)
        decode_fn = _make_decode_fn(bp, use_kernel)
        if messages is None:
            messages = torch.zeros((4, K, H, W), dtype=bp.dtype,
                                   device=bp.device)
        state = messages_to_state(messages, bp)
        zero = torch.zeros((), dtype=acc_dtype(bp.dtype), device=bp.device)
        energy, lb = zero, zero
        labels = torch.zeros((H, W), dtype=torch.int32, device=bp.device)
    it = 0
    while it < maxiter and (it == 0 or _gap_open(energy, lb, max_relgap)):
        for _ in range(check_every):
            with span("trws.sweep"):
                state, lb = sweep_fn(state)
        with span("trws.decode"):
            labels, energy = decode_fn(state)
        it += check_every
    with span("trws.finish"):
        messages = state_to_messages(state, bp)
    return TRWSResult(labels, energy, lb, it, messages)


class BandedRun:
    """Prepared banded solver: pack the problem once, sweep in chunks.

    Usage:
        r = BandedRun(unary, D0, Q, alphas, kernel=1, tol=2.0, Bh=64, Bw=64)
        state = r.init_state()
        state, energy, lb, labels = r.run(state, 100)   # chunk of 100 sweeps
        msgs = r.messages(state)                         # [4, K, H, W]

    ``run`` owns the state it is given: the sweeps update it in place.

    ``decode="raster"`` decodes greedily under the *raster* order on this
    state's messages (wavefront.decode_raster) instead of the banded order.
    It is systematically worse than the banded-order decode: the greedy
    conditioned decode is only meaningful under the ordering whose forward
    messages it reads.  Kept as the recorded refutation of the raster-decode
    idea; what tames the decode's oscillation is ``run``'s incumbent.
    """

    def __init__(self, unary, positions, nbr_positions, alphas, *, kernel,
                 tol, Bh, Bw, use_kernel: bool = True, sweep: str = "fused",
                 decode: str = "banded"):
        K, H, W = unary.shape
        self.spec = BandedSpec(H, W, Bh, Bw)
        self.bp = _BandedProblem(unary, positions, nbr_positions, alphas,
                                 self.spec, kernel, tol)
        self._sweep_fn = _make_sweep_fn(self.bp, use_kernel, sweep)
        self._decode_fn = _make_decode_fn(self.bp, use_kernel)
        if decode not in ("banded", "raster"):
            raise ValueError(f"unknown decode {decode!r}")
        self.decode = decode
        self._inputs = (unary, positions, nbr_positions, alphas)
        self._sk = None  # the raster decode's skewed problem, built lazily
        self.K, self.H, self.W = K, H, W
        self.dtype = unary.dtype

    def init_state(self, messages=None):
        if messages is None:
            messages = torch.zeros((4, self.K, self.H, self.W),
                                   dtype=self.dtype, device=self.bp.device)
        return messages_to_state(messages, self.bp)

    def _decode(self, state):
        if self.decode == "banded":
            return self._decode_fn(state)
        if self._sk is None:
            self._sk = wavefront._Skewed(*self._inputs, self.bp.kernel,
                                         self.bp.tol)
        msgs = state_to_messages(state, self.bp)
        return wavefront.decode_raster(
            self._sk, wavefront.messages_to_groups(msgs, self.W))

    def run(self, state, sweeps: int, decode_every: int | None = None):
        """``sweeps`` passes, decoding every ``decode_every`` sweeps (default:
        once at the end) and keeping the best labeling seen — the greedy
        decode oscillates around convergence, so frequent decodes plus an
        incumbent reach a target energy in fewer sweeps.
        -> (state, best_energy, lb, best_labels)."""
        if decode_every is None or decode_every >= sweeps:
            decode_every = sweeps
        bp = self.bp
        acc_t = acc_dtype(bp.dtype)
        bestE = torch.full((), float("inf"), dtype=acc_t, device=bp.device)
        bestL = torch.zeros((self.H, self.W), dtype=torch.int32,
                            device=bp.device)
        lb = torch.zeros((), dtype=acc_t, device=bp.device)
        for _ in range(sweeps // decode_every):
            for _ in range(decode_every):
                state, lb = self._sweep_fn(state)
            labels, energy = self._decode(state)
            better = energy < bestE
            bestE = torch.where(better, energy, bestE)
            bestL = torch.where(better, labels, bestL)
        return state, bestE, lb, bestL

    def messages(self, state):
        return state_to_messages(state, self.bp)


def messages_to_state(messages: torch.Tensor, bp: _BandedProblem):
    """[4, K, H, W] -> (MA, MB, (SxL, SxR, SyU, SyD)), all new tensors.

    Interior entries go to the skewed column arrays, seam entries to the side
    arrays; the seam positions inside the column arrays are zeroed so that
    interior reads never double-count (interior sends keep them zero)."""
    spec = bp.spec
    messages = messages.to(bp.dtype)
    MA = to_cols(torch.stack([messages[d] for d in GROUP_A], 0), spec)
    MB = to_cols(torch.stack([messages[d] for d in GROUP_B], 0), spec)
    SxL = torch.where(bp.vSxL, _x_lanes(messages[LT], spec, 0), 0.0)
    SxR = torch.where(bp.vSxR, _x_lanes(messages[RT], spec, spec.Bw - 1),
                      0.0)
    SyU = torch.where(bp.vSyU, _y_lanes(messages[UP], spec, 0), 0.0)
    SyD = torch.where(bp.vSyD, _y_lanes(messages[DN], spec, spec.Bh - 1),
                      0.0)
    MA = MA * (bp.vA[:, :, None, :] > 0)
    MB = MB * (bp.vB[:, :, None, :] > 0)
    return MA, MB, (SxL, SxR, SyU, SyD)


def state_to_messages(state, bp: _BandedProblem) -> torch.Tensor:
    """Inverse of messages_to_state: reassemble [4, K, H, W]."""
    spec = bp.spec
    MA, MB, (SxL, SxR, SyU, SyD) = state
    A = from_cols(MA, spec)  # [2, K, H, W]
    B = from_cols(MB, spec)
    m_lt = B[0] + _x_lanes_back(torch.where(bp.vSxL, SxL, 0.0), spec, 0)
    m_rt = A[0] + _x_lanes_back(torch.where(bp.vSxR, SxR, 0.0), spec,
                                spec.Bw - 1)
    m_up = B[1] + _y_lanes_back(torch.where(bp.vSyU, SyU, 0.0), spec, 0)
    m_dn = A[1] + _y_lanes_back(torch.where(bp.vSyD, SyD, 0.0), spec,
                                spec.Bh - 1)
    return torch.stack([m_lt, m_rt, m_up, m_dn], 0)
