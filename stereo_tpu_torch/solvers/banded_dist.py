"""Distributed banded wavefront TRW-S: gy-stripes over the devices of a mesh
(port of stereo_tpu/solvers/banded_dist.py).

The banded order t(p) = yb + xb (solvers/banded.py) does not depend on the
block-row index gy: every block's wavefront advances in lockstep.  Whole
block-rows (gy stripes) go to the shards of a mesh row, and each shard runs
the *local* banded problem of its stripe; the only coupling between stripes
is

  (a) the y-seam side arrays of the stripe-border seam pairs
      (pU = (., Bh-1, xb) in the last block-row of stripe d |
       pD = (., 0, xb)    in the first block-row of stripe d+1):
      SyD@pU lives on d, SyU@pD on d+1, and each pair's beliefs read the
      partner's buffer — a [K, Bw, Gx] row exchanged at the top of a step;
  (b) the tail-sends across the border, which need the *source* node's gD
      from the neighbour stripe at the step that processes it — a [K, Gx]
      slab exchanged between a step's beliefs and its sends.

Each step of a stripe runs the port's ``sweep="steps"`` glue
(banded._fwd_gd / _fwd_sends and their backward mirrors), so on the card a
stripe's six sends of a step are one launch of the column send kernel
(csrc/minplus_send.cu, ops.minplus.minplus_send_many): 2 T launches a sweep
a stripe.  The fused sweep kernel (kernel 5) holds a whole sweep in one
launch and cannot stop at a step for the exchange.

Exactness: ``_BandedProblem(stripe=(row0, Himg, has_above, has_below))``
judges masks and gammas against global rows, so the stripe-local arithmetic
is the one-device solver's, in the same order: messages and labels are bit
for bit those of solve_banded / BandedRun on one device; only the energy and
lower-bound sums are reassociated (per-stripe partials).

Halo timing (why an exchange of the border rows at the top of each step
suffices): within a pass each border side-array entry is written once —

  fwd:  beliefs@pD read SyD@pU at xb=t   -> written this step AFTER reads
                                            (the halo is the previous pass's)
        beliefs@pU read SyU@pD at xb=t-(Bh-1) -> written by the neighbour's
                                            F-head at step t-(Bh-1) <= t-1
  bwd:  the mirror, with steps descending — both reads see either the
        previous pass's value or a value written >= 1 step earlier,

so a copy of the neighbour's current border row at the top of each step
carries exactly the value the sequential order prescribes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stereo_tpu_torch.device import acc_dtype
from stereo_tpu_torch.parallel.mesh import Line, Mesh, visible_devices
from stereo_tpu_torch.solvers import banded
from stereo_tpu_torch.solvers.banded import (
    BandedSpec, _BandedProblem, from_cols, messages_to_state,
    state_to_messages)
from stereo_tpu_torch.solvers.trws import TRWSResult

__all__ = ["sharded_banded_run", "make_y_mesh"]


def make_y_mesh(n_devices: int | None = None, devices=None,
                batch: int = 1) -> Mesh:
    """A ('batch', 'y') stripe mesh over the first n_devices devices
    (default: the visible CUDA devices); batch = 1 is the plain stripe
    mesh."""
    devices = list(devices if devices is not None else visible_devices())
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if n % batch:
        raise ValueError(f"{n} devices not divisible by batch={batch}")
    w = n // batch
    return Mesh([devices[b * w:(b + 1) * w] for b in range(batch)],
                ("batch", "y"))


def _clip(v: int, lo: int, hi: int) -> int:
    return min(max(v, lo), hi)


class _StripeCtx:
    """One stripe's border lanes and the substitutions of its neighbours'
    values into the one-device views."""

    def __init__(self, bp: _BandedProblem):
        self.bp = bp
        spec = bp.spec
        Gx, nb, L, Lp = spec.Gx, spec.nb, spec.L, spec.Lp
        self.bot_off = (spec.Bh - 1) * nb + (spec.Gy - 1) * Gx
        lane = torch.arange(L, device=bp.device)
        self.top_L = lane < Gx  # my0 border lanes (yb = 0, gy = 0)
        self.bot_L = (lane >= self.bot_off) & (lane < self.bot_off + Gx)
        l2_gy = (torch.arange(Lp, device=bp.device) % nb) // Gx
        self.l2_top = l2_gy == 0  # B-tail border write rows
        self.l2_bot = l2_gy == spec.Gy - 1  # F-tail border write rows

    def row(self, arr, gy: int):
        """[..., Lp] side array -> its block-row gy as [..., Bw, Gx]."""
        spec = self.bp.spec
        r = arr[..., : spec.L2].reshape(arr.shape[:-1] + (spec.Bw, spec.nb))
        return r[..., gy * spec.Gx:(gy + 1) * spec.Gx]

    def top(self):
        """The first block-row's lanes of a [K, L] column: gD's slab for
        the stripe above."""
        return slice(0, self.bp.spec.Gx)

    def bot(self):
        return slice(self.bot_off, self.bot_off + self.bp.spec.Gx)

    def place_top(self, slab):
        """[.., Gx] -> [.., L] at the my0 border lanes [0, Gx)."""
        return F.pad(slab, (0, self.bp.spec.L - slab.shape[-1]))

    def place_bot(self, slab):
        """[.., Gx] -> [.., L] at the myT border lanes."""
        spec = self.bp.spec
        return F.pad(slab, (self.bot_off, spec.L - self.bot_off - spec.Gx))

    def subst_views(self, views, halos, t: int):
        """Replace the wrap-garbage border lanes of banded._seam_views'
        rolls with the neighbours' halo values."""
        syu0, syd0, sydT, syuT = views
        halo_syd, halo_syu = halos
        spec = self.bp.spec
        slab0 = halo_syd[:, _clip(t, 0, spec.Bw - 1)]
        syd0 = torch.where(self.top_L, self.place_top(slab0), syd0)
        slabT = halo_syu[:, _clip(t - (spec.Bh - 1), 0, spec.Bw - 1)]
        syuT = torch.where(self.bot_L, self.place_bot(slabT), syuT)
        return syu0, syd0, sydT, syuT

    def src_below(self, src, slab, t: int):
        """The F-tail y source with the last block-row's lanes taken from
        the stripe below's first-row gD ``slab`` [K, Gx]."""
        spec = self.bp.spec
        at = _clip(t, 0, spec.Bw - 1) * spec.nb + (spec.Gy - 1) * spec.Gx
        subst = torch.zeros_like(src)
        subst[:, at:at + spec.Gx] = slab
        return torch.where(self.l2_bot, subst, src)

    def src_above(self, src, slab, t: int):
        """The B-tail y source with the first block-row's lanes taken from
        the stripe above's last-row gD ``slab`` [K, Gx]."""
        spec = self.bp.spec
        at = _clip(t - (spec.Bh - 1), 0, spec.Bw - 1) * spec.nb
        subst = torch.zeros_like(src)
        subst[:, at:at + spec.Gx] = slab
        return torch.where(self.l2_top, subst, src)


class _Stripes:
    """One pair's stripes over the shards of a line (all in this process,
    or one a process: parallel/multihost.py)."""

    def __init__(self, line: Line, unary, positions, nbr_positions, alphas,
                 messages, *, H: int, spec: BandedSpec, kernel, tol):
        self.line, self.spec = line, spec
        Hl, n = spec.H, line.n
        self.ctx, self.state = [], []
        for i, dev in zip(line.index, line.devices):
            rows = slice(i * Hl, (i + 1) * Hl)
            part = [a[..., rows, :].to(dev).contiguous()
                    for a in (unary, positions, nbr_positions, alphas,
                              messages)]
            bp = _BandedProblem(*part[:4], spec, kernel, tol,
                                stripe=(i * Hl, H, i > 0, i < n - 1))
            self.ctx.append(_StripeCtx(bp))
            self.state.append(messages_to_state(part[4], bp))
        self.acc_t = acc_dtype(unary.dtype)

    def _from(self, vals, step: int):
        """line.shift with zeros where no stripe sends (the image edges)."""
        got = self.line.shift(vals, step)
        return [torch.zeros_like(v) if g is None else g
                for g, v in zip(got, vals)]

    def exchange(self):
        """Per stripe (the SyD border row of the stripe above, the SyU
        border row of the stripe below), [K, Bw, Gx] each."""
        Gy = self.spec.Gy
        syd = self._from([c.row(st[2][3], Gy - 1)
                          for c, st in zip(self.ctx, self.state)], 1)
        syu = self._from([c.row(st[2][2], 0)
                          for c, st in zip(self.ctx, self.state)], -1)
        return list(zip(syd, syu))

    def _views(self, t: int):
        return [c.subst_views(banded._seam_views(c.bp, st[2], t), h, t)
                for c, st, h in zip(self.ctx, self.state, self.exchange())]

    def sweep(self):
        """One forward + backward pass -> the stripes' lb partials."""
        T = self.spec.T
        for t in range(T):
            views = self._views(t)
            pre = [banded._fwd_gd(c.bp, st, t, v)
                   for c, st, v in zip(self.ctx, self.state, views)]
            below = self._from([gD[:, c.top()]
                                for c, (gD, _) in zip(self.ctx, pre)], -1)
            self.state = [
                banded._fwd_sends(
                    c.bp, st, t, v, gD, masks,
                    c.src_below(banded._fwd_y_src(c.bp, gD, t), slab, t))
                for c, st, v, (gD, masks), slab in zip(
                    self.ctx, self.state, views, pre, below)]
        lbs = [torch.zeros((), dtype=self.acc_t, device=c.bp.device)
               for c in self.ctx]
        for t in range(T - 1, -1, -1):
            views = self._views(t)
            pre = [banded._bwd_gd(c.bp, st, t, v)
                   for c, st, v in zip(self.ctx, self.state, views)]
            above = self._from([gD[:, c.bot()]
                                for c, (gD, _, _) in zip(self.ctx, pre)], 1)
            for k, (c, v, (gD, masks, lb), slab) in enumerate(
                    zip(self.ctx, views, pre, above)):
                src = c.src_above(banded._bwd_y_src(c.bp, gD, t), slab, t)
                self.state[k], lb_t = banded._bwd_sends(
                    c.bp, self.state[k], t, v, gD, masks, lb, src)
                lbs[k] = lbs[k] + lb_t
        return lbs

    def decode(self):
        """banded._decode_state on every stripe -> (the stripes' labels
        [Hl, W], their energy partials).  Per step the stripes exchange the
        just-decoded top-row solutions, consumed by the stripe above Bh - 1
        steps later; the border rows of the (frozen) side arrays and the
        static edge data of the border pairs are exchanged once."""
        spec = self.spec
        T, Gx, Bh, Bw = spec.T, spec.Gx, spec.Bh, spec.Bw
        ctx, state = self.ctx, self.state
        halos = self.exchange()
        rows_q = self._from([c.row(c.bp.PyU_q, 0) for c in ctx], -1)
        rows_d0 = self._from([c.row(c.bp.PyU_d0, 0) for c in ctx], -1)
        rows_a = self._from([c.row(c.bp.PyU_a, 0) for c in ctx], -1)
        consts = [banded._decode_consts(c.bp) for c in ctx]
        sols = [torch.zeros((T + 2, spec.L), dtype=torch.int64,
                            device=c.bp.device) for c in ctx]
        halo_sols = [torch.zeros((T + 2, Gx), dtype=torch.int64,
                                 device=c.bp.device) for c in ctx]
        E = [torch.zeros((), dtype=self.acc_t, device=c.bp.device)
             for c in ctx]
        for t in range(T):
            c_ = t + 1
            tT = _clip(t - (Bh - 1), 0, Bw - 1)
            cr = _clip(c_ - (Bh - 1), 0, T + 1)
            for k, c in enumerate(ctx):
                views = c.subst_views(
                    banded._seam_views(c.bp, state[k][2], t), halos[k], t)
                sol_d, qdn, d0dn, adn = banded._down_seam(c.bp, sols[k], t)
                # the border rows' down neighbours lie in the stripe below
                sol_d = torch.where(c.bot_L, c.place_bot(halo_sols[k][cr]),
                                    sol_d)
                qdn = torch.where(c.bot_L, c.place_bot(rows_q[k][:, tT]),
                                  qdn)
                d0dn = torch.where(c.bot_L, c.place_bot(rows_d0[k][:, tT]),
                                   d0dn)
                adn = torch.where(c.bot_L, c.place_bot(rows_a[k][tT]), adn)
                sol, e = banded._decode_step(c.bp, state[k], t, sols[k],
                                             views, consts[k],
                                             (sol_d, qdn, d0dn, adn))
                E[k] = E[k] + e
                sols[k][c_] = sol
            up = self._from([s[c_, :Gx] for s in sols], -1)
            for hs, u in zip(halo_sols, up):
                hs[c_] = u
        labels = [from_cols(s.to(c.bp.dtype), spec).to(torch.int32)
                  for s, c in zip(sols, ctx)]
        return labels, E

    def messages(self):
        return self.line.gather([state_to_messages(st, c.bp)
                                 for st, c in zip(self.state, self.ctx)], -2)


def sharded_banded_run(
    mesh: Mesh,
    unary: torch.Tensor,  # [K, H, W] or [B, K, H, W]
    positions: torch.Tensor,  # D0
    nbr_positions: torch.Tensor,  # Q [(B,) 4, K, H, W]
    alphas: torch.Tensor,  # [(B,) 4, H, W]
    *,
    kernel: int,
    tol,
    Bh: int,
    Bw: int,
    sweeps: int,
    decode_every: int | None = None,
    messages: torch.Tensor | None = None,
    axis: str = "y",
    line: Line | None = None,
) -> TRWSResult:
    """Banded TRW-S over the gy stripes of a mesh row.

    Fixed-budget chunk semantics matching BandedRun.run: ``sweeps`` passes,
    decoding every ``decode_every`` and keeping the best labeling seen.
    Labels and messages are bit for bit those of the one-device solver;
    energy and lower bound agree to reassociation (sums of per-stripe
    partials).  Requires ceil(H/Bh) % n_stripes == 0 so every stripe holds
    the same number of whole block-rows; the image is padded to whole
    block-rows, the pad rows masked in the last stripe.

    Batched inputs ([B, K, H, W] etc.) put pair b on the mesh's 'batch' row
    b (B must equal the 'batch' size), its stripes over that row, the pairs
    in lockstep.  ``line`` replaces the mesh by another line of shards
    (parallel/multihost.py passes one over processes).  Results are gathered
    on the first device of the mesh (or of ``line``)."""
    batched = unary.ndim == 4
    if line is not None:
        lines = [line]
    else:
        if mesh.axis_names[-1] != axis:
            raise ValueError(f"mesh axes {mesh.axis_names} have no '{axis}' "
                             f"axis last")
        lines = [mesh.line(b) for b in range(mesh.shape["batch"])]
    if batched:
        B = int(unary.shape[0])
        if len(lines) != B:
            raise ValueError(
                f"batched solve needs a 'batch' mesh axis of size {B}")
    K, H, W = unary.shape[-3:]
    n = lines[0].n
    Gy = -(-H // Bh)
    if Gy % n != 0:
        raise ValueError(
            f"ceil(H/Bh) = {Gy} block-rows not divisible by the mesh "
            f"'{axis}' axis ({n}); pick Bh so stripes get whole block-rows")
    Hl, Hp = (Gy // n) * Bh, Gy * Bh
    if decode_every is None or decode_every >= sweeps:
        decode_every = sweeps
    sweeps = (sweeps // decode_every) * decode_every
    spec_l = BandedSpec(Hl, W, Bh, Bw)
    if messages is None:
        messages = torch.zeros(unary.shape[:-3] + (4, K, H, W),
                               dtype=unary.dtype, device=unary.device)

    def padH(a):
        return F.pad(a, (0, 0, 0, Hp - H))

    inputs = [padH(a) for a in (unary, positions, nbr_positions, alphas,
                                messages)]
    pairs = [inputs] if not batched else [[a[b] for a in inputs]
                                          for b in range(B)]
    runs = [_Stripes(ln, *p, H=H, spec=spec_l, kernel=kernel, tol=tol)
            for ln, p in zip(lines, pairs)]
    best = [(torch.full((), float("inf"), dtype=r.acc_t,
                        device=r.line.device), None) for r in runs]
    lbs = [None] * len(runs)
    for _ in range(sweeps // decode_every):
        for _ in range(decode_every):
            lbs = [r.sweep() for r in runs]
        for j, r in enumerate(runs):
            labels, E = r.decode()
            Eg = r.line.total(E)
            bestE, bestL = best[j]
            better = Eg < bestE
            if bestL is None:
                bestL = [torch.zeros_like(lab) for lab in labels]
            bestL = [torch.where(better.to(lab.device), lab, bl)
                     for lab, bl in zip(labels, bestL)]
            best[j] = (torch.where(better, Eg, bestE), bestL)
    out = []
    for r, (bestE, bestL), lb in zip(runs, best, lbs):
        out.append((r.line.gather(bestL, -2)[:H], bestE, r.line.total(lb),
                    r.messages()[..., :H, :]))
    if not batched:
        L, E, lb, M = out[0]
        return TRWSResult(L, E, lb, sweeps, M)
    dev = runs[0].line.device
    stack = lambda xs: torch.stack([x.to(dev) for x in xs])  # noqa: E731
    return TRWSResult(*(stack([o[j] for o in out]) for j in range(3)),
                      sweeps, stack([o[3] for o in out]))
