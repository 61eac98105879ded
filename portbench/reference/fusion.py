"""Plain reference of a binary fusion move (the CVPR 2013 fusion step as the
program states it), float64 by default.

A move between the current plane field (label 0) and a proposal (label 1)
is a two-label MRF with the model's unary and its weighted truncated
smoothness on normalised disparities (reference/planes.py).  It is
solved by sequential tree-reweighted message passing on the checkerboard
order (black pixels, then white), checked every 5 iterations, at most 50,
stopping when (E - bound) / E < 1e-6; the labelling is decoded greedily
(black pixels from their beliefs, white ones conditioned on the black), and
the proposal is taken on exactly the 4-connected components of the decoded
mask whose flip does not raise the energy; a move that would raise it keeps
the current field.  Messages of a two-label edge are one signed number d:
(m0, m1) = (max(-d, 0), max(d, 0)).

Components come from scipy.ndimage on the host.  Nothing of the program is
imported.
"""

from __future__ import annotations

import torch
from scipy import ndimage

from portbench.reference import planes

CHECK_EVERY = 5
MAXITER = 50
MAX_RELGAP = 1e-6
OPP = (1, 0, 3, 2)


def _from(x: torch.Tensor, d: int, fill=0.0) -> torch.Tensor:
    """x at each pixel's direction-d neighbour ([..., H, W]); ``fill`` where
    there is none."""
    dy, dx = planes.DIRS[d]
    out = torch.full_like(x, fill)
    H, W = x.shape[-2:]
    ys = slice(max(0, -dy), H - max(0, dy))
    xs = slice(max(0, -dx), W - max(0, dx))
    ys2 = slice(max(0, dy), H + min(0, dy))
    xs2 = slice(max(0, dx), W + min(0, dx))
    out[..., ys, xs] = x[..., ys2, xs2]
    return out


def _gap_open(e: float, lb: float) -> bool:
    return e != 0 and (e - lb) / e >= MAX_RELGAP


def _split(md):
    return (-md).clamp(min=0), md.clamp(min=0)


class Move:
    """The two-label problem of one move: unaries t0, t1 [H, W] and the
    directed-edge tables V [4, 2, 2, H, W] (tail label, head label), zero on
    edges that leave the image.  ``unary``: the model's unary of a plane
    field; ``weights`` [4, H, W]: the edges' (0 where the tail lies outside
    the image); ``normalize``: the model's (d_min, d_step) or None."""

    def __init__(self, unary, weights, tol, cur, prop, normalize=None):
        self.t0 = unary(cur)
        self.t1 = unary(prop)
        (D0c, Qc, ok), (D0p, Qp, _) = (planes.positions(p, normalize)
                                       for p in (cur, prop))
        own, nb = (D0c, D0p), (Qc, Qp)
        self.V = torch.stack([torch.stack([torch.stack(
            [weights[d] * (nb[i][d] - own[j]).abs().clamp(max=tol)
             for j in range(2)]) for i in range(2)]) for d in range(4)])
        self.valid = ok.to(cur.dtype)
        H, W = self.t0.shape
        yy = torch.arange(H, device=cur.device)[:, None]
        xx = torch.arange(W, device=cur.device)[None, :]
        self.black = (yy + xx) % 2 == 0
        self.gamma = 1.0 / (2.0 * self.valid.sum(0))

    def beliefs(self, M):
        b0, b1 = self.t0.clone(), self.t1.clone()
        for d in range(4):
            for m in (M[d], _from(M[OPP[d]], d)):
                m0, m1 = _split(m)
                b0, b1 = b0 + m0, b1 + m1
        return b0, b1

    def phase(self, M, mask, with_bound):
        b0, b1 = self.beliefs(M)
        bound = 0.0
        if with_bound:
            vmin = torch.minimum(b0, b1)
            b0, b1 = b0 - vmin, b1 - vmin
            bound = torch.where(mask, vmin, 0.0).sum()
        g0, g1 = self.gamma * b0, self.gamma * b1
        out = []
        for d in range(4):
            V = self.V[d]
            m0, m1 = _split(M[d])
            # the head (this pixel) sends to the tail: over the head's label
            h0, h1 = g0 - m0, g1 - m1
            b_msg = [torch.minimum(h0 + V[i, 0], h1 + V[i, 1])
                     for i in range(2)]
            # the tail (the neighbour) sends to the head
            a0, a1 = _from(g0, d) - m0, _from(g1, d) - m1
            a_msg = [torch.minimum(a0 + V[0, j], a1 + V[1, j])
                     for j in range(2)]
            n0 = torch.where(mask, b_msg[0], a_msg[0])
            n1 = torch.where(mask, b_msg[1], a_msg[1])
            if with_bound:
                bound = bound + (torch.minimum(n0, n1) * self.valid[d]).sum()
            out.append((n1 - n0) * self.valid[d])
        return torch.stack(out), bound

    def edge_cost(self, d, zn, z):
        V = self.V[d]
        return torch.where(zn, torch.where(z, V[1, 1], V[1, 0]),
                           torch.where(z, V[0, 1], V[0, 0]))

    def energy(self, z):
        e = torch.where(z, self.t1, self.t0).sum()
        for d in range(4):
            e = e + self.edge_cost(d, _from(z, d, False), z).sum()
        return e

    def decode(self, M):
        b0, b1 = self.beliefs(M)
        zb = b1 < b0
        c0, c1 = self.t0.clone(), self.t1.clone()
        for d in range(4):
            zn = _from(zb, d, False)
            V = self.V[d]
            c0 = c0 + torch.where(zn, V[1, 0], V[0, 0])
            c1 = c1 + torch.where(zn, V[1, 1], V[0, 1])
            Vo = self.V[OPP[d]]
            c0 = c0 + _from(torch.where(zb, Vo[0, 1], Vo[0, 0]), d)
            c1 = c1 + _from(torch.where(zb, Vo[1, 1], Vo[1, 0]), d)
        return torch.where(self.black, zb, c1 < c0)

    def accept(self, z):
        """z restricted to its components whose flip does not raise the
        energy."""
        zh = z.cpu().numpy()
        comp, n = ndimage.label(zh)  # 4-connectivity
        if n == 0:
            return z
        delta = torch.where(z, self.t1 - self.t0, torch.zeros_like(self.t0))
        owner = torch.as_tensor(comp, device=z.device).long()
        sums = torch.zeros(n + 1, dtype=delta.dtype, device=z.device)
        sums.index_add_(0, owner.reshape(-1), delta.reshape(-1))
        for d in range(4):
            zn = _from(z, d, False)
            dE = self.edge_cost(d, zn, z) - self.V[d, 0, 0]
            # an edge with a flipped endpoint belongs to that endpoint's
            # component (both endpoints flipped: the same component)
            where = torch.where(z, owner, _from(owner, d, 0))
            sums.index_add_(0, where.reshape(-1),
                            torch.where(z | zn, dE,
                                        torch.zeros_like(dE)).reshape(-1))
        good = sums <= 0
        good[0] = False
        return good[owner]

    def solve(self):
        """(take mask, energy of the move's result)."""
        M = torch.zeros_like(self.V[:, 0, 0])
        it, e, lb = 0, None, None
        while it < MAXITER and (it == 0 or _gap_open(e, lb)):
            for _ in range(CHECK_EVERY):
                M, _ = self.phase(M, self.black, False)
                M, lb_sweep = self.phase(M, ~self.black, True)
            b0, b1 = self.beliefs(M)
            lb = float(lb_sweep + torch.where(self.black, torch.minimum(b0, b1),
                                                 0.0).sum())
            z = self.decode(M)
            e = float(self.energy(z))
            it += CHECK_EVERY
        take = self.accept(z)
        e = float(self.energy(take))
        e_keep = float(self.energy(torch.zeros_like(take)))
        if e > e_keep:
            return torch.zeros_like(take), e_keep
        return take, e


def fusion_sweep(unary, weights, tol, start, props, normalize=None):
    """Fuse ``props`` ([P, 4, H, W], in order) into ``start`` [4, H, W]
    (``unary``, ``weights``, ``normalize``: as Move's).  Returns (final
    field, energy after each move)."""
    cur = start
    trace = []
    for p in props:
        take, e = Move(unary, weights, tol, cur, p, normalize).solve()
        cur = torch.where(take[None], p, cur)
        trace.append(e)
    return cur, trace
