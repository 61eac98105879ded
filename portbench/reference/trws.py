"""Plain reference of one TRW-S sweep on a K-label grid problem, used to
certify the lower bound that a solve reports.

The problem: labels k = 0 .. K-1 at every pixel, unary theta [K, H, W], and
for every directed edge E(p, d) of the 4-neighbourhood (tail
n = p + DIRS[d], head p) the term

    V(k_n, k_p) = alpha[d, p] * min(|Q[d, k_n, p] - D0[k_p, p]|, tol)

(kernel 1).  A message state holds one K-vector per directed edge,
``messages[d, :, p]`` for E(p, d), indexed by the labels of the endpoint
that comes first in the node order ``t`` [H, W] (no two neighbours share a
``t``): the state a TRW-S backward pass leaves.  Any numbers are a valid
state; the state only sets how tight the bound comes out.

``sweep`` runs one forward and one backward pass of TRW-S (Kolmogorov,
PAMI 2006) in that order, vectorised over the nodes of one ``t``, with the
node weights gamma = 1 / max(#edges to later nodes, #edges to earlier
nodes).  The bound it returns is the backward pass's: the sum of the node
minima and of the messages' minima (both subtracted as they are taken), a
dual value, so at most the energy of every labelling whatever state the
sweep starts from.  Plain PyTorch in float64 by default; it imports nothing
of the program.
"""

from __future__ import annotations

import torch

# (dy, dx) of the neighbour each in-edge direction comes from
DIRS = ((0, -1), (0, 1), (-1, 0), (1, 0))


def banded_order(H: int, W: int, Bh: int, Bw: int, device=None):
    """t = (y mod Bh) + (x mod Bw): rows and columns of Bh x Bw blocks
    swept by anti-diagonals, every block at once."""
    ys = torch.arange(H, device=device)[:, None]
    xs = torch.arange(W, device=device)[None, :]
    return (ys % Bh) + (xs % Bw)


class Problem:
    """The edges of an H x W grid problem, in the layout of one sweep."""

    def __init__(self, theta, D0, Q, alphas, tol: float, t):
        K, H, W = theta.shape
        dev = theta.device
        self.K, self.H, self.W, self.tol = K, H, W, float(tol)
        self.theta = theta.reshape(K, -1)
        self.D0 = D0.reshape(K, -1)
        self.Q = Q.reshape(4, K, -1)
        self.alphas = alphas.reshape(4, -1)
        N = H * W
        ys, xs = torch.meshgrid(torch.arange(H, device=dev),
                                torch.arange(W, device=dev), indexing="ij")
        head, tail, dirs = [], [], []
        for d, (dy, dx) in enumerate(DIRS):
            ny, nx = ys + dy, xs + dx
            ok = (ny >= 0) & (ny < H) & (nx >= 0) & (nx < W)
            head.append((ys * W + xs)[ok])
            tail.append((ny * W + nx)[ok])
            dirs.append(torch.full_like(head[-1], d))
        self.head, self.tail = torch.cat(head), torch.cat(tail)
        self.dir = torch.cat(dirs)
        tf = t.reshape(-1).to(dev)
        if bool((tf[self.head] == tf[self.tail]).any()):
            raise ValueError("two neighbours share a step of the order")
        head_first = tf[self.head] < tf[self.tail]
        self.first = torch.where(head_first, self.head, self.tail)
        self.last = torch.where(head_first, self.tail, self.head)
        ones = torch.ones(len(self.head), dtype=theta.dtype, device=dev)
        n_fwd = torch.zeros(N, dtype=theta.dtype, device=dev).index_add_(
            0, self.first, ones)
        n_bwd = torch.zeros(N, dtype=theta.dtype, device=dev).index_add_(
            0, self.last, ones)
        self.gamma = 1.0 / torch.clamp(torch.maximum(n_fwd, n_bwd), min=1.0)
        # every edge at each endpoint, padded with the dummy edge F
        F = len(self.head)
        ends = torch.cat([self.head, self.tail])
        ids = torch.cat([torch.arange(F, device=dev)] * 2)
        order = torch.argsort(ends, stable=True)
        ends, ids = ends[order], ids[order]
        count = torch.bincount(ends, minlength=N)
        slot = torch.arange(len(ends), device=dev) - (
            torch.cumsum(count, 0) - count)[ends]
        self.incident = torch.full((N, 8), F, dtype=torch.long, device=dev)
        self.incident[ends, slot] = ids
        # the edges each step sends on: forward from its nodes to later
        # ones, backward from its nodes to earlier ones
        steps = torch.unique(tf)
        self.steps = [int(s) for s in steps]
        self.fwd = {s: torch.nonzero(tf[self.first] == s)[:, 0]
                    for s in self.steps}
        self.bwd = {s: torch.nonzero(tf[self.last] == s)[:, 0]
                    for s in self.steps}
        self.nodes = {s: torch.nonzero(tf == s)[:, 0] for s in self.steps}

    def state(self, messages):
        """[4, K, H, W] -> [F + 1, K] (the last row the dummy edge's 0)."""
        m = messages.reshape(4, self.K, -1).to(self.theta.dtype)
        rows = m[self.dir, :, self.head]
        return torch.cat([rows, torch.zeros_like(rows[:1])])

    def messages(self, M):
        """[F + 1, K] -> [4, K, H, W] (0 on edges that leave the image)."""
        out = torch.zeros((4, self.K, self.H * self.W), dtype=M.dtype,
                          device=M.device)
        out[self.dir, :, self.head] = M[:-1]
        return out.reshape(4, self.K, self.H, self.W)

    def beliefs(self, M, nodes):
        """theta + every message at ``nodes``: [len(nodes), K]."""
        return self.theta[:, nodes].T + M[self.incident[nodes]].sum(1)

    def send(self, M, edges, src, gD):
        """New messages on ``edges`` from their endpoints ``src`` (whose
        gamma-weighted beliefs are ``gD`` [E, K]), to the other endpoints:
        (message minus its minimum, the minimum)."""
        h, d = self.head[edges], self.dir[edges]
        Qe = self.Q[d, :, h]  # [E, K] over the tail's labels
        De = self.D0[:, h].T  # [E, K] over the head's labels
        V = self.alphas[d, h][:, None, None] * (
            Qe[:, :, None] - De[:, None, :]).abs().clamp(max=self.tol)
        from_head = src == h  # V as [E, k_src, k_dst]
        V = torch.where(from_head[:, None, None], V.transpose(1, 2), V)
        msg = ((gD - M[edges])[:, :, None] + V).min(1).values
        vmin = msg.min(1).values
        return msg - vmin[:, None], vmin

    def sweep(self, M):
        """One forward and one backward pass from the state M [F + 1, K]
        (changed in place) -> (M, lower bound)."""
        lb = torch.zeros((), dtype=self.theta.dtype,
                         device=self.theta.device)
        for s in self.steps:
            e = self.fwd[s]
            if len(e):
                src = self.first[e]
                gD = self.gamma[src][:, None] * self.beliefs(M, src)
                M[e] = self.send(M, e, src, gD)[0]
        for s in reversed(self.steps):
            nodes = self.nodes[s]
            D = self.beliefs(M, nodes)
            vmin = D.min(1).values
            lb = lb + vmin.sum()
            e = self.bwd[s]
            if len(e):
                src = self.last[e]
                pos = torch.searchsorted(nodes, src)
                gD = self.gamma[src][:, None] * (D - vmin[:, None])[pos]
                M[e], mmin = self.send(M, e, src, gD)
                lb = lb + mmin.sum()
        return M, lb


def certified_bound(theta, D0, Q, alphas, tol: float, t, messages):
    """The lower bound of one reference sweep from ``messages``."""
    p = Problem(theta, D0, Q, alphas, tol, t)
    return float(p.sweep(p.state(messages))[1])
