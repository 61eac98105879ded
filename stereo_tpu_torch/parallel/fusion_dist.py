"""Distributed binary fusion: fusion moves over the column shards of a mesh
(port of stereo_tpu/parallel/fusion_dist.py).

A fusion move (solvers/binary.py) is a K = 2 checkerboard TRW-S followed by
per-component acceptance.  Sharded over the image columns of a mesh row
(parallel/mesh.py), every step keeps the owned pixels' arithmetic of one
device:

- the K = 2 phases, the decode and the energy partials run on every shard's
  span with the global colours, gammas and masks; the messages' halo columns
  are exchanged after every phase, the take mask's after the decode;
- the connected-component flood's row scans cross the cuts: each shard scans
  its own columns, the shards' end values are combined in shard order (the
  scan's own monoid, so the min-ids cross every cut in every scan) and each
  shard folds the carry into its run before its first wall.  The column
  scans stay inside a shard.  A segmented min is exact, so the ids are those
  of one device;
- the verdicts run the sorted segmented scan (accept_method='sort') on the
  component ids and flip deltas **gathered** on the row's first device: its
  fixed combine order is what makes the accepted take mask bit for bit the
  one-device mask, where index_add_ on a card sums in no fixed order.  The
  [H, W] ids and deltas are all that is gathered;
- ``improve`` > 0 polishes the decoded mask (ICM + 2x2 blocks) on the
  gathered mask, on the row's first device, and splits the result again.

Only the energy and lower-bound sums are reassociated (per-shard partials).
The never-increase backstop compares two such sums of the same per-pixel
maps, so it holds under sharding unchanged.
"""

from __future__ import annotations

import torch

from stereo_tpu_torch import energy, geometry
from stereo_tpu_torch.device import acc_dtype
from stereo_tpu_torch.energy import default_weights
from stereo_tpu_torch.geometry import NUM_DIRS
from stereo_tpu_torch.models.base import _positions
from stereo_tpu_torch.parallel.mesh import Columns, Mesh
from stereo_tpu_torch.solvers import binary, trws

__all__ = ["sharded_fusion_step", "sharded_fusion_sweep"]


def _line(mesh: Mesh, axis: str):
    if mesh.axis_names[-1] != axis:
        raise ValueError(f"mesh axes {mesh.axis_names} have no '{axis}' "
                         f"axis last")
    return mesh.line(0)


class _Shards:
    """The static per-shard data of one image's K = 2 moves: spans, the
    global colours, gammas, validity masks and the owned pixels."""

    def __init__(self, line, H: int, W: int, dtype):
        self.cols = cols = Columns(line, W)
        self.line, self.H, self.W = line, H, W
        self.cb, self.gamma, self.valid, self.own = [], [], [], []
        for i, dev in zip(line.index, line.devices):
            a, x0, x1, _ = cols.cols(i)
            b = cols.bounds[i][3]
            self.cb.append(trws.checkerboard(H, W, device=dev)[:, a:b])
            self.gamma.append(trws.node_gamma(H, W, dtype, device=dev)[:, a:b])
            self.valid.append(default_weights(H, W, dtype,
                                              device=dev)[..., a:b])
            xs = torch.arange(a, b, device=dev)
            self.own.append(((xs >= x0) & (xs < x1))[None, :].expand(H, b - a))

    def x0(self, k: int) -> int:
        """Global column of span k's column 0."""
        return self.cols.bounds[self.line.index[k]][0]

    def split(self, field):
        return self.cols.split(field)


def _row_scan(sh: _Shards, comp, live, reverse: bool):
    """binary._segmented_min_scan along the columns (axis 1) of the owned
    parts ``comp`` [H, w] across the cuts, exactly."""
    line = sh.line
    loc = [binary._segmented_min_scan(c, z, 1, reverse)
           for c, z in zip(comp, live)]
    end = slice(0, 1) if reverse else slice(-1, None)
    # each shard's summary (its value at its far end, whether it has a wall)
    vals = line.gather([v[:, end] for v in loc], 1)  # [H, n]
    walls = line.gather([(~z).any(1, keepdim=True) for z in live], 1)
    order = range(line.n - 1, -1, -1) if reverse else range(line.n)
    big = torch.iinfo(vals.dtype).max
    cv = torch.full_like(vals[:, 0], big)
    cw = torch.zeros_like(walls[:, 0])
    carry = [None] * line.n
    for j in order:  # exclusive scan of the summaries, the scan's monoid
        carry[j] = cv
        cv = torch.where(walls[:, j], vals[:, j], torch.minimum(cv, vals[:, j]))
        cw = cw | walls[:, j]
    out = []
    for v, z, i in zip(loc, live, line.index):
        wall = (~z).to(torch.int32)
        seen = (wall.flip(1).cummax(1).values.flip(1) if reverse
                else wall.cummax(1).values) > 0
        c = carry[i].to(v.device)[:, None]
        out.append(torch.where(seen, v, torch.minimum(v, c)))
    return out


def _components(sh: _Shards, z):
    """binary.connected_components of the owned parts ``z`` [H, w] of a
    sharded mask: the same floods and the same stopping test, the ids flat
    global pixel indices."""
    line, H, W = sh.line, sh.H, sh.W
    N = H * W
    comp = []
    for zk, i in zip(z, line.index):
        _, x0, x1, _ = sh.cols.cols(i)
        idx = (torch.arange(H, device=zk.device, dtype=torch.int32)[:, None]
               * W + torch.arange(x0, x1, device=zk.device,
                                  dtype=torch.int32)[None, :])
        comp.append(torch.where(zk, idx, N))

    def flood(comp):
        for reverse in (False, True):
            s = _row_scan(sh, comp, z, reverse)
            comp = [torch.where(zk, torch.minimum(c, sk), N)
                    for c, sk, zk in zip(comp, s, z)]
        for reverse in (False, True):
            comp = [torch.where(zk, torch.minimum(
                c, binary._segmented_min_scan(c, zk, 0, reverse)), N)
                for c, zk in zip(comp, z)]
        return comp

    def not_uniform(comp):
        flags = []
        for zk, c in zip(z, comp):
            bad = torch.zeros((), dtype=torch.bool, device=zk.device)
            for d in range(NUM_DIRS):
                zn = geometry.shift_from_neighbor(zk, d, fill=False)
                cn = geometry.shift_from_neighbor(c, d, fill=N)
                bad = bad | torch.any(zk & zn & (c != cn))
            flags.append(bad)
        # the edges across the cuts: my last column against the right
        # neighbour's first
        nxt = line.shift([torch.stack([zk[:, 0].to(c.dtype), c[:, 0]])
                          for zk, c in zip(z, comp)], -1)
        for zk, c, r, k in zip(z, comp, nxt, range(len(z))):
            if r is not None:
                flags[k] = flags[k] | torch.any(
                    zk[:, -1] & (r[0] > 0) & (c[:, -1] != r[1]))
        return line.any(flags)

    comp = flood(comp)
    rounds = 0
    while rounds < H + W and not_uniform(comp):
        comp = flood(comp)
        rounds += 1
    return comp


def _accept(sh: _Shards, z, theta0, theta1, V):
    """binary.accept_components(method='sort') on spans whose halos are
    right; returns the take mask's spans (halos right)."""
    own = [sh.cols.owned(zk, i) for zk, i in zip(z, sh.line.index)]
    comp = _components(sh, own)
    delta = [sh.cols.owned(binary._flip_delta(zk, t0, t1, v), i)
             for zk, t0, t1, v, i in zip(z, theta0, theta1, V, sh.line.index)]
    # gathered on one device: the sorted verdict's combine order is fixed by
    # the global ids, so the mask is the one-device mask bit for bit
    comp_g = sh.line.gather(comp, 1)
    delta_g = sh.line.gather(delta, 1)
    good = binary._segment_verdicts_sorted(
        comp_g.reshape(-1), delta_g.reshape(-1), delta_g.dtype)
    good = sh.split(good.reshape(sh.H, sh.W))
    return [zk & g for zk, g in zip(z, good)]


def _fuse(sh: _Shards, U0, U1, D0, Q, w, *, kernel, tol, maxiter,
          max_relgap, improve=0):
    """binary.binary_fuse (accept_method='sort', its default check_every of
    5) over the shards: every argument a list of spans with right halos.
    -> (take spans, energy, lower bound, iterations)."""
    check_every = 5
    line, cols = sh.line, sh.cols
    V = [binary._tables(d0, q, wk, kernel, tol) for d0, q, wk in zip(D0, Q, w)]
    M = [torch.zeros((NUM_DIRS,) + u.shape, dtype=u.dtype, device=u.device)
         for u in U0]
    black = [cb == 0 for cb in sh.cb]
    white = [cb == 1 for cb in sh.cb]
    dev, dtype = line.device, U0[0].dtype
    zero = torch.zeros((), dtype=acc_dtype(dtype), device=dev)
    energy_, lb = zero, zero
    z = [torch.zeros(u.shape, dtype=torch.bool, device=u.device) for u in U0]
    it = 0
    while it < maxiter and (it == 0
                            or trws._gap_open(energy_, lb, max_relgap)):
        for _ in range(check_every):
            M = [binary._k2_phase(u0, u1, m, v, g, va, bl, accumulate_lb=False,
                                  own=o)[0]
                 for u0, u1, m, v, g, va, bl, o in zip(
                     U0, U1, M, V, sh.gamma, sh.valid, black, sh.own)]
            cols.exchange(M)
            out = [binary._k2_phase(u0, u1, m, v, g, va, wh,
                                    accumulate_lb=True, own=o)
                   for u0, u1, m, v, g, va, wh, o in zip(
                       U0, U1, M, V, sh.gamma, sh.valid, white, sh.own)]
            M = [o[0] for o in out]
            cols.exchange(M)
        lbs, es = [], []
        for k, (u0, u1, m, v, cb) in enumerate(zip(U0, U1, M, V, sh.cb)):
            D0b, D1b = binary._beliefs(u0, u1, m)
            lbs.append(out[k][1] + trws._masked_sum(
                black[k] & sh.own[k], torch.minimum(D0b, D1b)))
            z[k] = binary._k2_decode(u0, u1, m, v, cb)
            es.append(binary._k2_energy(z[k], u0, u1, v, own=sh.own[k]))
        energy_, lb = line.total(es), line.total(lbs)
        it += check_every
    cols.exchange(z)

    if improve:
        # polished on the gathered mask (see the module docstring)
        zg = cols.gather(z)
        t0, t1 = cols.gather(U0), cols.gather(U1)
        Vg = cols.gather(V)
        cb = trws.checkerboard(sh.H, sh.W, device=dev)
        zg = binary.icm_polish(zg, t0, t1, Vg, cb, improve)
        z = sh.split(binary.block_polish(zg, t0, t1, Vg, rounds=1))
    take = _accept(sh, z, U0, U1, V)
    energy_ = line.total([binary._k2_energy(t, u0, u1, v, own=o)
                          for t, u0, u1, v, o in zip(take, U0, U1, V,
                                                     sh.own)])
    e_keep = line.total([binary._k2_energy(torch.zeros_like(t), u0, u1, v,
                                           own=o)
                         for t, u0, u1, v, o in zip(take, U0, U1, V,
                                                    sh.own)])
    # the unconditional never-increase backstop of binary_fuse
    worse = bool(energy_ > e_keep)
    if worse:
        take = [torch.zeros_like(t) for t in take]
        energy_ = e_keep
    return take, energy_, lb, it


def _problem_of(sh: _Shards, planes, normalize):
    """(D0, Q) spans of a plane field's spans, halos right."""
    pos = [_positions(p, normalize, x0=sh.x0(k))
           for k, p in enumerate(planes)]
    Q = [q for _, q in pos]
    sh.cols.exchange(Q)  # a span's edge columns lack their outer neighbour
    return [d0 for d0, _ in pos], Q


def sharded_fusion_step(
    mesh: Mesh,
    current: torch.Tensor,  # [4, H, W] incumbent plane field
    proposal: torch.Tensor,  # [4, H, W]
    unary0: torch.Tensor,  # [H, W] unary of the incumbent
    unary1: torch.Tensor,  # [H, W] unary of the proposal
    weights: torch.Tensor,  # [4, H, W] smoothness weights
    *,
    kernel: int,
    tol,
    normalize=None,
    improve: int = 0,
    maxiter: int = 50,
    max_relgap: float = 1e-6,
    axis: str = "x",
):
    """One fusion move with every pixel-grid field sharded over the columns
    of the mesh's first row (its ``axis``).

    Returns (fused_planes, take, energy, lower_bound) on that row's first
    device — ``take`` and the fused planes bit for bit those of the
    one-device move (binary.binary_fuse with accept_method='sort') at a
    fixed iteration budget (max_relgap=0.0 fixes the count: the stopping
    rule compares a reassociated scalar)."""
    line = _line(mesh, axis)
    H, W = current.shape[-2:]
    sh = _Shards(line, H, W, current.dtype)
    cur, prop = sh.split(current), sh.split(proposal)
    D0, Q = [], []
    for k, (c, p) in enumerate(zip(cur, prop)):
        d0, q = binary.fusion_problem(c, p, normalize, x0=sh.x0(k))
        D0.append(d0)
        Q.append(q)
    sh.cols.exchange(Q)
    take, e, lb, _ = _fuse(sh, sh.split(unary0), sh.split(unary1), D0, Q,
                           sh.split(weights), kernel=kernel, tol=tol,
                           maxiter=maxiter, max_relgap=max_relgap,
                           improve=improve)
    fused = [energy.fuse_labelling(c, p, t)
             for c, p, t in zip(cur, prop, take)]
    return sh.cols.gather(fused), sh.cols.gather(take), e, lb


def sharded_fusion_sweep(
    mesh: Mesh,
    current: torch.Tensor,  # [4, H, W]
    prop_stack: torch.Tensor,  # [P, 4, H, W]
    weights: torch.Tensor,  # [4, H, W]
    unary_p,  # callable: plane field [4, H, W] -> unary [H, W]
    *,
    kernel: int,
    tol,
    normalize=None,
    improve: int = 0,
    live: torch.Tensor | None = None,  # [P] bool: identity-mask padded moves
    maxiter: int = 50,
    max_relgap: float = 1e-6,
    axis: str = "x",
):
    """A whole proposal stream of fusion moves, distributed.

    The sharded mirror of models.base._fusion_sweep: the carry (assignment
    and the incremental unary / positions) stays on the shards between
    moves.  ``unary_p`` is the caller's unary of a whole plane field; it
    runs once a move on the proposal (and once on ``current``) where the
    field lies, and its [H, W] result is split.  Returns (fused, energies
    [P], lower_bounds [P]) on the row's first device."""
    line = _line(mesh, axis)
    H, W = current.shape[-2:]
    P = prop_stack.shape[0]
    sh = _Shards(line, H, W, current.dtype)
    if live is None:
        live = torch.ones((P,), dtype=torch.bool)
    live = [bool(a) for a in live.tolist()]
    w = sh.split(weights)
    cur = sh.split(current)
    U0 = sh.split(unary_p(current))
    D0c, Qc = _problem_of(sh, cur, normalize)
    es, lbs = [], []
    for i in range(P):
        prop = sh.split(prop_stack[i])
        U1 = sh.split(unary_p(prop_stack[i]))
        D0p, Qp = _problem_of(sh, prop, normalize)
        D0 = [torch.stack([c, p], 0) for c, p in zip(D0c, D0p)]
        Q = [torch.stack([c, p], 1) for c, p in zip(Qc, Qp)]
        take, e, lb, _ = _fuse(sh, U0, U1, D0, Q, w, kernel=kernel, tol=tol,
                               maxiter=maxiter, max_relgap=max_relgap,
                               improve=improve)
        if not live[i]:
            take = [torch.zeros_like(t) for t in take]
        cur = [energy.fuse_labelling(c, p, t)
               for c, p, t in zip(cur, prop, take)]
        U0 = [torch.where(t, u1, u0) for t, u0, u1 in zip(take, U0, U1)]
        D0c = [torch.where(t, p, c) for t, c, p in zip(take, D0c, D0p)]
        Qc = [torch.stack(
            [torch.where(geometry.shift_from_neighbor(t, d, fill=False),
                         qp[d], qc[d]) for d in range(NUM_DIRS)], 0)
              for t, qc, qp in zip(take, Qc, Qp)]
        sh.cols.exchange(Qc)
        es.append(e)
        lbs.append(lb)
    return sh.cols.gather(cur), torch.stack(es), torch.stack(lbs)
