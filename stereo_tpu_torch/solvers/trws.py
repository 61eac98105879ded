"""Bipartite (checkerboard) TRW-S for simultaneous fusion on the pixel grid
(port of stereo_tpu/solvers/trws.py).

The 4-connected grid is bipartite; choosing the node ordering "all black
(y+x even) before all white" makes every monotonic chain a single edge, and
TRW-S's forward/backward sweeps collapse into two *fully parallel* phases:

  forward  = every edge updates its message from its black endpoint,
  backward = every edge updates its message from its white endpoint,

with the per-node weights gamma(p) = 1 / (2 * #neighbors(p)).  This is exactly
TRW-S for that ordering: the lower bound is monotonically non-decreasing and
the stopping rule is the reference's relative-gap / max-iteration test.

Potential family: for the directed edge (tail n -> head p),

    V(k_n, k_p) = alpha_e * min(|Q[k_n] - D0[k_p]|^kernel, tol)

Message storage: one buffer per directed edge, M[d][k, y, x] = the message on
edge E(p, d) := (tail = neighbor of p in direction DIRS[d] -> head p), stored
at the head pixel.  Its index meaning alternates: after the black phase every
buffer is a function of its white endpoint's labels and vice versa.

The one driver of every schedule on one device (this one, banded.py,
wavefront.py, scanline.py): ``drive`` (the stopping rule) and
``PreparedRun.run`` (a fixed budget), through four calls of a packed problem
that ``_Problem`` answers itself and the other schedules through ``Packed``.

PyTorch idiom: the solver's loops are Python loops; the stopping rule costs
one host synchronisation per ``check_every`` sweeps.  On a CUDA device each
phase runs one hand-written kernel (ops/phase_kernel.py).  ``use_kernel=False``
runs the plain PyTorch phase instead: a comparison aid for the on-device smoke
run and the tests, not a mode for users (on the CPU the wrappers take the
plain version anyway).  ``message_dtype`` narrows the message storage
(bfloat16 or float16; ``solve`` and ``TRWSRun``), as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stereo_tpu_torch import geometry
from stereo_tpu_torch.device import DEFAULT_DEVICE, acc_dtype, resolve_device
from stereo_tpu_torch.energy import default_weights, truncated_kernel
from stereo_tpu_torch.geometry import NUM_DIRS, OPP, take_plane
from stereo_tpu_torch.ops import checker, phase_kernel
from stereo_tpu_torch.utils.profiling import span


class TRWSResult(NamedTuple):
    labels: torch.Tensor  # [H, W] int32, argmin label per pixel
    energy: torch.Tensor  # scalar: energy of the decoded labeling
    lower_bound: torch.Tensor  # scalar: TRW-S dual lower bound
    iterations: int
    messages: torch.Tensor  # [4, K, H, W] final message state


def checkerboard(H: int, W: int, device=DEFAULT_DEVICE) -> torch.Tensor:
    """[H, W] int32: 0 for black (y+x even, processed first), 1 for white."""
    dev = resolve_device(device)
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    return ((ys + xs) % 2).to(torch.int32)


def node_gamma(H: int, W: int, dtype=torch.float32,
               device=DEFAULT_DEVICE) -> torch.Tensor:
    """gamma(p) = 1 / (2 * #neighbors(p)): the monotonic-chain weight."""
    dev = resolve_device(device)
    deg = torch.zeros((H, W), dtype=dtype, device=dev)
    for d in range(NUM_DIRS):
        deg = deg + geometry.valid_mask(H, W, d, dtype=dtype, device=dev)
    return 1.0 / (2.0 * deg)


def _node_beliefs(theta, M):
    """theta + sum of all 8 incident message buffers, for every pixel.

    Valid only at pixels whose incident buffers currently point *into* them;
    callers mask by checkerboard color.  theta comes first, so narrow
    messages are added to a problem-dtype sum, never to each other."""
    D = theta
    for d in range(NUM_DIRS):
        # in-edge buffers E(p, d) live at p
        D = D + M[d]
        # out-edge buffers E(n, OPP(d)) live at the neighbor n = p + DIRS[d]
        D = D + geometry.shift_from_neighbor(M[OPP[d]], d, fill=0.0)
    return D


def _masked_sum(mask, x):
    """sum of x where mask, accumulated in promote(dtype, float32)."""
    return torch.where(mask, x, 0.0).sum(dtype=acc_dtype(x.dtype))


def _own_sum(own, x):
    """sum of x over the pixels a column shard owns (``own`` [H, W] bool),
    or over every pixel when ``own`` is None (one device)."""
    if own is None:
        return x.sum(dtype=acc_dtype(x.dtype))
    return _masked_sum(own, x)


def _and_own(mask, own):
    return mask if own is None else mask & own


def _phase(theta, M, D0, Q, alphas, valid, gamma, cb, color, kernel, tol,
           accumulate_lb, use_kernel=True, own=None):
    """One half-iteration: update every edge's message from its ``color``
    endpoint.  Returns (new_M, lb_nodes, lb_msgs); the lb terms are zero
    unless accumulate_lb (the white/backward phase).  ``own`` ([H, W] bool
    or None) limits the lb terms to the pixels a column shard owns."""
    dtype = theta.dtype
    acc_t = acc_dtype(dtype)
    Dall = _node_beliefs(theta, M)
    phase_mask = cb == color

    lb_nodes = torch.zeros((), dtype=acc_t, device=theta.device)
    if accumulate_lb:
        vminD = torch.min(Dall, dim=0).values  # [H, W]
        Dall = Dall - vminD[None]
        lb_nodes = _masked_sum(_and_own(phase_mask, own), vminD)

    gD = gamma[None] * Dall  # [K, H, W]
    gDs = torch.stack([geometry.shift_from_neighbor(gD, d, fill=0.0)
                       for d in range(NUM_DIRS)], dim=0)
    fn = (phase_kernel.phase_messages if use_kernel
          else phase_kernel.phase_messages_ref)
    newM, vmins = fn(gD, gDs, M, Q, D0, alphas, phase_mask.to(dtype), valid,
                     tol, kernel)
    lb_msgs = torch.zeros((), dtype=acc_t, device=theta.device)
    if accumulate_lb:
        lb_msgs = _masked_sum(_and_own(valid > 0, own), vmins)
    return newM, lb_nodes, lb_msgs


def _phase_compact(theta2, M2, D02, Q2, alphas2, valid2, gamma2, pix2, s,
                   kernel, tol, accumulate_lb, use_kernel=True):
    """Compacted half-iteration (ops/checker.py layout): update every edge's
    message from its color-``s`` endpoint, each variant computed once on its
    own half-grid.  M2/theta2/... are per-color pairs (colours of the local
    columns); returns (new_M2, lb_nodes, lb_msgs).  The lb terms count the
    pixels where ``pix2`` is nonzero: the odd-H pad cells drop out, and so do
    the halo columns of a column shard."""
    o = 1 - s
    dtype = theta2[s].dtype
    acc_t = acc_dtype(dtype)
    dev = theta2[s].device
    H = int(pix2[2])  # full image height rides with the pixel masks

    # beliefs at the source color
    D = theta2[s]
    for d in range(NUM_DIRS):
        D = D + M2[s][d]
        D = D + checker.cshift(M2[o][OPP[d]], d, s, H)

    lb_nodes = torch.zeros((), dtype=acc_t, device=dev)
    if accumulate_lb:
        vminD = torch.min(D, dim=0).values
        D = D - vminD[None]
        lb_nodes = _masked_sum(pix2[s] > 0, vminD)

    gD = gamma2[s][None] * D  # [K, Hc, W]
    gDn = torch.stack([checker.cshift(gD, d, o, H) for d in range(NUM_DIRS)],
                      dim=0)

    fn = (phase_kernel.phase_messages_compact if use_kernel
          else phase_kernel.phase_messages_compact_ref)
    newMs, newMo, vmins, vmino = fn(
        gD, gDn, M2[s], M2[o], Q2[s], Q2[o], D02[s], D02[o],
        alphas2[s], alphas2[o], valid2[s], valid2[o], tol, kernel)

    lb_msgs = torch.zeros((), dtype=acc_t, device=dev)
    if accumulate_lb:
        lb_msgs = (_masked_sum((valid2[s] > 0) & (pix2[s] > 0), vmins)
                   + _masked_sum((valid2[o] > 0) & (pix2[o] > 0), vmino))
    new_M2 = (newMs, newMo) if s == 0 else (newMo, newMs)
    return new_M2, lb_nodes, lb_msgs


def _decode(theta, M, D0, Q, alphas, valid, cb, kernel, tol, own=None):
    """Greedy conditioned decode + exact energy of the decoded labeling.

    Blacks decode from beliefs (all buffers point into blacks after the white
    phase); whites decode conditioned on their black neighbors' solutions.
    ``argmin`` ties resolve to the first minimum.  ``own``: see
    labeling_energy."""
    D_black = _node_beliefs(theta, M)
    sol_black = torch.argmin(D_black, dim=0).to(torch.int32)  # [H, W]

    # whites: theta + sum over the 8 incident edges of V(. , sol_neighbor)
    cost = theta
    D0_sel = take_plane(D0, sol_black)
    for d in range(NUM_DIRS):
        # in-edge E(p, d): V(k_n, k_p) with k_n fixed to the neighbor's label
        sol_n = geometry.shift_from_neighbor(sol_black, d, fill=0)
        Q_sel = take_plane(Q[d], sol_n)  # [H, W]
        cost = cost + alphas[d][None] * truncated_kernel(
            Q_sel[None] - D0, kernel, tol)
        # out-edge E(n, OPP(d)) at neighbor n, brought to p
        t = alphas[OPP[d]][None] * truncated_kernel(Q[OPP[d]] - D0_sel[None],
                                                    kernel, tol)
        cost = cost + geometry.shift_from_neighbor(t, d, fill=0.0)

    sol_white = torch.argmin(cost, dim=0).to(torch.int32)
    labels = torch.where(cb == 0, sol_black, sol_white)

    energy = labeling_energy(labels, theta, D0, Q, alphas, kernel, tol,
                             own=own)
    return labels, energy


def labeling_energy(labels, theta, D0, Q, alphas, kernel, tol, own=None):
    """Exact MRF energy of an integer labeling [H, W] under the solver's
    data; with ``own`` ([H, W] bool) the part of it at the pixels a column
    shard owns (each pixel carries its unary and its in-edges)."""
    u = take_plane(theta, labels)
    E = _own_sum(own, u)
    D0_sel = take_plane(D0, labels)
    for d in range(NUM_DIRS):
        sol_n = geometry.shift_from_neighbor(labels, d, fill=0)
        Q_sel = take_plane(Q[d], sol_n)
        c = alphas[d] * truncated_kernel(Q_sel - D0_sel, kernel, tol)
        E = E + _own_sum(own, c)
    return E


class _Problem:
    """The packed problem of one solve: masks, gammas and (when compact) the
    per-colour half-grid copies, built once.

    ``cols=(a, x0, x1, Wimg)`` builds one column shard of a ``Wimg``-wide
    image (parallel/mesh.py): the tensors given are the image's columns
    [a, a + W), the shard owns columns [x0, x1) and the rest are halo
    columns copied from its neighbours.  The colours, the gammas and the
    validity masks are those of the global columns, the lower-bound and
    energy partials count the owned pixels only, and the compact layout
    keeps the local column parity: global colour s is local colour
    (s + a) % 2.  ``cols=None`` is the one-device problem.

    ``message_dtype``: the messages' storage dtype (None: the problem's)."""

    def __init__(self, unary, positions, nbr_positions, alphas, kernel, tol,
                 mode, compact, use_kernel, cols=None, message_dtype=None):
        if mode not in ("trws", "bp"):
            raise ValueError(f"unknown mode {mode!r}")
        K, H, W = unary.shape
        dev, dtype = unary.device, unary.dtype
        a, x0, x1, Wimg = (0, 0, W, W) if cols is None else cols
        self.K, self.H, self.W = K, H, W
        self.kernel, self.tol, self.mode = kernel, tol, mode
        self.dtype, self.device = dtype, dev
        self.m_dtype = dtype if message_dtype is None else message_dtype
        self.use_kernel = use_kernel
        self.accumulate_lb = mode == "trws"
        # compact on the card (its kernel computes each variant once on its
        # half-grid); the full grid on the CPU, as the JAX package does there
        self.compact = unary.is_cuda if compact is None else bool(compact)
        self.theta, self.D0, self.Q, self.alphas = (
            unary.contiguous(), positions.contiguous(),
            nbr_positions.contiguous(), alphas.contiguous())
        span = slice(a, a + W)
        self.cb = checkerboard(H, Wimg, device=dev)[:, span].contiguous()
        if mode == "bp":
            self.gamma = torch.ones((H, W), dtype=dtype, device=dev)
        else:
            self.gamma = node_gamma(H, Wimg, dtype, device=dev)[:, span]
        self.gamma = self.gamma.contiguous()
        self.valid = default_weights(H, Wimg, dtype,
                                     device=dev)[..., span].contiguous()
        self.own = None
        if cols is not None:
            xs = torch.arange(a, a + W, device=dev)
            self.own = ((xs >= x0) & (xs < x1))[None, :].expand(H, W)
        self.c0 = a % 2  # local colour of global colour 0
        if self.compact:
            ch = self.to_compact
            self.theta2, self.D02, self.Q2, self.alphas2 = map(
                ch, (self.theta, self.D0, self.Q, self.alphas))
            self.valid2, self.gamma2 = ch(self.valid), ch(self.gamma)
            pix = (torch.ones((H, W), dtype=dtype, device=dev)
                   if self.own is None else self.own.to(dtype))
            self.pix2 = (*ch(pix), H)

    def to_compact(self, a):
        return (checker.compact_h(a, 0).contiguous(),
                checker.compact_h(a, 1).contiguous())

    def to_full(self, M2):
        return checker.expand_h(M2[0], M2[1], self.H)

    def init_state(self, messages=None):
        """Message state in storage layout (compact pair or full buffer)."""
        if messages is None:
            messages = torch.zeros((NUM_DIRS, self.K, self.H, self.W),
                                   dtype=self.m_dtype, device=self.device)
        else:
            messages = messages.to(self.m_dtype).contiguous()
        return self.to_compact(messages) if self.compact else messages

    def messages(self, state):
        """[4, K, H, W] message buffer (in the storage dtype) from a
        state."""
        return self.to_full(state) if self.compact else state

    def half(self, M, color: int):
        """The phase of global colour ``color`` (0: black, forward; 1:
        white, backward, with the bound) -> (M, its lb terms)."""
        accumulate_lb = self.accumulate_lb and color == 1
        if self.compact:
            a = (self.theta2, M, self.D02, self.Q2, self.alphas2,
                 self.valid2, self.gamma2, self.pix2)
            M, lb_nodes, lb_msgs = _phase_compact(
                *a, (color + self.c0) % 2, self.kernel, self.tol,
                accumulate_lb=accumulate_lb, use_kernel=self.use_kernel)
        else:
            M, lb_nodes, lb_msgs = _phase(
                self.theta, M, self.D0, self.Q, self.alphas, self.valid,
                self.gamma, self.cb, color, self.kernel, self.tol,
                accumulate_lb=accumulate_lb, use_kernel=self.use_kernel,
                own=self.own)
        return M, lb_nodes + lb_msgs

    def sweep(self, M):
        """One forward + backward pass -> (M, lb of this sweep's phases)."""
        M, _ = self.half(M, 0)
        return self.half(M, 1)

    def check(self, M, lb_sweep):
        """Lower bound and greedy decode of a state -> (energy, lb, labels)."""
        Mf = self.messages(M)
        if self.accumulate_lb:
            # blacks contribute their belief minima to the bound (they have
            # no backward edges)
            D_black = _node_beliefs(self.theta, Mf)
            lb = lb_sweep + _masked_sum(_and_own(self.cb == 0, self.own),
                                        torch.min(D_black, dim=0).values)
        else:
            lb = torch.zeros((), dtype=acc_dtype(self.dtype),
                             device=self.device)
        labels, energy = _decode(self.theta, Mf, self.D0, self.Q, self.alphas,
                                 self.valid, self.cb, self.kernel, self.tol,
                                 own=self.own)
        return energy, lb, labels


def _gap_open(energy, lb, max_relgap, name: str = "trws.stop") -> bool:
    """The stopping rule's test, in the problem's precision; one host sync,
    in a span of ``name`` (the host waits for the device there)."""
    with span(name):
        relgap = torch.where(energy != 0, (energy - lb) / energy,
                             torch.zeros_like(energy))
        return bool(relgap >= max_relgap)


class Packed:
    """A packed problem as the one driver asks for it: ``init_state(messages
    [4, K, H, W])``, ``sweep(state) -> (state, lb_part)``, ``check(state,
    lb_part) -> (energy, lb, labels)``, ``messages(state)``.  A subclass,
    whose sweep leaves the whole bound, gives ``sweep``, ``decode(state) ->
    (labels, energy)``, ``to_state`` and ``messages``."""

    def __init__(self, unary):
        self.K, self.H, self.W = unary.shape
        self.dtype, self.device = unary.dtype, unary.device

    def init_state(self, messages=None):
        if messages is None:
            messages = torch.zeros((NUM_DIRS, self.K, self.H, self.W),
                                   dtype=self.dtype, device=self.device)
        return self.to_state(messages.to(self.dtype))

    def check(self, state, lb):
        labels, energy = self.decode(state)
        return energy, lb, labels


def drive(pack, messages=None, *, maxiter: int, max_relgap: float,
          check_every: int) -> TRWSResult:
    """The reference's stopping rule over the problem ``pack()`` builds (a
    _Problem or a Packed): ``check_every`` sweeps and a decode a round until
    the gap closes or ``maxiter`` sweeps are spent.  The first round always
    runs; a budget that ``check_every`` does not divide is overshot to its
    next multiple; the test (one host sync) runs only while sweeps remain.
    Its flat trws.* spans are read by the benchmark's per-layer metrics."""
    with span("trws.pack"):
        prob = pack()
        state = prob.init_state(messages)
        zero = torch.zeros((), dtype=acc_dtype(prob.dtype),
                           device=prob.device)
        energy, lb = zero, zero
        labels = torch.zeros((prob.H, prob.W), dtype=torch.int32,
                             device=prob.device)
    it = 0
    while it < maxiter and (it == 0 or _gap_open(energy, lb, max_relgap)):
        for _ in range(check_every):
            with span("trws.sweep"):
                state, lb_sweep = prob.sweep(state)
        with span("trws.decode"):
            energy, lb, labels = prob.check(state, lb_sweep)
        it += check_every
    with span("trws.finish"):
        return TRWSResult(labels, energy, lb, it, prob.messages(state))


def solve(
    unary: torch.Tensor,  # [K, H, W]
    positions: torch.Tensor,  # D0 [K, H, W]: label k's plane at p, eval at p
    nbr_positions: torch.Tensor,  # Q [4, K, H, W]: neighbor's plane, eval at p
    alphas: torch.Tensor,  # [4, H, W] directed-edge weights (0 at borders)
    *,
    kernel: int,
    tol,
    maxiter: int = 1000,
    max_relgap: float = 1e-4,
    messages: torch.Tensor | None = None,  # warm start [4, K, H, W]
    mode: str = "trws",  # "trws" | "bp"
    use_kernel: bool = True,  # False = the plain PyTorch phase (see below)
    check_every: int = 1,  # decode + test the stopping rule every N sweeps
    message_dtype: torch.dtype | None = None,  # e.g. torch.bfloat16 storage
    compact: bool | None = None,  # checkerboard H-compaction (None = auto)
) -> TRWSResult:
    """Run checkerboard TRW-S (or plain loopy BP) to the reference's stopping
    rule (``drive``), on the device the tensors live on.

    mode="bp": gamma = 1, no lower bound (it stays 0, so the relgap rule
    degenerates to maxiter).  ``compact=None`` resolves to the compacted
    half-grid phases on a CUDA device and the full grid on the CPU.
    ``use_kernel=False`` holds the kernels against their plain versions (the
    counterpart of the JAX package's ``use_pallas``); leave it True
    otherwise.  ``message_dtype`` narrows the message storage (see the
    module's note); the result's messages are in it."""
    return drive(
        lambda: _Problem(unary, positions, nbr_positions, alphas, kernel, tol,
                         mode, compact, use_kernel,
                         message_dtype=message_dtype),
        messages, maxiter=maxiter, max_relgap=max_relgap,
        check_every=check_every)


class PreparedRun:
    """Fixed-budget driving of a problem packed once (a _Problem or a
    Packed): the ``run`` of TRWSRun and banded.BandedRun."""

    def __init__(self, packed):
        self._p = packed
        self.K, self.H, self.W = packed.K, packed.H, packed.W
        self.dtype = packed.dtype

    def init_state(self, messages=None):
        return self._p.init_state(messages)

    def messages(self, state):
        return self._p.messages(state)

    def run(self, state, sweeps: int, decode_every: int | None = None):
        """``sweeps`` passes, decoding every ``decode_every`` sweeps
        (default: once at the end) and keeping the best labeling seen: the
        greedy decode oscillates around convergence and any decode is
        feasible, so the incumbent is never worse than the last.
        -> (state, best_energy, lb, best_labels).  No host synchronisation
        inside; the sweeps may update the state in place."""
        if decode_every is None or decode_every >= sweeps:
            decode_every = sweeps
        p = self._p
        acc_t = acc_dtype(p.dtype)
        bestE = torch.full((), float("inf"), dtype=acc_t, device=p.device)
        bestL = torch.zeros((p.H, p.W), dtype=torch.int32, device=p.device)
        lb = torch.zeros((), dtype=acc_t, device=p.device)
        for _ in range(sweeps // decode_every):
            for _ in range(decode_every):
                state, lb_sweep = p.sweep(state)
            energy, lb, labels = p.check(state, lb_sweep)
            better = energy < bestE
            bestE = torch.where(better, energy, bestE)
            bestL = torch.where(better, labels, bestL)
        return state, bestE, lb, bestL


class TRWSRun(PreparedRun):
    """Prepared checkerboard solver: pack the problem once, sweep in chunks.

    Usage:
        r = TRWSRun(unary, D0, Q, alphas, kernel=1, tol=2.0)
        state = r.init_state()                     # or init_state(messages)
        state, energy, lb, labels = r.run(state, 100, decode_every=10)
        msgs = r.messages(state)                   # [4, K, H, W]
        res = r.solve()                            # the reference stopping
                                                   # rule, chunked driving

    The message trajectory of ``run`` is iteration-exact with ``solve`` for
    matching compact settings.
    """

    def __init__(self, unary, positions, nbr_positions, alphas, *, kernel,
                 tol, mode: str = "trws", use_kernel: bool = True,
                 compact: bool | None = None,
                 message_dtype: torch.dtype | None = None):
        super().__init__(_Problem(unary, positions, nbr_positions, alphas,
                                  kernel, tol, mode, compact, use_kernel,
                                  message_dtype=message_dtype))
        self.kernel, self.tol, self.mode = kernel, tol, mode
        self.compact = self._p.compact

    def solve(self, maxiter: int = 1000, max_relgap: float = 1e-4,
              check_every: int = 8, chunk: int = 300, messages=None):
        """Chunked driving to the reference stopping rule: decode/test every
        ``check_every`` sweeps, stop on relgap < max_relgap or maxiter.
        Returns a TRWSResult whose labels/energy are the best decode seen."""
        state = self.init_state(messages)
        best_e = float("inf")
        best_labels = None
        lb = 0.0
        total = 0
        while total < maxiter:
            n = min(chunk, maxiter - total)
            n = max(check_every, (n // check_every) * check_every)
            state, e, lb, labels = self.run(state, n, check_every)
            total += n
            ef = float(e)
            if ef < best_e:
                best_e, best_labels = ef, labels
            if ef != 0 and (ef - float(lb)) / ef < max_relgap:
                break
        kw = dict(dtype=acc_dtype(self.dtype), device=self._p.device)
        return TRWSResult(best_labels, torch.as_tensor(best_e, **kw),
                          torch.as_tensor(lb, **kw), total,
                          self.messages(state))
