"""Device-mesh distribution of the checkerboard solver (port of
stereo_tpu/parallel/mesh.py).

The scaling axes are those of the JAX package: stereo pairs over a 'batch'
axis (data parallel) and the image columns of one pair over an 'x' axis
(spatial partitioning).  JAX runs one single-controller program over a mesh
and lets XLA insert the halo exchanges; here the mesh is a grid of
``torch.device`` s in one process and the exchange is explicit:

- a mesh is a ``[batch, x]`` grid of devices; a device may repeat, so
  ``["cpu"] * 8`` serves the tests and ``["cuda:0"] * n`` gives n column
  shards on one card (a host with more cards passes ``cuda:0 .. cuda:7``);
- column shard i owns the columns [i w, (i + 1) w) (w = W / n) and holds up
  to ``HALO`` columns of each neighbour besides, copied from the owner after
  every phase (``Columns.exchange``);
- every per-pixel computation runs on the shard's whole span with the
  colours, gammas and validity masks of the global columns, so the owned
  pixels get the same arithmetic in the same order as on one device: labels
  and messages are bit for bit those of ``solvers.trws.solve``.  Only the
  global scalars (energy, lower bound) are sums of per-shard partials, equal
  to reassociation;
- a shard's phase is the port's own phase glue, so on the card it launches
  kernel 1 (``compact=True``, the default there) or kernel 2 on the shard: a
  shard is an ordinary tensor, where JAX's ``pallas_call`` has no SPMD rule
  and its sharded solve runs the plain phases.

Halo depth: a phase reads its neighbours' beliefs, which read their
neighbours' messages (two columns); the decode and the energy of its labels
reach three.  After each phase's exchange every column of a span is right,
so ``HALO = 3`` covers both.
"""

from __future__ import annotations

from typing import Sequence

import torch

from stereo_tpu_torch.solvers import trws

HALO = 3


class Mesh:
    """A ``[batch, x]`` (or ``[batch, y]``) grid of devices in one process."""

    def __init__(self, devices: Sequence[Sequence], axis_names=("batch", "x")):
        rows = [tuple(torch.device(d) for d in row) for row in devices]
        if not rows or len({len(r) for r in rows}) != 1 or not rows[0]:
            raise ValueError("a mesh needs equal, non-empty rows of devices")
        self.devices = tuple(rows)
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names,
                        (len(self.devices), len(self.devices[0]))))

    def line(self, b: int = 0) -> "Line":
        """The shards of row ``b``."""
        return Line(self.devices[b])

    def __repr__(self):
        return f"Mesh({self.shape}, {[list(map(str, r)) for r in self.devices]})"


def visible_devices() -> list:
    """The visible CUDA devices; raises when there are none (the CPU is used
    only when the caller passes CPU devices)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible (torch.cuda.is_available() is "
            "False); pass devices=['cpu', ...] explicitly to build a mesh on "
            "the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None, batch: int = 1,
              devices=None) -> Mesh:
    """Build a ('batch', 'x') mesh from the first n_devices devices (default:
    the visible CUDA devices)."""
    devices = list(devices if devices is not None else visible_devices())
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if n % batch != 0:
        raise ValueError(f"{n} devices not divisible by batch={batch}")
    w = n // batch
    return Mesh([devices[b * w:(b + 1) * w] for b in range(batch)],
                ("batch", "x"))


class Line:
    """n shards along one axis, all in this process: shard i lives on
    ``devices[i]``.  The communication a sharded solver needs, written for
    shards in one process (parallel/multihost.py has the same methods over
    torch.distributed, one shard a process)."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        self.n = len(self.devices)
        self.index = list(range(self.n))  # global index of each local shard

    @property
    def device(self) -> torch.device:
        """Where gathered fields and global scalars are put."""
        return self.devices[0]

    def shift(self, vals, step: int):
        """Per local shard i, the value that shard i - step passed in
        ``vals`` (moved to shard i's device), or None where there is none."""
        out = []
        for i in self.index:
            j = i - step
            out.append(vals[j].to(self.devices[i]) if 0 <= j < self.n
                       else None)
        return out

    def total(self, vals):
        """Sum of the shards' partials, in shard order, on ``device``."""
        s = vals[0].to(self.device)
        for v in vals[1:]:
            s = s + v.to(self.device)
        return s

    def any(self, flags) -> bool:
        return any(bool(f) for f in flags)

    def gather(self, parts, dim: int):
        """The shards' parts concatenated along ``dim``, on ``device``."""
        return torch.cat([p.to(self.device) for p in parts], dim=dim)


class Columns:
    """Column shards of a W-wide image over a line (the counterpart of the
    JAX package's ``field_specs``): shard i owns columns [x0, x1) = [i w,
    (i + 1) w) and holds the span [a, b), its own columns and up to ``HALO``
    of each neighbour's.  ``split`` and ``gather`` move fields between the
    global layout and the shards; ``exchange`` refreshes the halo columns.
    Every field handled here has the columns last."""

    def __init__(self, line, W: int):
        n = line.n
        if W % n != 0:
            raise ValueError(
                f"image width {W} not divisible by the mesh 'x' axis ({n}); "
                f"pick an 'x' size dividing W (zero-padding would break the "
                f"sharded == single-device bitwise invariant)")
        w = W // n
        if n > 1 and w < HALO:
            raise ValueError(f"shards of {w} columns are narrower than the "
                             f"halo ({HALO}); use at most {W // HALO} shards")
        self.line, self.W, self.w = line, W, w
        self.halo = HALO if n > 1 else 0
        self.bounds = {i: (max(0, i * w - HALO), i * w, (i + 1) * w,
                           min(W, (i + 1) * w + HALO)) for i in range(n)}

    def cols(self, i: int):
        """(a, x0, x1, W) of shard i: the ``cols=`` of trws._Problem."""
        a, x0, x1, _ = self.bounds[i]
        return a, x0, x1, self.W

    def split(self, field):
        """A global field [..., W] -> the local shards' spans."""
        out = []
        for i, dev in zip(self.line.index, self.line.devices):
            a, _, _, b = self.bounds[i]
            out.append(field[..., a:b].to(dev).contiguous())
        return out

    def owned(self, part, i: int):
        a, x0, x1, _ = self.bounds[i]
        return part[..., x0 - a:x1 - a]

    def gather(self, parts):
        """The local spans' owned columns -> the global field [..., W]."""
        return self.line.gather(
            [self.owned(p, i) for p, i in zip(parts, self.line.index)], -1)

    def exchange(self, parts):
        """Overwrite every span's halo columns, in place, with the owned
        columns of the neighbours they belong to."""
        h = self.halo
        if not h:
            return
        own = [self.owned(p, i) for p, i in zip(parts, self.line.index)]
        from_left = self.line.shift([o[..., -h:] for o in own], 1)
        from_right = self.line.shift([o[..., :h] for o in own], -1)
        for p, lt, rt in zip(parts, from_left, from_right):
            if lt is not None:
                p[..., :h].copy_(lt)
            if rt is not None:
                p[..., -h:].copy_(rt)


class _ColumnTRWS:
    """One pair's checkerboard TRW-S over the column shards of a line: the
    port's phase glue (trws._Problem) on every shard's span, the halo
    exchange after every phase."""

    def __init__(self, line, unary, positions, nbr_positions, alphas,
                 messages, *, kernel, tol, compact):
        K, H, W = unary.shape[-3:]
        self.cols = cols = Columns(line, W)
        self.line, self.K, self.H, self.W = line, K, H, W
        parts = [cols.split(a) for a in (unary, positions, nbr_positions,
                                         alphas)]
        self.probs = [
            trws._Problem(u, d0, q, al, kernel, tol, "trws", compact,
                          True, cols=cols.cols(i))
            for u, d0, q, al, i in zip(*parts, line.index)]
        msgs = (cols.split(messages) if messages is not None
                else [None] * len(self.probs))
        self.state = [p.init_state(m) for p, m in zip(self.probs, msgs)]
        self.compact = self.probs[0].compact

    def exchange(self):
        if self.compact:
            # the halo of global colour g, in each shard's own local colour
            for g in (0, 1):
                self.cols.exchange([M[(g + p.c0) % 2]
                                    for p, M in zip(self.probs, self.state)])
        else:
            self.cols.exchange(self.state)

    def sweep(self):
        """One forward + backward pass on every shard -> the shards' lb
        partials of the backward phase."""
        for color in (0, 1):
            out = [p.half(M, color) for p, M in zip(self.probs, self.state)]
            self.state = [o[0] for o in out]
            self.exchange()
        return [o[1] for o in out]

    def check(self, lb_parts):
        """Global (energy, lower bound) and the gathered labels."""
        out = [p.check(M, lb)
               for p, M, lb in zip(self.probs, self.state, lb_parts)]
        return (self.line.total([o[0] for o in out]),
                self.line.total([o[1] for o in out]),
                self.cols.gather([o[2] for o in out]))

    def messages(self):
        return self.cols.gather([p.messages(M)
                                 for p, M in zip(self.probs, self.state)])


def drive(runs, maxiter: int, max_relgap: float, check_every: int):
    """trws.solve's loop over several runs in lockstep: every live run
    sweeps ``check_every`` times, then each is decoded and tested against the
    stopping rule on its own.  Lockstep lets runs on different devices
    overlap: the host waits only at the tests.  -> per run (energy, lb,
    labels, iterations)."""
    out = [None] * len(runs)
    iters = [0] * len(runs)
    live = list(range(len(runs)))
    while live:
        lbs = {}
        for r in live:
            for _ in range(check_every):
                lbs[r] = runs[r].sweep()
        for r in live:
            out[r] = runs[r].check(lbs[r])
            iters[r] += check_every
        live = [r for r in live if iters[r] < maxiter
                and trws._gap_open(out[r][0], out[r][1], max_relgap)]
    return [(*o, it) for o, it in zip(out, iters)]


def _pair_rows(B: int, mesh: Mesh) -> list:
    """The mesh row of each of B pairs: contiguous blocks of B / rows pairs
    a row (the JAX package's 'batch' sharding), or pair b on row b when
    there are fewer pairs than rows."""
    nb = mesh.shape["batch"]
    if B <= nb:
        return list(range(B))
    if B % nb:
        raise ValueError(f"{B} pairs not divisible by the mesh 'batch' axis "
                         f"({nb})")
    return [b * nb // B for b in range(B)]


def sharded_solve(
    mesh: Mesh,
    unary: torch.Tensor,  # [K, H, W] or [B, K, H, W]
    positions: torch.Tensor,
    nbr_positions: torch.Tensor,
    alphas: torch.Tensor,
    *,
    kernel: int,
    tol,
    maxiter: int = 1000,
    max_relgap: float = 1e-4,
    messages: torch.Tensor | None = None,
    check_every: int = 1,
    compact: bool | None = None,
):
    """TRW-S solve with the columns sharded over the mesh's 'x' axis.

    Batched inputs (a leading stereo-pair axis) put the pairs on the mesh's
    'batch' rows, each pair's columns over its row, and run the pairs in
    lockstep, each to its own stopping rule.  ``messages`` warm-starts the
    dual state (e.g. carried across pooled chunks); ``check_every``
    amortizes the decode.  ``compact`` (None: compact on the card, the full
    grid on the CPU, as trws.solve) picks kernel 1 or kernel 2 for the
    shards' phases.  Labels
    and messages equal trws.solve's bit for bit for matching compact
    settings; energy and bound agree to reassociation, so a test that needs
    equal iteration counts sets max_relgap=0.0.

    Returns a TRWSResult gathered on the first device of the mesh: labels
    [(B,) H, W], energy and lower_bound scalars (or [B]), iterations an int
    (or a [B] tensor) and messages [(B,) 4, K, H, W]."""
    if mesh.axis_names[-1] != "x":
        raise ValueError(f"sharded_solve needs a ('batch', 'x') mesh, got "
                         f"{mesh.axis_names}")
    batched = unary.ndim == 4
    pairs = ([(unary, positions, nbr_positions, alphas, messages)]
             if not batched else
             [(unary[b], positions[b], nbr_positions[b], alphas[b],
               None if messages is None else messages[b])
              for b in range(unary.shape[0])])
    rows = _pair_rows(len(pairs), mesh)
    kw = dict(kernel=kernel, tol=tol, compact=compact)
    runs = [_ColumnTRWS(mesh.line(r), *p, **kw) for p, r in zip(pairs, rows)]
    out = drive(runs, maxiter, max_relgap, check_every)
    msgs = [run.messages() for run in runs]
    if not batched:
        (e, lb, labels, it), = out
        return trws.TRWSResult(labels, e, lb, it, msgs[0])
    dev = mesh.devices[0][0]
    stack = lambda xs: torch.stack([x.to(dev) for x in xs])  # noqa: E731
    return trws.TRWSResult(
        stack([o[2] for o in out]), stack([o[0] for o in out]),
        stack([o[1] for o in out]),
        torch.tensor([o[3] for o in out]), stack(msgs))
