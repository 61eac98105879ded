"""Model base: plane-label state + fusion entry points (port of
stereo_tpu/models/base.py).

Owns the plane-label field [4, H, W], the per-direction smoothness weight
maps [4, H, W], the cached energy, and the fusion entry points (binary_fusion,
binary_fusion_sweep, binary_fuse_until_convergence, simultaneous_fusion).

All state lives on one device, chosen at construction (``device="cuda"`` by
default; the CPU only on request).  The class sequences plain functions on
tensors; loops over moves and sweeps are Python loops.

Simultaneous fusion runs the checkerboard schedule (solvers/trws.py), the
banded one (solvers/banded.py, blocks of ``band`` x ``band`` pixels), the
raster wavefront (solvers/wavefront.py) or the scanline order
(solvers/scanline.py).  Binary fusion runs on the device (the K = 2 TRW-S of
solvers/binary.py, the default) or, with ``fusion_backend="host"``, through
exact QPBO on the host (solvers/qpbo_host.py, the port's copy of the native
solver): the caller chooses; nothing falls back from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from stereo_tpu_torch import energy, geometry
from stereo_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from stereo_tpu_torch.solvers import (banded, binary, qpbo_host, scanline,
                                      trws, wavefront)
from stereo_tpu_torch.utils.profiling import span

_SCHEDULES = ("checkerboard", "scanline", "wavefront", "banded")


def _check_schedule(schedule: str):
    if schedule not in _SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}")


class DispMap:
    """Abstract base; subclasses provide ``unary_map`` and ``tol``."""

    # optional (d_min, d_step) disparity normalization applied inside all
    # pairwise terms
    normalize: tuple | None = None

    def __init__(self, images, kernel: int, *, maxiter: int = 1000,
                 max_relgap: float = 1e-4, improve: bool = False,
                 check_every: int = 8, schedule: str = "checkerboard",
                 fusion_backend: str = "device", dtype=None,
                 device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        if dtype is None:
            dtype = torch.as_tensor(np.asarray(images[0])).dtype
        self.dtype = dtype
        self.images = [torch.as_tensor(np.asarray(im), dtype=dtype,
                                       device=self.device) for im in images]
        H, W = self.images[0].shape[:2]
        self.sz = (H, W)
        if kernel not in (1, 2):
            raise ValueError("Unknown kernel type")
        self.smoothness_kernel = kernel
        self.maxiter = maxiter
        self.max_relgap = max_relgap
        self.improve = improve
        # stopping-rule stride: decode/convergence-test every N TRW-S sweeps
        self.check_every = check_every
        _check_schedule(schedule)
        self.schedule = schedule
        # block side of the banded schedule (clamped to the image)
        self.band = 128
        # binary-fusion solver: 'device' (K = 2 TRW-S + per-component
        # acceptance) or 'host' (exact QPBO roof duality through the native
        # library, honouring ``improve``)
        if fusion_backend not in ("device", "host"):
            raise ValueError(f"unknown fusion backend {fusion_backend!r}")
        self.fusion_backend = fusion_backend
        self._edge_cache = None
        self.smooth_weights = energy.default_weights(
            H, W, dtype=self.dtype, device=self.device)
        self._assignment = None
        self._stored_energy = float("inf")
        # False runs the plain PyTorch TRW-S phases / sweeps instead of the
        # CUDA kernels: a comparison aid for the smoke run and the tests only
        self.use_kernel = True

    # ------------------------------------------------------------- state
    def _tensor(self, planes) -> torch.Tensor:
        if not isinstance(planes, torch.Tensor):
            planes = torch.as_tensor(np.asarray(planes))
        return planes.to(device=self.device, dtype=self.dtype)

    @property
    def assignment(self) -> torch.Tensor:
        return self._assignment

    @assignment.setter
    def assignment(self, planes):
        self._assignment = self._tensor(planes)
        self._update_energy()

    def energy(self) -> float:
        return self._stored_energy

    def _update_energy(self):
        e = energy.total_energy(
            self.unary_map(self._assignment), self._assignment,
            self.smooth_weights, self.smoothness_kernel, self.tol,
            self.normalize)
        self._stored_energy = float(e)

    # ---------------------------------------------------------- abstract
    def unary_map(self, planes: torch.Tensor) -> torch.Tensor:
        """Per-pixel unary cost of a plane field. [4,H,W] -> [H,W]."""
        raise NotImplementedError

    def unary_partial(self):
        """The unary as a callable of a plane field (for fused sweeps)."""
        return self.unary_map

    # ------------------------------------------------------------ fusion
    def binary_fusion(self, proposal) -> tuple[float, float]:
        """One fusion move. Never increases energy.
        Returns (energy, lower_bound)."""
        proposal = self._tensor(proposal)
        if proposal.shape != self._assignment.shape:
            raise ValueError("Binary fusion: proposal is of wrong size")
        if self.fusion_backend == "host":
            return self._binary_fusion_host(proposal)
        with span("fusion.proposal"):
            D0, Q = binary.fusion_problem(self._assignment, proposal,
                                          self.normalize)
            U0 = self.unary_map(self._assignment)
            U1 = self.unary_map(proposal)
        res = binary.binary_fuse(
            U0, U1, D0, Q, self.smooth_weights, kernel=self.smoothness_kernel,
            tol=self.tol, improve=4 if self.improve else 0)
        with span("fusion.merge"):
            fused = energy.fuse_labelling(self._assignment, proposal,
                                          res.take)
        with span("fusion.finish"):
            e, lb = float(res.energy), float(res.lower_bound)
        self._assignment = fused
        self._stored_energy = e
        return self._stored_energy, lb

    def _edge_lists(self):
        """Directed edge lists (tails, heads, per-direction weights and
        selections) of the host QPBO path, built once per weight tensor."""
        w_t = self.smooth_weights
        if self._edge_cache is None or self._edge_cache[0] is not w_t:
            H, W = self.sz
            w = w_t.detach().to("cpu", torch.float64).numpy()
            nid = np.arange(H * W).reshape(H, W)
            tails, heads, wts, sel = [], [], [], []
            for d, (dy, dx) in enumerate(geometry.DIRS):
                ys, xs = np.nonzero(w[d] > 0)
                tails.append(nid[ys + dy, xs + dx])
                heads.append(nid[ys, xs])
                wts.append(w[d, ys, xs])
                sel.append((d, ys, xs))
            self._edge_cache = (w_t, (
                np.concatenate(tails).astype(np.int32),
                np.concatenate(heads).astype(np.int32), wts, sel))
        return self._edge_cache[1]

    def _binary_fusion_host(self, proposal) -> tuple[float, float]:
        """Exact QPBO fusion on the host (the rd.m / rd_mex path): weak
        persistency + keep-current on unlabelled nodes, QPBO-I when
        unlabelled nodes remain and ``improve`` is set.  The state stays on
        the model's device; the QPBO inputs go to the host as float64 numpy
        and the take mask comes back."""
        H, W = self.sz
        cur = self._assignment
        tables = energy.binary_fusion_pairwise_tables(
            cur, proposal, self.smoothness_kernel, self.tol,
            self.normalize).detach().to("cpu", torch.float64).numpy()
        tails, heads, wts, sel = self._edge_lists()
        E = [np.concatenate([wts[i] * tables[d, t, ys, xs]
                             for i, (d, ys, xs) in enumerate(sel)])
             for t in range(4)]
        U0, U1 = (self.unary_map(p).detach().to("cpu", torch.float64)
                  .numpy().ravel() for p in (cur, proposal))
        labels, _, lb, n_unlab = qpbo_host.solve(U0, U1, tails, heads, *E)
        y = np.where(labels >= 0, labels, 0)
        if n_unlab > 0 and self.improve:
            y, _ = qpbo_host.improve(labels, U0, U1, tails, heads, *E)
        take = torch.as_tensor((y == 1).reshape(H, W), device=self.device)
        self._assignment = energy.fuse_labelling(cur, proposal, take)
        self._update_energy()
        return self._stored_energy, float(lb)

    def binary_fusion_sweep(self, proposals, chunk: int = 64) -> list[float]:
        """Fuse a whole proposal stream, ``chunk`` moves at a time.

        Identical math to calling binary_fusion per proposal, with the
        incumbent's unary and positions carried incrementally
        (see _fusion_sweep).  Returns the per-move energy trace."""
        unary_p = self.unary_partial()
        energies = []
        for c0 in range(0, len(proposals), chunk):
            with span("fusion.pack"):
                stack = torch.stack(
                    [self._tensor(p) for p in proposals[c0:c0 + chunk]], 0)
            fused, es, _ = _fusion_sweep(
                self._assignment, stack, self.smooth_weights,
                self.smoothness_kernel, self.tol, self.normalize,
                unary_p, improve=4 if self.improve else 0)
            self._assignment = fused
            with span("fusion.finish"):
                energies.extend(float(e) for e in es.cpu().numpy())
        self._stored_energy = energies[-1] if energies else self.energy()
        return energies

    def binary_fuse_until_convergence(self, proposals, seed: int = 0,
                                      verbose: bool = False,
                                      chunk: int = 32) -> int:
        """Randomized sweep until no proposal improves the energy.
        Deterministic given ``seed`` (numpy's default_rng, the same stream as
        the JAX package draws).

        Moves run ``chunk`` at a time through _fusion_sweep.  The visited-set
        bookkeeping is applied post-hoc from the chunk's energy trace, so
        skip decisions use chunk-start knowledge: the result is
        *heuristically* equivalent to a per-move loop — energy-monotone,
        same stopping criterion — but the exact move sequence can differ.
        Chunk padding uses live-masked identity steps, so padded entries
        never touch the assignment."""
        n = len(proposals)
        rng = np.random.default_rng(seed)
        ids = np.concatenate([np.arange(n),
                              rng.integers(0, n, self.maxiter * 5)])
        keep = np.ones(len(ids), dtype=bool)
        keep[1:] = np.diff(ids) != 0  # drop immediate repeats
        ids = ids[keep]

        visited = np.zeros(n, dtype=bool)
        energies = [self.energy()]

        if self.fusion_backend == "host":
            # the exact QPBO path (honours ``improve``): one host solve a move
            for it in range(min(self.maxiter, len(ids))):
                pid = int(ids[it])
                if visited[pid]:
                    continue
                self.binary_fusion(proposals[pid])
                energies.append(self.energy())
                if energies[-1] != energies[-2]:
                    visited[:] = False
                else:
                    visited[pid] = True
                if verbose:
                    print(f"fuse #{it} proposal {pid}: E = {energies[-1]:.6g}")
                if visited.all():
                    break
            return len(energies)

        unary_p = self.unary_partial()
        with span("fusion.pack"):
            stack_all = torch.stack([self._tensor(p) for p in proposals], 0)
        chunk = min(chunk, max(8, n))
        pos = 0
        moves = 0
        while (moves < self.maxiter and pos < len(ids)
               and not visited.all()):
            batch = []
            while pos < len(ids) and len(batch) < min(chunk,
                                                      self.maxiter - moves):
                pid = int(ids[pos])
                pos += 1
                if not visited[pid]:
                    batch.append(pid)
            if not batch:
                continue
            moves += len(batch)
            n_live = len(batch)
            # pad to the chunk shape; padded entries are live=False identity
            # steps inside _fusion_sweep (take forced empty)
            batch += [batch[-1]] * (chunk - n_live)
            with span("fusion.pack"):
                sub = stack_all[torch.as_tensor(batch, device=self.device)]
                live = torch.arange(chunk, device=self.device) < n_live
            fused, es, _ = _fusion_sweep(
                self._assignment, sub, self.smooth_weights,
                self.smoothness_kernel, self.tol, self.normalize,
                unary_p, live=live, improve=4 if self.improve else 0)
            self._assignment = fused
            with span("fusion.finish"):
                es = es.double().cpu().numpy()
            for i in range(n_live):
                pid = batch[i]
                energies.append(float(es[i]))
                if energies[-1] != energies[-2]:
                    visited[:] = False
                else:
                    visited[pid] = True
                if verbose:
                    print(f"fuse proposal {pid}: E = {energies[-1]:.6g}")
        self._stored_energy = energies[-1]
        return len(energies)

    # TRW-S runs in chunks of this many sweeps (per schedule); messages
    # warm-start across chunks, so the trajectory is identical to one long run
    solver_chunk: int = 300
    solver_chunk_scanline: int = 50
    solver_chunk_wavefront: int = 150
    solver_chunk_banded: int = 400

    def simultaneous_fusion(self, proposals, verbose: bool = False,
                            trace=None) -> tuple[float, float, int]:
        """Fuse all proposals at once with TRW-S.  The incumbent assignment
        joins as the last label.  Returns (energy, lower_bound, iterations).
        """
        _check_schedule(self.schedule)
        with span("trws.pack"):
            all_props = [self._tensor(p) for p in proposals]
            all_props.append(self._assignment)
            stack = torch.stack(all_props, dim=0)  # [K, 4, H, W]
            unary = torch.stack([self.unary_map(p) for p in all_props], dim=0)

        messages = None
        total_iters = 0
        lb = None
        # TRW-S greedy decodes oscillate around convergence; keep the best
        # labeling seen across chunk boundaries — any decode is a feasible
        # labeling, so applying the incumbent is no worse than keeping the
        # last
        best_e = float("inf")
        best_labels = None
        chunk_size = {
            "scanline": self.solver_chunk_scanline,
            "wavefront": self.solver_chunk_wavefront,
            "banded": self.solver_chunk_banded,
        }.get(self.schedule, self.solver_chunk)
        while total_iters < self.maxiter:
            chunk = min(chunk_size, self.maxiter - total_iters)
            labels, e, lb, iters, messages = _simultaneous_fusion_step(
                stack, unary, self.smooth_weights, self.smoothness_kernel,
                self.tol, self.normalize, chunk, self.max_relgap,
                self.check_every, messages, self.use_kernel,
                self.schedule, self.band)
            with span("trws.finish"):
                ef, lbf = float(e), float(lb)
            total_iters += int(iters)
            if ef < best_e:
                best_e = ef
                best_labels = labels
            if trace is not None:
                trace.record(ef, lbf, iterations=total_iters)
            if verbose:
                print(f"  TRW-S iter {total_iters}: E = {ef:.6g}, "
                      f"lb = {lbf:.6g}, relgap = {(ef-lbf)/ef:.3g}")
            if ef != 0 and (ef - lbf) / ef < self.max_relgap:
                break
            if int(iters) < chunk:  # converged inside the chunk
                break

        if best_labels is None:
            raise FloatingPointError(
                "simultaneous fusion: no decode had a finite energy")
        with span("trws.finish"):
            idx = best_labels[None, None, :, :].long().expand(1, 4, *self.sz)
            self._assignment = torch.gather(stack, 0, idx)[0]
        self._stored_energy = best_e
        return self._stored_energy, float(lb), total_iters

    # ------------------------------------------------------------- views
    def current_dispmap(self) -> torch.Tensor:
        d = geometry.own_disparity(self._assignment)
        if self.normalize is not None:
            d = (d - self.normalize[0]) / self.normalize[1]
        return d

    def __repr__(self):
        H, W = self.sz
        return (
            f"{type(self).__name__}(size=({H},{W}), "
            f"kernel={self.smoothness_kernel}, "
            f"energy={self._stored_energy:.6g}, maxiter={self.maxiter}, "
            f"max_relgap={self.max_relgap}, device={self.device})")


# --------------------------------------------------------------- core steps


def _positions(planes, normalize, x0: int = 0):
    """Pairwise positions of a plane field [..., 4, H, W]: each pixel's own
    disparity D0 [..., H, W] and its four neighbours' planes evaluated at the
    pixel, Q [4, ..., H, W] (0 at the borders).  ``x0``: the global column
    of column 0 (geometry.grid_points)."""
    D0 = energy.normalized(geometry.own_disparity(planes, x0), normalize)
    Q = torch.stack(
        [energy.normalized(
            geometry.neighbor_plane_disparity(planes, d, fill=0.0, x0=x0),
            normalize)
         for d in range(geometry.NUM_DIRS)], dim=0)
    return D0, Q


def _fusion_sweep(current, prop_stack, weights, kernel, tol, normalize,
                  unary_p, live=None, improve=0):
    """Fusion moves over a [P, 4, H, W] proposal stack, in order.

    The incumbent's unary and pairwise positions are carried incrementally:
    after a move they are pointwise merges of the two candidates' values
    (the unary depends only on the pixel's own plane, and the positions only
    on one endpoint's plane), so each move evaluates the unary/geometry of
    the *proposal* only.

    ``live`` ([P] bool, default all-True) marks real moves; entries with
    live=False are guaranteed identities — the take-mask is forced empty so
    the carry passes through unchanged.
    Returns (fused, energies [P], lower_bounds [P])."""

    P = prop_stack.shape[0]
    with span("fusion.pack"):
        if live is None:
            live = torch.ones((P,), dtype=torch.bool, device=current.device)
        cur = current
        U0 = unary_p(cur)
        D0c, Qc = _positions(cur, normalize)
    es, lbs = [], []
    for i in range(P):
        with span("fusion.proposal"):
            prop = prop_stack[i]
            U1 = unary_p(prop)
            D0p, Qp = _positions(prop, normalize)
            D0 = torch.stack([D0c, D0p], dim=0)  # [2, H, W]
            Q = torch.stack([Qc, Qp], dim=1)  # [4, 2, H, W]
        res = binary.binary_fuse(U0, U1, D0, Q, weights, kernel=kernel,
                                 tol=tol, improve=improve)
        with span("fusion.merge"):
            take = res.take & live[i]
            cur = energy.fuse_labelling(cur, prop, take)
            U0 = torch.where(take, U1, U0)
            D0c = torch.where(take, D0p, D0c)
            Qc = torch.stack(
                [torch.where(
                    geometry.shift_from_neighbor(take, d, fill=False),
                    Qp[d], Qc[d])
                 for d in range(geometry.NUM_DIRS)], dim=0)
            es.append(res.energy)
            lbs.append(res.lower_bound)
    with span("fusion.finish"):
        return cur, torch.stack(es), torch.stack(lbs)


def _simultaneous_fusion_step(prop_stack, unary, weights, kernel, tol,
                              normalize, maxiter, max_relgap, check_every=1,
                              messages=None, use_kernel=True,
                              schedule="checkerboard", band=128):
    """One chunk of TRW-S on the K-label fusion problem, under the
    checkerboard, the banded, the raster-wavefront or the scanline
    schedule."""
    with span("trws.pack"):
        D0, Q = _positions(prop_stack, normalize)  # [K, H, W], [4, K, H, W]
    extra = {}
    if schedule == "banded":
        _solve = banded.solve_banded
        H, W = unary.shape[-2:]
        extra = dict(Bh=max(2, min(band, H)), Bw=max(2, min(band, W)))
    elif schedule == "wavefront":
        _solve = wavefront.solve_wavefront
    elif schedule == "scanline":
        _solve = scanline.solve_scanline
    else:
        _solve = trws.solve
    res = _solve(
        unary, D0, Q, weights, kernel=kernel, tol=tol, maxiter=maxiter,
        max_relgap=max_relgap, check_every=check_every, messages=messages,
        use_kernel=use_kernel, **extra)
    return (res.labels, res.energy, res.lower_bound, res.iterations,
            res.messages)
