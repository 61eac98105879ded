"""Multi-process distribution over torch.distributed (port of
stereo_tpu/parallel/multihost.py).

The JAX package spans one single-controller mesh over the devices of all
processes (jax.distributed).  Here every process is one shard — one column
shard of the checkerboard solve or one gy-stripe of the banded solve — and
the solvers of parallel/mesh.py and solvers/banded_dist.py run unchanged over
a ``ProcessLine``: the same ``shift`` / ``total`` / ``gather`` a ``Line`` of
shards in one process offers, done with send / recv, all_reduce and
all_gather of the default process group.  Every process holds the full input
(cheap for problem inputs) and takes its own span of it.

Transport: NCCL where each process has its own card; gloo otherwise — on
the CPU, or two processes on one card (NCCL refuses two ranks on one GPU),
where the halos travel through host memory while the compute stays on the
card.  ``ProcessLine.transport`` names the one in use.

The worker below (``python -m stereo_tpu_torch.parallel.multihost``) runs a
problem from an .npz file in every process and writes process 0's result:
the two-process check of the tests and of chip_smoke.py.
"""

from __future__ import annotations

import argparse
import datetime
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from stereo_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from stereo_tpu_torch.parallel import mesh as mesh_mod


def initialize(coordinator: str, num_processes: int, process_id: int,
               backend: str | None = None, timeout: float = 120.0) -> str:
    """torch.distributed init of the default process group at
    ``coordinator`` ("host:port").  ``backend`` None takes NCCL when every
    process can have a card of its own, else gloo.  Returns the backend."""
    if backend is None:
        backend = ("nccl" if torch.cuda.is_available()
                   and torch.cuda.device_count() >= num_processes else "gloo")
    if backend == "nccl":  # NCCL's sends and receives use the current card
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout))
    return backend


def _local_device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda",
                           dist.get_rank() % torch.cuda.device_count())
    return dev


class ProcessLine:
    """The processes of the default group as one line of shards: shard i is
    process i, on ``device``.  Same methods as parallel.mesh.Line."""

    def __init__(self, device=DEFAULT_DEVICE):
        self.devices = [_local_device(device)]
        self.n = dist.get_world_size()
        self.index = [dist.get_rank()]
        self.host = dist.get_backend() != "nccl"
        self.transport = ("nccl" if not self.host else
                          "gloo via host memory"
                          if self.devices[0].type == "cuda" else "gloo")

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def _wire(self, t):
        return (t.cpu() if self.host else t).contiguous()

    def shift(self, vals, step: int):
        rank, v = self.index[0], self._wire(vals[0])
        ops, buf = [], None
        if 0 <= rank + step < self.n:
            ops.append(dist.P2POp(dist.isend, v, rank + step))
        if 0 <= rank - step < self.n:
            buf = torch.empty_like(v)
            ops.append(dist.P2POp(dist.irecv, buf, rank - step))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return [None if buf is None else buf.to(self.device)]

    def total(self, vals):
        t = self._wire(vals[0]).clone()
        dist.all_reduce(t)
        return t.to(self.device)

    def any(self, flags) -> bool:
        t = torch.tensor(int(bool(flags[0])),
                         device="cpu" if self.host else self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t)

    def gather(self, parts, dim: int):
        p = self._wire(parts[0])
        bufs = [torch.empty_like(p) for _ in range(self.n)]
        dist.all_gather(bufs, p)
        return torch.cat(bufs, dim=dim).to(self.device)


class ProcessMesh(mesh_mod.Mesh):
    """A (1, n) mesh whose one row is the processes of the default group."""

    def __init__(self, device=DEFAULT_DEVICE):
        self._line = ProcessLine(device)
        super().__init__([self._line.devices], ("batch", "x"))

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, (1, self._line.n)))

    def line(self, b: int = 0) -> ProcessLine:
        return self._line


def global_mesh(batch: int = 1, device=DEFAULT_DEVICE) -> ProcessMesh:
    """('batch', 'x') mesh over ALL processes, one shard each (batch = 1:
    a pair's shards span the processes)."""
    if batch != 1:
        raise ValueError("a process mesh has one row (batch=1)")
    return ProcessMesh(device)


def make_global(mesh: ProcessMesh, axis: str, host_value) -> torch.Tensor:
    """This process's block of a host-replicated numpy value along its
    columns (``axis`` "x") or rows ("y"), on the process's device."""
    line = mesh.line()
    dim = {"x": -1, "y": -2}[axis]
    size = np.shape(host_value)[dim] // line.n
    lo = line.index[0] * size
    block = torch.as_tensor(np.asarray(host_value)).narrow(dim, lo, size)
    return block.to(line.device)


def sharded_solve_global(mesh: ProcessMesh, unary, positions, nbr_positions,
                         alphas, *, kernel, tol, maxiter=100,
                         max_relgap=1e-4, **kw):
    """trws.solve with the columns over the processes of ``mesh``.

    Inputs are host numpy arrays (or CPU tensors) replicated on every
    process; each process moves only its span to its device.  Returns the
    TRWSResult with labels and messages gathered on every process."""
    args = [torch.as_tensor(np.asarray(a))
            for a in (unary, positions, nbr_positions, alphas)]
    return mesh_mod.sharded_solve(mesh, *args, kernel=kernel, tol=tol,
                                  maxiter=maxiter, max_relgap=max_relgap, **kw)


def sharded_banded_global(unary, positions, nbr_positions, alphas, *, kernel,
                          tol, Bh, Bw, sweeps, decode_every=None,
                          device=DEFAULT_DEVICE, **kw):
    """banded_dist.sharded_banded_run over ALL processes, one gy-stripe
    each.  Inputs are host numpy arrays replicated on every process.  ->
    (labels [H, W] on every process, energy, lower bound)."""
    from stereo_tpu_torch.solvers import banded_dist

    args = [torch.as_tensor(np.asarray(a))
            for a in (unary, positions, nbr_positions, alphas)]
    res = banded_dist.sharded_banded_run(
        None, *args, kernel=kernel, tol=tol, Bh=Bh, Bw=Bw, sweeps=sweeps,
        decode_every=decode_every, line=ProcessLine(device), **kw)
    return res.labels, float(res.energy), float(res.lower_bound)


def _worker(argv=None):
    ap = argparse.ArgumentParser(
        description="one process of a multi-process solve: reads theta, D0, "
                    "Q, alphas from --inputs, runs the sharded checkerboard "
                    "solve and/or the banded stripes, and process 0 writes "
                    "the results to --out (.npz) and prints one JSON line")
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("coordinator")
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--kernel", type=int, default=1)
    ap.add_argument("--tol", type=float, default=1.0)
    ap.add_argument("--maxiter", type=int, default=0,
                    help="sweeps of the checkerboard solve (0: none)")
    ap.add_argument("--check-every", type=int, default=1)
    ap.add_argument("--banded", type=int, nargs=4, default=None,
                    metavar=("BH", "BW", "SWEEPS", "DECODE_EVERY"))
    ap.add_argument("--timeout", type=float, default=120.0)
    a = ap.parse_args(argv)
    backend = initialize(a.coordinator, a.world, a.rank, a.backend,
                         a.timeout)
    inp = np.load(a.inputs)
    prob = [inp[k] for k in ("theta", "D0", "Q", "alphas")]
    out = {"backend": backend}
    try:
        m = global_mesh(device=a.device)
        out["transport"] = m.line().transport
        if a.maxiter:
            t0 = time.perf_counter()
            res = sharded_solve_global(
                m, *prob, kernel=a.kernel, tol=a.tol, maxiter=a.maxiter,
                max_relgap=0.0, check_every=a.check_every)
            out.update(solve_labels=res.labels.cpu().numpy(),
                       solve_energy=float(res.energy),
                       solve_lb=float(res.lower_bound),
                       solve_iters=int(res.iterations),
                       solve_messages=res.messages.cpu().numpy(),
                       solve_seconds=time.perf_counter() - t0)
        if a.banded:
            Bh, Bw, sweeps, dec = a.banded
            t0 = time.perf_counter()
            labels, e, lb = sharded_banded_global(
                *prob, kernel=a.kernel, tol=a.tol, Bh=Bh, Bw=Bw,
                sweeps=sweeps, decode_every=dec, device=a.device)
            out.update(banded_labels=labels.cpu().numpy(), banded_energy=e,
                       banded_lb=lb,
                       banded_seconds=time.perf_counter() - t0)
    finally:
        dist.destroy_process_group()
    from stereo_tpu_torch.ops import minplus, phase_kernel

    out["launches"] = json.dumps({
        "phase_messages_compact": phase_kernel.phase_messages_compact.launches,
        "phase_messages": phase_kernel.phase_messages.launches,
        "minplus_send": minplus.minplus_send.launches})
    if a.rank == 0:
        np.savez(a.out, **{k: np.asarray(v) for k, v in out.items()})
        print(json.dumps({k: v for k, v in out.items()
                          if not isinstance(v, np.ndarray)}), flush=True)


if __name__ == "__main__":
    _worker()
