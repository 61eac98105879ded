"""One run of one cell of the benchmark of stereo_tpu_torch.

Everything that belongs to a cell is found by name: the cell in
BENCHMARK.json, its configuration in portbench/configs/<config>.json, the
configuration's stereo model in portbench/models/<model>.py (the program's
construction, the plain reference and the model's own checks), its traffic
mix in portbench/traffic/<traffic>.json (parameters, and the name of its job
kind), the kind in portbench/jobs/<job>.py, each per-layer metric's reader
in portbench/metrics/<metric>.py and the limits of its comparison in
portbench/limits/<cell>.json.  A new cell, configuration, model, mix, job
kind or metric is a new file and a new entry; no file here names one.

A run: set-up (the program's kernels loaded from its build directory, the
images decoded, the model, the proposals, one short job at the cell's own
shapes), then the timed window: the mix's job, from the same start each
time, back to back until ``seconds`` have passed (no job starts after that;
the one under way finishes and counts).  With ``trace`` the first job of the
window runs under torch.profiler and the result carries the per-layer
metrics; without it, the end-to-end ones.  After the window the program's
state is freed and the plain reference judges what every job produced
(portbench/check.py, the model's and the kind's ``judge``).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch

from portbench import check
from portbench.metrics import _trace
from portbench.reference import png

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names that no run may load (compared whole: the port's
# own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "stereo_tpu")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec() -> dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    """portbench/configs/<name>.json; one that names no model is refused."""
    cfg = _json(os.path.join(BENCH_DIR, "configs", name + ".json"))
    if "model" not in cfg:
        raise SystemExit(f"the configuration {name!r} names no model")
    return cfg


def traffic(name: str) -> dict:
    return _json(os.path.join(BENCH_DIR, "traffic", name + ".json"))


def limits(cell: str) -> dict:
    return _json(os.path.join(BENCH_DIR, "limits", cell + ".json"))


def _module(sub: str, name: str):
    """portbench/<sub>/<name>.py, loaded once a process."""
    key = f"portbench_{sub}_" + name.replace(".", "_")
    if key not in sys.modules:
        path = os.path.join(BENCH_DIR, sub, name + ".py")
        if not os.path.exists(path):
            raise SystemExit(f"no {sub} file {path}")
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[key] = mod
    return sys.modules[key]


def metric_reader(name: str):
    """The ``read(ctx)`` of portbench/metrics/<name>.py."""
    return _module("metrics", name).read


def job_kind(name: str):
    """The job kind portbench/jobs/<name>.py."""
    return _module("jobs", name)


def model_kind(name: str):
    """The stereo model portbench/models/<name>.py."""
    return _module("models", name)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def images(cfg: dict) -> list[np.ndarray]:
    """The pair, decoded, cropped to the configuration's ``crop`` if it has
    one ([y0, y1, x0, x1])."""
    ims = [png.read_rgb(os.path.join(BENCH_DIR, p)) for p in cfg["images"]]
    if "crop" in cfg:
        y0, y1, x0, x1 = cfg["crop"]
        ims = [im[y0:y1, x0:x1] for im in ims]
    return ims


def order_of(seed: int, n: int) -> list[int]:
    """The seed's order of the proposal stream: every seed poses the same
    problem with its proposals in another order."""
    return [int(i) for i in np.random.default_rng(seed).permutation(n)]


class Program:
    """The system under test: the configuration's model in stereo_tpu_torch,
    its proposals in the seed's order, and the mix's job."""

    def __init__(self, cfg: dict, mix: dict, ims, device, control=None):
        self.model = model_kind(cfg["model"])
        self.dm, self.made = self.model.build(cfg, ims, device, control)
        self.kind_name = mix["job"]
        self.kind = job_kind(self.kind_name)
        self.job = self.kind.Job(self.dm, mix)
        self.start = None
        self.set_seed(0)

    def set_seed(self, seed: int):
        self.order = order_of(seed, len(self.made))
        self.proposals = [self.made[i] for i in self.order]
        self.job.set_seed(seed)

    def view(self) -> dict:
        """The pieces the reference judges besides the jobs' results."""
        return dict(start=self.start, proposals=self.proposals,
                    **self.model.view(self.dm), **self.job.view())

    @property
    def K(self) -> int:
        return len(self.proposals) + 1

    def run(self) -> dict:
        """One job of the mix from the start field."""
        self.dm.restart()
        if self.start is None:
            self.start = self.dm.assignment.clone()
        out = self.job.run(self.proposals)
        out["planes"] = self.dm.assignment.clone()
        return out

    def warm_up(self):
        """One short job at the cell's shapes."""
        self.dm.restart()
        self.job.warm_up(self.proposals)


def moved(x, device):
    """``x`` with every tensor in it (in dicts, lists, tuples) on
    ``device``."""
    if torch.is_tensor(x):
        return x.to(device)
    if isinstance(x, dict):
        return {k: moved(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(moved(v, device) for v in x)
    return x


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def window(prog: Program, seconds: float, device, trace: bool):
    """The timed jobs: (seconds from the first start to the last end, job
    results, the first job's Trace or None)."""
    jobs, tr = [], None
    sync(device)
    t0 = time.perf_counter()
    while True:
        if trace and not jobs:
            r, tr = _trace.capture(prog.run)
        else:
            r = prog.run()
        sync(device)
        jobs.append(r)
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            return elapsed, jobs, tr


def run_cell(cell: dict, cfg: dict, mix: dict, lims: dict, *, seed: int,
             seconds: float, trace: bool, device, per_layer=(),
             end_to_end=(), t_start=None, control=None) -> dict:
    """One run; returns the result line's fields (see run.py), and "_ok":
    each number's verdict.  ``per_layer`` and ``end_to_end``: the cell's
    metrics' entries in BENCHMARK.json.  ``control``: what the control run
    hands the program (the model's ``control(ref)``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    on_card = torch.device(device).type == "cuda"
    ims = images(cfg)
    if on_card:
        from stereo_tpu_torch.ops import _build
        _build.build_all()
    prog = Program(cfg, mix, ims, device, control=control)
    prog.set_seed(seed)
    prog.warm_up()
    if trace:  # the profiler's own start-up stays out of the window
        _trace.capture(lambda: torch.zeros(1, device=device) + 1)
    sync(device)
    setup_s = time.perf_counter() - t_start
    if on_card:  # the peak of the timed window
        torch.cuda.reset_peak_memory_stats()
    elapsed, jobs, tr = window(prog, seconds, device, trace)
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    H, W = prog.dm.sz
    kind_name, kind, model, order = (prog.kind_name, prog.kind, prog.model,
                                     prog.order)
    metrics = {}
    if trace:
        ctx = dict(kind=kind_name, trace=tr, traced=jobs[:1], jobs=jobs,
                   K=prog.K, H=H, W=W)
        for m in per_layer:
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = prog.job.end_to_end(jobs, elapsed)
        e2e["setup_s"] = setup_s
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in end_to_end if m["name"] in e2e}

    # the program's outputs leave the card with its state
    program = moved(prog.view(), "cpu")
    jobs = moved(jobs, "cpu")
    del prog
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ref = model.Reference(cfg, ims, device)
    numbers, per_job = check.judge(ref, model, kind, order,
                                   moved(program, device),
                                   moved(jobs, device))
    correct, failed, checks = check.verdict(
        numbers, per_job, lims,
        check.COMMON + tuple(model.NUMBERS) + tuple(kind.NUMBERS))

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name() if on_card else "cpu",
           "count": cell.get("chips", 1), "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": len(jobs), "failed": failed,
           "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.device_ops(),
                            "idle_gaps": tr.idle_gaps()}
    out["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                     for k, c in checks.items()}
    out["_ok"] = {k: c["ok"] for k, c in checks.items()}
    return out
