"""A simultaneous fusion (EMMCVPR 2013) to the configuration's stopping
rule: ``dm.simultaneous_fusion(proposals)`` from the start field, TRW-S over
the proposals and the incumbent.

Judged, besides check.COMMON, on the solve's lower bound, certified by the
reference: the program's final messages of a solve drawn from the seed are
handed to one sweep of the plain float64 TRW-S (reference/trws.py) on the
K-label problem that the model's reference builds (its ``label_problem``:
its own unary and smoothness terms) on the program's label planes (the
proposals in the job's order, then the start field), in the program's node
order.  That sweep's bound is a dual value,
a lower bound of every labelling's energy whatever the messages say.

A solve ends in one of two ways, told apart by the sweeps it returns: it
stopped on its budget when they reach the program's ``maxiter``, and on
its rule (the relgap) otherwise.  The certified gap is (E_reference(program's
labelling) - certified bound) / E_reference, both ends taken by the
reference; each way of stopping is judged on what it promises:

- ``bound``: |program's bound - certified bound| / E_reference: a bound
  the sweeps inflated, or one summed wrong, reads far off;
- ``gap``: the certified gap of a solve that stopped on its rule, held to
  the configuration's relgap; 0.0 for a budget stop, to which the rule
  never applied;
- ``budget_gap``: the certified gap of a solve that used up its budget,
  held to what sound solves leave at that budget; 0.0 for a rule stop,
  which ``gap`` already holds to the relgap.  A solve that closes its gap
  on its last allowed sweep counts as a budget stop: its gap is then near
  the relgap, which no ``budget_gap`` limit is below.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import trws as ref_trws

NUMBERS = ("bound", "gap", "budget_gap")

# the messages that the last chunk of the running solve returned
_CAPTURE = {"messages": None}


def _install():
    """Keep the message state that each chunk of a simultaneous fusion
    returns, by wrapping the model's chunk step (once a process)."""
    from stereo_tpu_torch.models import base
    step = base._simultaneous_fusion_step
    if getattr(step, "portbench_capture", False):
        return

    def capture(*args, **kwargs):
        res = step(*args, **kwargs)
        _CAPTURE["messages"] = res[4]
        return res
    capture.portbench_capture = True
    base._simultaneous_fusion_step = capture


class Job:
    def __init__(self, dm, mix):
        _install()
        self.dm, self.mix = dm, mix
        self.set_seed(0)

    def set_seed(self, seed: int):
        """The solve whose messages are kept is drawn from ``seed`` (one
        among the window's, each as likely)."""
        self.rng = np.random.default_rng(seed)
        self.seen, self.kept = 0, None

    def warm_up(self, proposals):
        keep = self.dm.maxiter
        self.dm.maxiter = self.mix["warmup"]
        try:
            self.dm.simultaneous_fusion(proposals)
        finally:
            self.dm.maxiter = keep
            _CAPTURE["messages"] = None

    def run(self, proposals) -> dict:
        e, lb, sweeps = self.dm.simultaneous_fusion(proposals)
        messages, _CAPTURE["messages"] = _CAPTURE["messages"], None
        out = dict(energy=e, bound=lb, sweeps=sweeps, messages=None)
        self.seen += 1
        if self.rng.random() < 1.0 / self.seen:
            if self.kept is not None:
                self.kept["messages"] = None
            out["messages"], self.kept = messages, out
        return out

    def end_to_end(self, jobs, elapsed: float) -> dict:
        return {"solve_s": elapsed / len(jobs)}

    def view(self) -> dict:
        return dict(schedule=self.dm.schedule, band=self.dm.band,
                    maxiter=self.dm.maxiter, max_relgap=self.dm.max_relgap)


def node_order(schedule: str, band: int, H: int, W: int, device):
    """The node order of the banded schedule, the configuration's, with the
    program's block side (its message state is the one a backward pass in
    that order leaves)."""
    if schedule != "banded":
        raise ValueError(f"no reference order for the schedule {schedule!r}")
    return ref_trws.banded_order(H, W, max(2, min(band, H)),
                                 max(2, min(band, W)), device)


def certified_bound(ref, program: dict, messages: torch.Tensor) -> float:
    """The reference sweep's bound from the program's ``messages``."""
    H, W = ref.start.shape[-2:]
    device = ref.start.device
    labels = list(program["proposals"]) + [program["start"]]
    planes = torch.stack([p.to(device) for p in labels])
    theta, D0, Q, alphas, tol = ref.label_problem(planes)
    del planes
    t = node_order(program["schedule"], program["band"], H, W, device)
    return ref_trws.certified_bound(theta, D0, Q, alphas, tol, t,
                                    messages.to(device))


def judge(ref, program: dict, jobs: list, order) -> list[dict]:
    rows = []
    for job in jobs:
        row = {}
        if job.get("messages") is not None:
            lb = certified_bound(ref, program, job["messages"])
            e = ref.energy(job["planes"])
            gap = (e - lb) / e
            budget = job["sweeps"] >= program["maxiter"]
            row["bound"] = abs(job["bound"] - lb) / e
            row["gap"] = 0.0 if budget else gap
            row["budget_gap"] = gap if budget else 0.0
        rows.append(row)
    return rows
