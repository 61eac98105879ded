"""A second stereo model through the harness's generic paths, defined here:
the NCC model with seeded per-edge smoothness weights in [1, 10] and
disparities normalised by (d_min, d_step), as the global model has them, on
both sides (the program through ``DispMap.smooth_weights`` and
``DispMap.normalize``, the reference through reference/planes.py's weighted
smoothness and its label problem's alphas).  A whole small CPU run of each
job kind on it is correct; the same run with the reference's weights left
at one is not.  A solve cut to a budget too small to close its gap is judged
on that gap by ``budget_gap``, against the limit a configuration whose
solves run to their budget sets."""

import sys
import types

import pytest
import torch

from portbench import harness
from portbench.reference import planes as geo
from test_portbench_faults import small_config

NAME = "weighted_test_model"
SEED = 20240521
MAXITER = 160
# a budget at which the weighted solve's gap is still open (7.8e-4 at 48
# sweeps on the CPU, closed at 64), and budget_gap limits above and below it
BUDGET = 48
BUDGET_GAP = {"sound": 2e-3, "tight": 2e-4}


def _weights(H, W):
    """[4, H, W] in [1, 10] (float32 values), 0 where the tail lies
    outside the image."""
    g = torch.Generator().manual_seed(SEED)
    w = (1 + 9 * torch.rand(4, H, W, generator=g)).double()
    return w * geo.edge_mask(H, W, w)


def _model(unit_reference: bool):
    """The weighted model as a module; ``unit_reference``: the reference's
    edge weights left at one (the planted fault)."""
    base = harness.model_kind("ncc")
    mod = types.ModuleType(NAME)
    for name in ("NUMBERS", "view", "judge", "readings", "control"):
        setattr(mod, name, getattr(base, name))

    def normalize(cfg):
        lo, hi = cfg["disparities"]
        return (float(lo), float(hi - lo))

    def build(cfg, ims, device, control=None):
        dm, proposals = base.build(cfg, ims, device, control)
        dm.smooth_weights = _weights(*dm.sz).to(dm.dtype).to(dm.device)
        dm.normalize = normalize(cfg)
        dm.restart()
        return dm, proposals

    class Reference(base.Reference):
        def __init__(self, cfg, ims, device):
            super().__init__(cfg, ims, device)
            self.normalize = normalize(cfg)
            H, W = self.wta.shape
            self.weights = (geo.edge_mask(H, W, self.vol) if unit_reference
                            else _weights(H, W).to(self.vol.device))

        def edge_weights(self):
            return self.weights

    mod.build, mod.Reference = build, Reference
    return mod


def _cells():
    """One cell of each job kind."""
    kinds = {}
    for w in harness.load_spec()["workloads"]:
        kinds.setdefault(harness.traffic(w["traffic"])["job"], w["name"])
    return sorted(kinds.values())


def _run(cell, monkeypatch, unit_reference, maxiter=MAXITER, limits=None):
    monkeypatch.setitem(sys.modules, "portbench_models_" + NAME,
                        _model(unit_reference))
    entry, cfg = small_config(cell)
    lo, hi = cfg["disparities"]
    # the configuration's truncation, in normalised units; the weights
    # slow the solve, which needs more sweeps than SMALL's to close its gap
    cfg = dict(cfg, model=NAME, tol=cfg["tol"] / (hi - lo), maxiter=maxiter)
    return harness.run_cell(entry, cfg, harness.traffic(entry["traffic"]),
                            {**harness.limits(cell), **(limits or {})},
                            seed=3141592653, seconds=0.0, trace=False,
                            device="cpu")


@pytest.mark.parametrize("cell", _cells())
def test_weighted_model_run_is_correct(cell, monkeypatch):
    out = _run(cell, monkeypatch, unit_reference=False)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1


@pytest.mark.parametrize("cell", _cells())
def test_unit_weights_in_the_reference_are_not_correct(cell, monkeypatch):
    out = _run(cell, monkeypatch, unit_reference=True)
    assert not out["correct"], out["checks"]
    assert out["failed"] >= 1


def _solve_cell():
    return next(w["name"] for w in harness.load_spec()["workloads"]
                if harness.traffic(w["traffic"])["job"] == "simultaneous")


@pytest.mark.parametrize("limit", sorted(BUDGET_GAP))
def test_budget_stop_is_judged_on_its_gap(limit, monkeypatch):
    kind = harness.job_kind("simultaneous")
    judged = []
    judge = kind.judge

    def keep(ref, program, jobs, order):
        judged.append((ref, program, jobs))
        return judge(ref, program, jobs, order)
    monkeypatch.setattr(kind, "judge", keep)
    out = _run(_solve_cell(), monkeypatch, unit_reference=False,
               maxiter=BUDGET, limits={"budget_gap": BUDGET_GAP[limit]})
    (ref, program, jobs), = judged
    job, = [j for j in jobs if j.get("messages") is not None]
    assert job["sweeps"] == program["maxiter"] == BUDGET
    # the certified gap, worked out again from the kept solve's messages
    e = ref.energy(job["planes"])
    gap = (e - kind.certified_bound(ref, program, job["messages"])) / e
    checks = out["checks"]
    assert gap > program["max_relgap"]
    assert checks["gap"]["value"] == 0.0
    assert checks["budget_gap"]["value"] == gap
    # the program's own gap sides with it, within the bound's and the
    # energy's readings
    own = (job["energy"] - job["bound"]) / job["energy"]
    assert abs(own - gap) <= (checks["bound"]["value"]
                              + checks["energy"]["value"] + 1e-12)
    if limit == "sound":
        assert out["correct"], checks
        assert out["failed"] == 0
    else:
        assert gap > BUDGET_GAP[limit]
        assert not out["correct"] and not out["_ok"]["budget_gap"], checks
        assert out["failed"] >= 1
