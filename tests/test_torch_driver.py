"""The one TRW-S driver of solvers/trws.py on a scripted fake problem:
``drive``'s stopping loop (the first round always runs, a budget that
``check_every`` does not divide is overshot, no stop test at the budget, a
stop on a closed gap) and ``PreparedRun.run``'s incumbent (a tie keeps the
first); the model's schedule table (each schedule's solver looked up at the
call, its own chunk attribute); and the K-label problem that
``DispMap.simultaneous_problem`` builds once a solve, against the stack,
unaries and positions the solve built before it, bit for bit."""

import numpy as np
import pytest
import torch

from stereo_tpu_torch import energy, geometry, testing
from stereo_tpu_torch.models import base
from stereo_tpu_torch.models.ncc import DispMapNCC
from stereo_tpu_torch.solvers import binary, trws

torch.set_num_threads(1)

H, W = 3, 4


class Scripted:
    """A packed problem whose check returns the next (energy, lb) of a
    script; the state counts the sweeps, the labels are the check's
    index."""

    def __init__(self, script):
        self.script = list(script)
        self.K, self.H, self.W = 1, H, W
        self.dtype, self.device = torch.float64, torch.device("cpu")
        self.checks = 0

    def init_state(self, messages=None):
        return 0

    def sweep(self, state):
        return state + 1, None

    def check(self, state, lb_sweep):
        e, lb = self.script[min(self.checks, len(self.script) - 1)]
        labels = torch.full((H, W), self.checks, dtype=torch.int32)
        self.checks += 1
        return (torch.tensor(e, dtype=torch.float64),
                torch.tensor(lb, dtype=torch.float64), labels)

    def messages(self, state):
        return state


OPEN, CLOSED = (10.0, 5.0), (10.0, 10.0)
# name: (maxiter, check_every, script of (energy, lb) a check, expected
# sweeps, checks and stop tests)
DRIVE_CASES = {
    # the gap of the first check is closed and the zero start reads closed
    # too, yet the first round runs before any test
    "first_round_runs": (8, 4, [CLOSED], 4, 1, 1),
    # 3 rounds of 4 for a budget of 10: 12 sweeps; tests after 4 and 8 only
    "overshoot": (10, 4, [OPEN], 12, 3, 2),
    # the budget spent exactly: no test after the last round
    "no_test_at_budget": (8, 4, [OPEN], 8, 2, 1),
    "stop_on_closed_gap": (40, 2, [OPEN, OPEN, CLOSED], 6, 3, 3),
}


@pytest.mark.parametrize("case", sorted(DRIVE_CASES))
def test_drive(case, monkeypatch):
    maxiter, check_every, script, sweeps, checks, tests = DRIVE_CASES[case]
    gap_open, calls = trws._gap_open, []

    def counted(*args, **kwargs):
        calls.append(args)
        return gap_open(*args, **kwargs)
    monkeypatch.setattr(trws, "_gap_open", counted)
    prob = Scripted(script)
    res = trws.drive(lambda: prob, maxiter=maxiter, max_relgap=1e-4,
                     check_every=check_every)
    assert (res.iterations, res.messages) == (sweeps, sweeps)
    assert (prob.checks, len(calls)) == (checks, tests)
    e, lb = script[min(checks, len(script)) - 1]
    assert (float(res.energy), float(res.lower_bound)) == (e, lb)
    assert torch.equal(res.labels, torch.full((H, W), checks - 1,
                                              dtype=torch.int32))


# name: (sweeps, decode_every, energies of the decodes, the decode kept)
RUN_CASES = {
    # 5, 3, 3, 4: the first 3 stays the incumbent
    "tie_keeps_first": (8, 2, [5.0, 3.0, 3.0, 4.0], 1),
    # decode_every beyond the budget: one decode at its end
    "one_decode": (5, 9, [7.0], 0),
    # a budget decode_every does not divide runs its whole rounds only
    "whole_rounds": (7, 3, [6.0, 2.0], 1),
}


@pytest.mark.parametrize("case", sorted(RUN_CASES))
def test_prepared_run_keeps_the_incumbent(case):
    sweeps, decode_every, energies, kept = RUN_CASES[case]
    run = trws.PreparedRun(Scripted([(e, 1.0) for e in energies]))
    state, e, lb, labels = run.run(run.init_state(), sweeps, decode_every)
    assert state == min(sweeps, decode_every) * len(energies)
    assert run._p.checks == len(energies)
    assert float(e) == energies[kept] and float(lb) == 1.0
    assert torch.equal(labels, torch.full((H, W), kept, dtype=torch.int32))


@pytest.fixture(scope="module")
def model():
    im0, im1 = testing.textured_pair(5, 16, 20, shift=2)
    dm = DispMapNCC([im0.astype(np.float32), im1.astype(np.float32)],
                    np.arange(0, 5), kernel=1, unary_weight=40.0, tol=8.0,
                    maxiter=8, max_relgap=1e-12, check_every=2,
                    device="cpu")
    props = [geometry.fronto_parallel(16, 20, float(d), dm.dtype,
                                      device="cpu") for d in range(5)]
    props.append(dm.generate_new_plane_RANSAC(8, 8, 5.0))
    return dm, props


def _positions_as_before(planes, normalize):
    """The positions the model built before energy.positions held them."""
    D0 = energy.normalized(geometry.own_disparity(planes), normalize)
    Q = torch.stack([energy.normalized(
        geometry.neighbor_plane_disparity(planes, d, fill=0.0), normalize)
        for d in range(geometry.NUM_DIRS)], dim=0)
    return D0, Q


@pytest.mark.parametrize("normalize", [None, (1.0, 0.5)])
def test_simultaneous_problem_is_the_solve_s_problem(model, normalize,
                                                     monkeypatch):
    dm, props = model
    dm.restart()
    monkeypatch.setattr(dm, "normalize", normalize)
    unary, D0, Q, alphas, stack = dm.simultaneous_problem(props)
    planes = [dm._tensor(p) for p in props] + [dm.assignment]
    want_stack = torch.stack(planes, dim=0)
    assert torch.equal(stack, want_stack)
    assert torch.equal(unary, torch.stack([dm.unary_map(p)
                                           for p in planes]))
    want_D0, want_Q = _positions_as_before(want_stack, normalize)
    assert torch.equal(D0, want_D0) and torch.equal(Q, want_Q)
    assert alphas is dm.smooth_weights
    # the K = 2 problem of a fusion move is the same function on a 2-stack
    d0, q = binary.fusion_problem(planes[0], planes[1], normalize)
    assert torch.equal(d0, want_D0[:2]) and torch.equal(q, want_Q[:, :2])


@pytest.mark.parametrize("schedule", sorted(base._SCHEDULES))
def test_schedule_table(model, schedule, monkeypatch):
    """The model finds the schedule's solver in its module at each call,
    hands it the chunk its own attribute sets, and passes the budget and
    the stride by keyword."""
    dm, props = model
    module, name, chunk_attr = base._SCHEDULES[schedule]
    solver, seen = getattr(module, name), []

    def recorded(*args, **kwargs):
        seen.append(kwargs)
        return solver(*args, **kwargs)
    monkeypatch.setattr(module, name, recorded)
    monkeypatch.setattr(dm, "schedule", schedule)
    monkeypatch.setattr(dm, chunk_attr, 4)
    monkeypatch.setattr(dm, "band", 6)
    monkeypatch.setattr(dm, "max_relgap", float("-inf"))  # every chunk runs
    dm.restart()
    _, _, iters = dm.simultaneous_fusion(props)
    assert iters == dm.maxiter == 8
    assert [kw["maxiter"] for kw in seen] == [4, 4]
    assert all(kw["check_every"] == dm.check_every for kw in seen)
    if schedule == "banded":
        assert all((kw["Bh"], kw["Bw"]) == (6, 6) for kw in seen)
