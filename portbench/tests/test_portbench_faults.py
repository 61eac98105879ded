"""Whole runs of the harness at a small size on the CPU (the program's
plain versions in place of its CUDA kernels), with the cell's own limits:
a sound run is correct; the control (the configuration's model's: the
reference's cost volume in bfloat16 handed to the program) and each fault
planted in the program underneath the timed path are not: a step that
returns its state unchanged, the energy taken over half the image and
doubled, an answer altered where it is made, and (simultaneous fusion) a
bound that the sweeps report too high and a solve that returns before its
budget with its gap open.  One chip: there is no exchange between chips
to leave out."""

import pytest
import torch

from portbench import harness

SMALL = dict(crop=[200, 248, 250, 314], disparities=[0, 16], maxiter=40,
             max_relgap=1e-6)


def small_config(cell):
    """(the cell's entry, its configuration at the small size)."""
    entry = harness.find(harness.load_spec()["workloads"], cell, "workload")
    cfg = dict(harness.config(entry["config"]), **SMALL)
    cfg["proposals"] = dict(cfg["proposals"], grid_step=16)
    return entry, cfg


def _run(cell, seed=2876543210, control=None):
    entry, cfg = small_config(cell)
    return harness.run_cell(entry, cfg, harness.traffic(entry["traffic"]),
                            harness.limits(cell), seed=seed, seconds=0.0,
                            trace=False, device="cpu", control=control)


def _clone(x):
    if torch.is_tensor(x):
        return x.clone()
    return type(x)(_clone(v) for v in x)


def _sweep_unchanged(mp):
    """Every TRW-S sweep returns the state it was given."""
    from stereo_tpu_torch.solvers import banded
    make = banded._make_sweep_fn

    def broken(bp, use_kernel, sweep):
        fn = make(bp, use_kernel, sweep)

        def step(state):
            _, lb = fn(_clone(state))
            return state, lb
        return step
    mp.setattr(banded, "_make_sweep_fn", broken)


def _bound_inflated(mp):
    """Every TRW-S sweep reports its bound 1 % high."""
    from stereo_tpu_torch.solvers import banded
    make = banded._make_sweep_fn

    def broken(bp, use_kernel, sweep):
        fn = make(bp, use_kernel, sweep)

        def step(state):
            state, lb = fn(state)
            return state, lb + 0.01 * lb.abs()
        return step
    mp.setattr(banded, "_make_sweep_fn", broken)


def _stops_early(mp):
    """The banded solve returns after its first sweep, as if it had met the
    rule: well before its budget, with its gap open."""
    from stereo_tpu_torch.solvers import banded
    solve = banded.solve_banded

    def broken(*a, **kw):
        return solve(*a, **dict(kw, maxiter=1, check_every=1))
    mp.setattr(banded, "solve_banded", broken)


def _move_unchanged(mp):
    """Every fusion move keeps the current labelling."""
    from stereo_tpu_torch.solvers import binary
    fuse = binary.binary_fuse

    def broken(unary0, unary1, D0, Q, alphas, **kw):
        res = fuse(unary0, unary1, D0, Q, alphas, **kw)
        V = binary._tables(D0, Q, alphas, kw["kernel"], kw["tol"])
        keep = torch.zeros_like(res.take)
        return res._replace(take=keep, energy=binary._k2_energy(
            keep, unary0, unary1, V))
    mp.setattr(binary, "binary_fuse", broken)


def _half_energy_banded(mp):
    """The decode's energy over half the image's steps, doubled."""
    from stereo_tpu_torch.solvers import banded
    step = banded._decode_step

    def broken(bp, state, t, *a):
        sol, e = step(bp, state, t, *a)
        return sol, (2 * e if t % 2 == 0 else 0 * e)
    mp.setattr(banded, "_decode_step", broken)


def _half_energy_fusion(mp):
    """A move's energy over the even rows, doubled."""
    from stereo_tpu_torch.solvers import binary
    energy = binary._k2_energy

    def broken(z, theta0, theta1, V, own=None):
        rows = torch.arange(z.shape[0], device=z.device)[:, None] % 2 == 0
        return 2 * energy(z, theta0, theta1, V, own=rows.expand_as(z))
    mp.setattr(binary, "_k2_energy", broken)


def _altered(method):
    """The job's answer altered where it is made: a block of the final
    labelling takes the first proposal's plane."""
    def plant(mp):
        from stereo_tpu_torch.models.base import DispMap
        run = getattr(DispMap, method)

        def broken(self, proposals, *a, **kw):
            out = run(self, proposals, *a, **kw)
            self._assignment[:, :6, :6] = self._tensor(proposals[0])[:, :6,
                                                                     :6]
            return out
        mp.setattr(DispMap, method, broken)
    return plant


CELLS = {"ncc_teddy.simultaneous": dict(
             unchanged=_sweep_unchanged, half=_half_energy_banded,
             altered=_altered("simultaneous_fusion"),
             inflated=_bound_inflated, early=_stops_early),
         "ncc_teddy.fusion": dict(
             unchanged=_move_unchanged, half=_half_energy_fusion,
             altered=_altered("binary_fusion_sweep"))}
# the number that a fault has to fail, where one alone can see it: a solve
# that stopped short of its budget is held to the relgap by ``gap``
FAILS = {"early": "gap"}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    if "budget_gap" in out["checks"]:  # the small solve meets its rule
        assert out["checks"]["budget_gap"]["value"] == 0.0


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_is_not_correct(cell):
    _, cfg = small_config(cell)
    model = harness.model_kind(cfg["model"])
    ref = model.Reference(cfg, harness.images(cfg), "cpu")
    out = _run(cell, control=model.control(ref))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(CELLS)
                                        for f in sorted(CELLS[c])])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    CELLS[cell][fault](monkeypatch)
    out = _run(cell)
    assert not out["correct"], out["checks"]
    assert out["failed"] >= 1
    if fault in FAILS:
        assert not out["_ok"][FAILS[fault]], out["checks"]
