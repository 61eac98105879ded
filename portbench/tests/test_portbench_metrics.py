"""The metric arithmetic on synthetic profiler records, and each per-layer
reader on a synthetic run."""

import numpy as np
import pytest

from portbench import harness
from portbench.metrics import _roofline, _trace


def _trace_of(dev, host, window_s):
    def cols(rows):
        return ([r[0] for r in rows],) + tuple(
            np.array([r[i] for r in rows], np.int64)
            for i in range(1, len(rows[0])))
    return _trace.Trace(cols(dev), cols(host), window_s)


# device: two overlapping kernels, a copy, a late kernel; window 100 ns
DEV = [("kA", 10, 30), ("kB", 20, 40), ("Memcpy DtoD", 50, 55),
       ("banded_sweep_kernel<1>", 70, 90)]
# host (name, start, end, thread): thread 2 is another thread's long record
HOST = [("aten::add", 0, 45, 1), ("cudaLaunchKernel", 12, 14, 1),
        ("aten::item", 55, 69, 1), ("cudaStreamSynchronize", 56, 68, 1),
        ("Activity Buffer Request", 0, 100, 2)]


def test_merge():
    s, e = _trace.merge(np.array([5, 0, 20, 8]), np.array([9, 6, 25, 12]))
    assert s.tolist() == [0, 20] and e.tolist() == [12, 25]


def test_busy_and_idle():
    tr = _trace_of(DEV, HOST, 100e-9)
    assert tr.busy_s == pytest.approx(55e-9)  # 30 + 5 + 20 ns
    assert tr.idle_share == pytest.approx(0.45)


def test_kernels_leave_out_copies():
    tr = _trace_of(DEV, HOST, 100e-9)
    assert len(tr.kernels()) == 3
    assert tr.kernels("banded_sweep_kernel").tolist() == pytest.approx(
        [20e-9])


def test_device_ops_and_idle_gaps():
    tr = _trace_of(DEV, HOST, 100e-9)
    ops = dict(tr.device_ops())
    assert ops["kA"] == pytest.approx(20e-9)
    assert list(ops)[0] in ("kA", "kB", "banded_sweep_kernel<1>")
    gaps = tr.idle_gaps()
    # gaps 40-50 (middle 45: aten::add ends at 45) and 55-70 (middle 62:
    # inside aten::item); the other thread's record labels nothing
    assert gaps == [["aten::item", pytest.approx(15e-9)],
                    ["aten::add", pytest.approx(10e-9)]]
    # a gap while no operation of the program's thread runs
    tr2 = _trace_of(DEV, [HOST[0], HOST[4]], 100e-9)
    assert dict(tr2.idle_gaps())["between host operations"] == \
        pytest.approx(15e-9)


def test_sweep_bounds():
    b = _roofline.sweep_bounds(79, 375 * 450)
    assert b["bound_by"] == "operations"
    assert b["bound_s"] == pytest.approx(8 * 168750 * 79 ** 2 * 6 / 67e12)
    assert b["bytes_s"] == pytest.approx(168750 * (14 * 79 + 10) * 4
                                         / 3.35e12)


def _ctx(kind):
    tr = _trace_of(DEV, HOST, 100e-9)
    if kind == "simultaneous":
        jobs = [dict(sweeps=3), dict(sweeps=5)]
    else:
        jobs = [dict(moves=4), dict(moves=4)]
    return dict(kind=kind, trace=tr, traced=jobs[:1], jobs=jobs, K=79,
                H=375, W=450)


def test_readers():
    read = {m: harness.metric_reader(m) for m in (
        "idle_share.fusion", "idle_share.simultaneous",
        "fusion.kernels_per_move", "fusion.device_ms_per_move",
        "trws.sweeps_per_solve", "trws.sweep_bound_share",
        "banded_sweep_roofline")}
    sim, fus = _ctx("simultaneous"), _ctx("fusion_sweep")
    bound = _roofline.sweep_bounds(79, 375 * 450)["bound_s"]
    assert read["idle_share.simultaneous"](sim) == pytest.approx(0.45)
    assert read["idle_share.fusion"](sim) is None
    assert read["idle_share.fusion"](fus) == pytest.approx(0.45)
    assert read["fusion.kernels_per_move"](fus) == pytest.approx(3 / 4)
    assert read["fusion.device_ms_per_move"](fus) == pytest.approx(
        55e-9 * 1e3 / 4)
    assert read["trws.sweeps_per_solve"](sim) == 4
    assert read["trws.sweeps_per_solve"](fus) is None
    assert read["trws.sweep_bound_share"](sim) == pytest.approx(
        3 * bound / 55e-9)
    assert read["banded_sweep_roofline"](sim) == pytest.approx(
        100 * bound / 20e-9)
    # another schedule's solve: no banded kernel in the trace
    other = dict(sim, trace=_trace_of(DEV[:3], HOST, 100e-9))
    assert read["banded_sweep_roofline"](other) is None
