"""The readers of the program's spans (metrics/_spans.py and the metrics
that use it) on hand-built traces: shares and counts, nothing for the other
job kind, and nothing for a trace whose program opens no span."""

import numpy as np
import pytest

from portbench import harness
from portbench.metrics import _spans, _trace

SOLVE_METRICS = ("trws.decode_share", "trws.pack_share",
                 "trws.decodes_per_solve")
FUSION_METRICS = ("fusion.k2_share", "fusion.accept_share",
                  "fusion.k2_stops_per_move")

# device: two kernels; window 1000 ns
DEV = [("kA", 100, 150), ("kB", 600, 650)]
# host (name, start, end, thread): flat program spans with aten ops inside,
# and another thread's long record
SOLVE_HOST = [
    ("trws.pack", 0, 100, 1), ("aten::stack", 10, 90, 1),
    ("trws.sweep", 100, 160, 1), ("cudaLaunchKernel", 105, 110, 1),
    ("trws.sweep", 160, 200, 1),
    ("trws.decode", 200, 500, 1), ("aten::gather", 210, 300, 1),
    ("trws.stop", 500, 520, 1),
    ("trws.sweep", 520, 600, 1),
    ("trws.decode", 600, 850, 1),
    ("trws.finish", 850, 900, 1), ("trws.pack", 900, 950, 1),
    ("Activity Buffer Request", 0, 1000, 2)]
FUSION_HOST = [
    ("fusion.pack", 0, 20, 1),
    ("fusion.proposal", 20, 100, 1), ("fusion.k2_pack", 100, 120, 1),
    ("fusion.k2_sweeps", 120, 300, 1), ("aten::where", 130, 140, 1),
    ("fusion.k2_stop", 300, 310, 1), ("fusion.k2_sweeps", 310, 400, 1),
    ("fusion.k2_stop", 400, 405, 1), ("fusion.accept", 405, 500, 1),
    ("fusion.merge", 500, 540, 1),
    ("fusion.proposal", 540, 600, 1), ("fusion.k2_pack", 600, 610, 1),
    ("fusion.k2_sweeps", 610, 800, 1), ("fusion.k2_stop", 800, 815, 1),
    ("fusion.accept", 815, 900, 1), ("fusion.merge", 900, 960, 1),
    ("fusion.finish", 960, 1000, 1)]
# a parent's trace: the same aten ops, no program span
BARE_HOST = [("aten::stack", 10, 90, 1), ("aten::gather", 210, 300, 1),
             ("aten::where", 130, 140, 1), ("Activity Buffer Request", 0,
                                            1000, 2)]


def _trace_of(host, window_s=1000e-9):
    def cols(rows):
        return ([r[0] for r in rows],) + tuple(
            np.array([r[i] for r in rows], np.int64)
            for i in range(1, len(rows[0])))
    return _trace.Trace(cols(DEV), cols(host), window_s)


def _ctx(kind, host):
    if kind == "simultaneous":
        jobs = [dict(sweeps=3), dict(sweeps=5)]
    else:
        jobs = [dict(moves=2), dict(moves=4)]
    return dict(kind=kind, trace=_trace_of(host), traced=jobs[:1], jobs=jobs,
                K=79, H=375, W=450)


def _read(name, ctx):
    return harness.metric_reader(name)(ctx)


def test_spans_sum_by_name():
    tr = _trace_of(SOLVE_HOST)
    assert _spans.share(tr, "trws.decode") == pytest.approx(0.55)
    assert _spans.share(tr, "trws.pack") == pytest.approx(0.15)
    assert _spans.share(tr, "trws.sweep", "trws.stop") == pytest.approx(0.2)
    assert _spans.share(tr, "trws.nothing") == 0.0
    assert _spans.count(tr, "trws.sweep") == 3
    assert _spans.count(tr, "trws.nothing") == 0
    bare = _trace_of(BARE_HOST)
    assert _spans.share(bare, "trws.decode") is None
    assert _spans.count(bare, "trws.decode") is None


def test_solve_readers():
    ctx = _ctx("simultaneous", SOLVE_HOST)
    assert _read("trws.decode_share", ctx) == pytest.approx(0.55)
    assert _read("trws.pack_share", ctx) == pytest.approx(0.15)
    assert _read("trws.decodes_per_solve", ctx) == 2
    two = dict(ctx, traced=ctx["jobs"])
    assert _read("trws.decodes_per_solve", two) == 1


def test_fusion_readers():
    ctx = _ctx("fusion_sweep", FUSION_HOST)
    # k2_sweeps 180 + 90 + 190 ns, k2_stop 10 + 5 + 15 ns
    assert _read("fusion.k2_share", ctx) == pytest.approx(0.49)
    assert _read("fusion.accept_share", ctx) == pytest.approx(0.18)
    assert _read("fusion.k2_stops_per_move", ctx) == pytest.approx(3 / 2)


@pytest.mark.parametrize("name", SOLVE_METRICS + FUSION_METRICS)
def test_nothing_for_the_other_kind(name):
    kind = "fusion_sweep" if name in SOLVE_METRICS else "simultaneous"
    host = FUSION_HOST if kind == "fusion_sweep" else SOLVE_HOST
    assert _read(name, _ctx(kind, host)) is None


@pytest.mark.parametrize("name", SOLVE_METRICS + FUSION_METRICS)
def test_nothing_without_program_spans(name):
    kind = "simultaneous" if name in SOLVE_METRICS else "fusion_sweep"
    assert _read(name, _ctx(kind, BARE_HOST)) is None
    assert _read(name, dict(_ctx(kind, SOLVE_HOST), trace=None)) is None


def test_idle_gaps_name_the_spans():
    # the device's gap 150-600 (middle 375, in trws.decode and not in the
    # aten op it holds) takes the span's name
    assert _trace_of(SOLVE_HOST).idle_gaps() == [
        ["trws.decode", pytest.approx(450e-9)]]
    assert _trace_of(BARE_HOST).idle_gaps() == [
        ["between host operations", pytest.approx(450e-9)]]
