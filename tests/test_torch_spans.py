"""Program spans (stereo_tpu_torch.utils.profiling.span) on a 48 x 64 NCC
model with K = 15 labels, on the CPU under torch.profiler: which spans each
solve and fusion sweep records, that none nests in another, that their counts
follow the solver's iterations, that each is a plain host operation (no user
annotation, which the profiler would mirror on the device), and that with
the profiler off a span is one shared null context and changes no number.

A profiler session takes seconds to start and stop on a CPU, so every
traced job runs in one session (``traced``), each inside a ``job.<name>``
annotation that tells the jobs apart, and every untraced one in another
module fixture (``untraced``)."""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from stereo_tpu_torch import geometry, testing
from stereo_tpu_torch.models.ncc import DispMapNCC
from stereo_tpu_torch.solvers import binary
from stereo_tpu_torch.utils import profiling

torch.set_num_threads(1)

H, W = 48, 64
DISPARITIES = np.arange(0, 8)
CENTERS = [(x, y) for x in (10, 30, 50) for y in (10, 30)]
MAXITER, CHECK_EVERY = 4, 2
# the moves of the fusion sweep
MOVES = 2
SCHEDULES = ("checkerboard", "scanline", "wavefront", "banded")
TRWS_SPANS = {"trws.pack", "trws.sweep", "trws.decode", "trws.stop",
              "trws.finish"}
FUSION_SPANS = {"fusion.pack", "fusion.proposal", "fusion.k2_pack",
                "fusion.k2_sweeps", "fusion.k2_stop", "fusion.accept",
                "fusion.merge", "fusion.finish"}


@pytest.fixture(scope="module")
def problem():
    im0, im1 = testing.textured_pair(3, H, W, shift=3)
    dm = DispMapNCC([im0.astype(np.float32), im1.astype(np.float32)],
                    DISPARITIES, kernel=1, unary_weight=40.0, tol=8.0,
                    maxiter=MAXITER, max_relgap=1e-12,
                    check_every=CHECK_EVERY, device="cpu")
    dm.band = 8
    props = [dm.generate_new_plane_RANSAC(x, y, 5.0) for x, y in CENTERS]
    props += [geometry.fronto_parallel(H, W, float(d), dm.dtype, device="cpu")
              for d in DISPARITIES]
    assert len(props) + 1 == 15
    return dm, props


def _solve(dm, props, schedule):
    dm.restart()
    dm.schedule = schedule
    e, lb, iters = dm.simultaneous_fusion(props)
    return e, lb, iters, dm.assignment.clone()


def _sweep(dm, props):
    dm.restart()
    trace = dm.binary_fusion_sweep(props[:MOVES], chunk=MOVES)
    return trace, dm.assignment.clone()


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _jobs(problem):
    """{job name: a call that runs it}: each schedule's solve, the sweep."""
    dm, props = problem
    jobs = {s: (lambda s=s: _solve(dm, props, s)) for s in SCHEDULES}
    jobs["fusion"] = lambda: _sweep(dm, props)
    return jobs


@pytest.fixture(scope="module")
def traced(problem):
    """Every job under one profiler session: {job: (its result, its program
    spans [(name, start_ns, end_ns, event)] in order)}, and the K = 2
    iterations of each move of the sweep."""
    fuse, iters = binary.binary_fuse, []

    def counted(*args, **kwargs):
        res = fuse(*args, **kwargs)
        iters.append(res.iterations)
        return res
    out = {}
    with _patched(binary, "binary_fuse", counted), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        for name, job in _jobs(problem).items():
            with record_function("job." + name):
                out[name] = job()
    events = list(prof.profiler.kineto_results.events())
    spans = sorted(((ev.name(), ev.start_ns(), ev.end_ns(), ev)
                    for ev in events
                    if ev.name().startswith(profiling.SPAN_LAYERS)),
                   key=lambda r: r[1])
    jobs = {}
    for ev in events:
        if ev.name().startswith("job."):
            lo, hi = ev.start_ns(), ev.end_ns()
            jobs[ev.name()[4:]] = (out[ev.name()[4:]],
                                   [s for s in spans if lo <= s[1] <= hi])
    return jobs, iters


@pytest.fixture(scope="module")
def untraced(problem):
    """Every job with the profiler off and the profiler's record function
    refusing to be made: {job: its result}."""
    class Refused:
        def __init__(self, name):
            raise AssertionError(f"span {name} entered with profiling off")
    with _patched(torch._C._profiler, "_RecordFunctionFast", Refused):
        assert not torch.autograd._profiler_enabled()
        return {name: job() for name, job in _jobs(problem).items()}


def _assert_flat_host_ops(spans):
    """No span opens inside another; each is a plain host operation, not a
    user annotation."""
    for (a, _, a_end, _), (b, b_start, _, _) in zip(spans, spans[1:]):
        assert b_start >= a_end, f"{b} opens inside {a}"
    for name, _, _, ev in spans:
        assert not ev.is_user_annotation(), name
        assert ev.device_type() == torch.autograd.DeviceType.CPU, name
        # kineto events name their activity from torch 2.13 on
        if hasattr(ev, "activity_type"):
            assert ev.activity_type() == "cpu_op", name


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_solve_spans(traced, schedule):
    (_, _, iters, _), spans = traced[0][schedule]
    names = [s[0] for s in spans]
    assert set(names) == TRWS_SPANS
    _assert_flat_host_ops(spans)
    assert iters == MAXITER
    assert names.count("trws.sweep") == iters
    assert names.count("trws.decode") == iters // CHECK_EVERY
    # the test before every block of sweeps but the first
    assert names.count("trws.stop") == iters // CHECK_EVERY - 1
    assert names[0] == "trws.pack" and names[-1] == "trws.finish"


def test_fusion_sweep_spans(traced):
    (_, spans), iters = traced[0]["fusion"], traced[1]
    names = [s[0] for s in spans]
    assert set(names) == FUSION_SPANS
    _assert_flat_host_ops(spans)
    assert names.count("fusion.proposal") == MOVES
    assert names.count("fusion.merge") == MOVES
    assert len(iters) == MOVES
    # each move's spans, from its proposal span to the next one
    starts = [i for i, n in enumerate(names) if n == "fusion.proposal"]
    for it, a, b in zip(iters, starts, starts[1:] + [len(names)]):
        move = names[a:b]
        blocks = it // 5  # binary_fuse's check_every
        assert move.count("fusion.k2_sweeps") == blocks
        # a test before each block but the first, and the one that stopped
        # the loop unless the iteration cap did
        assert move.count("fusion.k2_stop") == blocks - (it >= 50)
        assert move.count("fusion.accept") == 1


def test_span_seconds():
    x = torch.ones(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with profiling.span("trws.sweep"):
                x = x @ x / 64
        with profiling.span("fusion.merge"):
            x = x + 1
        with record_function("not.a.span"):
            x = x * 2
        x = x - 1
    sums = profiling.span_seconds(prof)
    assert set(sums) == {"trws.sweep", "fusion.merge"}
    assert sums["trws.sweep"][1] == 2 and sums["fusion.merge"][1] == 1
    assert all(s > 0 for s, _ in sums.values())
    seconds = [s for s, _ in sums.values()]
    assert seconds == sorted(seconds, reverse=True)


def test_span_off_is_shared_null_context(untraced):
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.span("trws.sweep"), profiling.span("fusion.merge")
    assert a is b
    with a as inside:
        assert inside is None
    # every job ran without making a record function
    assert set(untraced) == set(SCHEDULES) | {"fusion"}


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_solve_same_with_profiler_on(traced, untraced, schedule):
    e0, lb0, it0, planes0 = untraced[schedule]
    (e1, lb1, it1, planes1), _ = traced[0][schedule]
    assert (e1, lb1, it1) == (e0, lb0, it0)
    assert torch.equal(planes1, planes0)


def test_fusion_sweep_same_with_profiler_on(traced, untraced):
    trace0, planes0 = untraced["fusion"]
    (trace1, planes1), _ = traced[0]["fusion"]
    assert trace1 == trace0
    assert torch.equal(planes1, planes0)
