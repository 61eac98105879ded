"""Profiling: spans on torch.profiler's clock, and device traces (port of
stereo_tpu/utils/profiling.py).

``span(name)`` marks a phase of the program (``<layer>.<phase>``, e.g.
``trws.decode``) as one host record of the profiler, so that a trace can
say which phase the host was in while the device sat idle.  Program spans
are flat: no span opens inside another, and a span's name carries no index
(the order in the trace is the index).  ``device_trace`` writes a chrome
trace of a block; ``span_seconds`` sums a finished trace's spans by name.
"""

from __future__ import annotations

import contextlib
from contextlib import contextmanager

import torch

# the layers whose phases the program marks
SPAN_LAYERS = ("trws.", "fusion.")

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that marks ``name`` on the profiler's clock while
    torch.profiler records, and does nothing otherwise (one shared null
    context: no allocation, no synchronise, no device operation).

    Not ``torch.profiler.record_function``: that records a user annotation,
    which kineto mirrors under CUDA activity as a ``gpu_user_annotation``
    event on the device spanning the range's kernels and the gaps between
    them, and a trace that takes every device event for work would then
    count the span as device time.  ``_RecordFunctionFast`` records a plain
    host operation (``cpu_op``), on the thread and clock of the ops it
    holds."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF


def span_seconds(prof) -> dict[str, tuple[float, int]]:
    """{span name: (seconds, count)} of a finished torch.profiler run's
    program spans, the most seconds first.  Read from the profiler's raw
    events: ``key_averages`` takes minutes over a solve's million records."""
    sums: dict[str, tuple[float, int]] = {}
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if name.startswith(SPAN_LAYERS):
            s, n = sums.get(name, (0.0, 0))
            sums[name] = (s + (ev.end_ns() - ev.start_ns()) * 1e-9, n + 1)
    return dict(sorted(sums.items(), key=lambda kv: -kv[1][0]))


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextmanager
def device_trace(path: str):
    """Capture a torch.profiler trace (CPU + CUDA activities where a card is
    present) and export it as a chrome trace to ``path``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(path)
