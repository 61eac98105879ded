"""The program's spans in a traced window: host records that the program
opens around its phases, named ``<layer>.<phase>`` (``trws.decode``,
``fusion.k2_stop``, ...), flat (none inside another) and on the profiler's
own clock, so their seconds add up.  A trace that holds no such record at
all (a program that opens no spans) reads None, not 0."""

from __future__ import annotations

# the layers whose phases the program marks
LAYERS = ("trws.", "fusion.")


def _spans(trace):
    """{name: (seconds, count)} of the trace's program spans, or None where
    it holds none."""
    sums: dict[str, tuple[float, int]] = {}
    for i, name in enumerate(trace.host_name):
        if name.startswith(LAYERS):
            s, n = sums.get(name, (0.0, 0))
            dt = float(trace.host_end[i] - trace.host_start[i]) * 1e-9
            sums[name] = (s + dt, n + 1)
    return sums or None


def share(trace, *names: str) -> float | None:
    """Seconds in the spans of ``names`` over the traced window's."""
    sums = _spans(trace)
    if sums is None:
        return None
    return sum(sums.get(n, (0.0, 0))[0] for n in names) / trace.window_s


def count(trace, name: str) -> int | None:
    """How many spans of ``name`` the trace holds."""
    sums = _spans(trace)
    if sums is None:
        return None
    return sums.get(name, (0.0, 0))[1]
