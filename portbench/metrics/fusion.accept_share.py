"""Share of the traced fusion sweep's window that the host spends accepting
moves: the seconds in the program's ``fusion.accept`` spans (the connected
components of the decoded take mask, their energy deltas, the
never-increase backstop) over the window (_spans)."""

from portbench.metrics import _spans


def read(ctx):
    if ctx["kind"] != "fusion_sweep" or ctx["trace"] is None:
        return None
    return _spans.share(ctx["trace"], "fusion.accept")
