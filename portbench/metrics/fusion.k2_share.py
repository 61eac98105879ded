"""Share of the traced fusion sweep's window that the host spends in the
moves' K = 2 TRW-S: the seconds in the program's ``fusion.k2_sweeps`` spans
(a block of phase pairs with its bound, decode and energy) and
``fusion.k2_stop`` spans (the stopping test, where the host waits for the
device) over the window (_spans)."""

from portbench.metrics import _spans


def read(ctx):
    if ctx["kind"] != "fusion_sweep" or ctx["trace"] is None:
        return None
    return _spans.share(ctx["trace"], "fusion.k2_sweeps", "fusion.k2_stop")
