"""How near the traced solve's device time comes to the least time its
sweeps' work needs: sweeps x the least time of one TRW-S sweep at this K, H,
W on the published H100 peaks (_roofline.sweep_bounds) over the device's
busy time in the traced solve.  It names no kernel, so it holds whatever
schedule or kernel runs the sweeps."""

from portbench.metrics import _roofline


def read(ctx):
    if ctx["kind"] != "simultaneous" or ctx["trace"] is None:
        return None
    sweeps = sum(j["sweeps"] for j in ctx["traced"])
    bound = _roofline.sweep_bounds(ctx["K"], ctx["H"] * ctx["W"])["bound_s"]
    return sweeps * bound / ctx["trace"].busy_s
