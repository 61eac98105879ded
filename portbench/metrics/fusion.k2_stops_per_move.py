"""Stopping tests of the K = 2 TRW-S a fusion move makes, each a wait of the
host for the device: the program's ``fusion.k2_stop`` spans in the traced
sweep over its moves (_spans)."""

from portbench.metrics import _spans


def read(ctx):
    if ctx["kind"] != "fusion_sweep" or ctx["trace"] is None:
        return None
    n = _spans.count(ctx["trace"], "fusion.k2_stop")
    if n is None:
        return None
    return n / sum(j["moves"] for j in ctx["traced"])
