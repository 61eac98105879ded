"""Greedy decodes a traced solve makes: the program's ``trws.decode`` spans
in the trace over the traced solves (_spans)."""

from portbench.metrics import _spans


def read(ctx):
    if ctx["kind"] != "simultaneous" or ctx["trace"] is None:
        return None
    n = _spans.count(ctx["trace"], "trws.decode")
    return None if n is None else n / len(ctx["traced"])
