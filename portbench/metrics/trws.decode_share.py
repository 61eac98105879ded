"""Share of the traced solve's window that the host spends decoding: the
seconds in the program's ``trws.decode`` spans (each greedy decode of the
message state, with its energy) over the window (_spans)."""

from portbench.metrics import _spans


def read(ctx):
    if ctx["kind"] != "simultaneous" or ctx["trace"] is None:
        return None
    return _spans.share(ctx["trace"], "trws.decode")
