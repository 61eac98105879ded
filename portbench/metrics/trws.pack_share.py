"""Share of the traced solve's window that the host spends packing: the
seconds in the program's ``trws.pack`` spans (the stacks of the labels and
their unaries, the pairwise positions, the schedule's problem and message
layouts) over the window (_spans)."""

from portbench.metrics import _spans


def read(ctx):
    if ctx["kind"] != "simultaneous" or ctx["trace"] is None:
        return None
    return _spans.share(ctx["trace"], "trws.pack")
