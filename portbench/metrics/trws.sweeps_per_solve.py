"""TRW-S sweeps a simultaneous fusion takes to its stopping rule: the
iteration count each solve returns, averaged over the window's solves."""


def read(ctx):
    if ctx["kind"] != "simultaneous":
        return None
    return sum(j["sweeps"] for j in ctx["jobs"]) / len(ctx["jobs"])
