"""Milliseconds the device is busy a fusion move: the union of the device
operations' intervals in the traced sweep over its moves."""


def read(ctx):
    if ctx["kind"] != "fusion_sweep" or ctx["trace"] is None:
        return None
    moves = sum(j["moves"] for j in ctx["traced"])
    return ctx["trace"].busy_s * 1e3 / moves
