"""Device kernels launched a fusion move: the kernels in the traced sweep's
trace (copies and sets left out) over its moves."""


def read(ctx):
    if ctx["kind"] != "fusion_sweep" or ctx["trace"] is None:
        return None
    moves = sum(j["moves"] for j in ctx["traced"])
    return len(ctx["trace"].kernels()) / moves
