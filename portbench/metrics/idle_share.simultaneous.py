"""Share of the traced simultaneous fusion solve in which the device ran
nothing: 1 - (union of the device operations' intervals) / (the traced
window on the host's clock).  From torch.profiler's trace."""


def read(ctx):
    if ctx["kind"] != "simultaneous" or ctx["trace"] is None:
        return None
    return ctx["trace"].idle_share
