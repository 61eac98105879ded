"""Share of its roofline that the fused banded sweep kernel reaches, in %:
the least time of one TRW-S sweep at this K, H, W on the published H100
peaks (_roofline.sweep_bounds) over the mean device time of one launch of
the kernel whose name holds ``banded_sweep_kernel`` in the traced solve.

The name is the program's (stereo_tpu_torch/csrc/banded_kernel.cu).  Where
no launch of it is traced (another schedule runs the sweeps) the metric
reads nothing; trws.sweep_bound_share, which names no kernel, still bounds
the solve."""

from portbench.metrics import _roofline

KERNEL = "banded_sweep_kernel"


def read(ctx):
    if ctx["kind"] != "simultaneous" or ctx["trace"] is None:
        return None
    times = ctx["trace"].kernels(KERNEL)
    if len(times) == 0:
        return None
    bound = _roofline.sweep_bounds(ctx["K"], ctx["H"] * ctx["W"])["bound_s"]
    return 100.0 * bound / float(times.mean())
