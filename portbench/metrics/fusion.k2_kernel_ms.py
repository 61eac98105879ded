"""Mean device milliseconds of one launch of the K = 2 block kernel in the
traced fusion sweep: the kernel whose name holds ``k2_block_kernel``
(stereo_tpu_torch/csrc/k2_block.cu), one launch a block of phase pairs with
its bound, decode and energy.

Where no launch of it is traced (a program that runs the block in plain
PyTorch) the metric reads nothing; fusion.k2_share still covers the block's
host time."""

KERNEL = "k2_block_kernel"


def read(ctx):
    if ctx["kind"] != "fusion_sweep" or ctx["trace"] is None:
        return None
    times = ctx["trace"].kernels(KERNEL)
    if len(times) == 0:
        return None
    return float(times.mean()) * 1e3
