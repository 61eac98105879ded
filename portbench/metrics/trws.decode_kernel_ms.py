"""Mean device milliseconds of one launch of the banded decode kernel in the
traced solve: the kernel whose name holds ``banded_decode_kernel``
(stereo_tpu_torch/csrc/banded_decode.cu), one launch a decode.

Where no launch of it is traced (a program that decodes in plain PyTorch,
or another schedule) the metric reads nothing; trws.decode_share still
covers the decode's host time."""

KERNEL = "banded_decode_kernel"


def read(ctx):
    if ctx["kind"] != "simultaneous" or ctx["trace"] is None:
        return None
    times = ctx["trace"].kernels(KERNEL)
    if len(times) == 0:
        return None
    return float(times.mean()) * 1e3
