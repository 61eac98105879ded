"""The reader of fusion.k2_kernel_ms on hand-built traces: the mean device
time of the K = 2 block kernel's launches, nothing where the trace holds
none (a program that runs the block in plain PyTorch), nothing for the
other job kind or without a trace."""

import numpy as np
import pytest

from portbench import harness
from portbench.metrics import _trace

# device (name, start, end) in ns: two blocks of one move, a plain op, a
# copy; host: one record
DEV = [("(anonymous namespace)::k2_block_kernel(Params)", 0, 70),
       ("void at::native::elementwise_kernel<128, 2>", 80, 90),
       ("(anonymous namespace)::k2_block_kernel(Params)", 100, 190),
       ("Memcpy DtoH", 190, 191)]
HOST = [("fusion.k2_sweeps", 0, 100, 1)]


def _trace_of(dev, window_s=300e-9):
    def cols(rows):
        return ([r[0] for r in rows],) + tuple(
            np.array([r[i] for r in rows], np.int64)
            for i in range(1, len(rows[0])))
    return _trace.Trace(cols(dev), cols(HOST), window_s)


def _ctx(kind, dev):
    return dict(kind=kind, trace=_trace_of(dev), traced=[dict(moves=2)],
                jobs=[dict(moves=2)], H=375, W=450)


def _read(ctx):
    return harness.metric_reader("fusion.k2_kernel_ms")(ctx)


def test_mean_launch_in_ms():
    assert _read(_ctx("fusion_sweep", DEV)) == pytest.approx(8e-5)


def test_nothing_without_the_kernel():
    plain = [r for r in DEV if "k2_block" not in r[0]]
    assert _read(_ctx("fusion_sweep", plain)) is None


@pytest.mark.parametrize("ctx", [
    dict(_ctx("simultaneous", DEV)), dict(_ctx("fusion_sweep", DEV),
                                          trace=None)])
def test_nothing_for_the_other_kind_or_untraced(ctx):
    assert _read(ctx) is None
