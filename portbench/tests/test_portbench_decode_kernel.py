"""The reader of trws.decode_kernel_ms on hand-built traces: the mean
device time of the decode kernel's launches, nothing where the trace holds
none (a program that decodes in plain PyTorch), nothing for the other job
kind or without a trace."""

import numpy as np
import pytest

from portbench import harness
from portbench.metrics import _trace

# device (name, start, end) in ns: two sweeps, two decodes, a copy and a
# plain op; host: one record
DEV = [("void banded_sweep_kernel<1, true>(Params)", 0, 100),
       ("void banded_decode_kernel<1>(Params)", 100, 103),
       ("Memcpy DtoH", 103, 104),
       ("void banded_sweep_kernel<1, true>(Params)", 110, 210),
       ("void banded_decode_kernel<1>(Params)", 210, 215),
       ("void at::native::elementwise_kernel<128, 2>", 220, 230)]
HOST = [("trws.decode", 100, 105, 1)]


def _trace_of(dev, window_s=300e-9):
    def cols(rows):
        return ([r[0] for r in rows],) + tuple(
            np.array([r[i] for r in rows], np.int64)
            for i in range(1, len(rows[0])))
    return _trace.Trace(cols(dev), cols(HOST), window_s)


def _ctx(kind, dev):
    return dict(kind=kind, trace=_trace_of(dev), traced=[dict(sweeps=2)],
                jobs=[dict(sweeps=2)], K=79, H=375, W=450)


def _read(ctx):
    return harness.metric_reader("trws.decode_kernel_ms")(ctx)


def test_mean_launch_in_ms():
    assert _read(_ctx("simultaneous", DEV)) == pytest.approx(4e-6)


def test_nothing_without_the_kernel():
    plain = [r for r in DEV if "decode" not in r[0]]
    assert _read(_ctx("simultaneous", plain)) is None


@pytest.mark.parametrize("ctx", [
    dict(_ctx("fusion_sweep", DEV)), dict(_ctx("simultaneous", DEV),
                                          trace=None)])
def test_nothing_for_the_other_kind_or_untraced(ctx):
    assert _read(ctx) is None
