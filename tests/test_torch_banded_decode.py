"""The banded decode's wrapper (ops/banded_decode.py) and its dispatch in
solvers/banded.py, on the CPU: a CPU problem takes the plain version
(``_decode_state``), bit for bit, and ``use_kernel=False`` keeps it on every
device.  The kernel itself (csrc/banded_decode.cu) is held to the plain
version on the card in tests/test_torch_cuda.py.  No JAX call: the plain
version is held to the JAX package in tests/test_torch_banded.py."""

import os
import re

import numpy as np
import pytest
import torch

from stereo_tpu_torch import testing
from stereo_tpu_torch.ops import banded_decode as t_bd
from stereo_tpu_torch.ops import banded_kernel as t_bk
from stereo_tpu_torch.solvers import banded as t_banded

torch.set_num_threads(1)

def _problem(K, H, W, Bh, Bw, kernel):
    prob = [torch.as_tensor(a)
            for a in testing.trws_problem(K + H, K, H, W, np.float32)]
    bp = t_banded._BandedProblem(*prob, t_banded.BandedSpec(H, W, Bh, Bw),
                                 kernel, 1.0)
    return prob, bp


def _warm(bp, sweeps):
    K, H, W = bp.K, bp.spec.H, bp.spec.W
    state = t_banded.messages_to_state(
        torch.zeros((4, K, H, W), dtype=bp.dtype), bp)
    for _ in range(sweeps):
        state, _ = t_banded._sweep_steps(bp, state, use_kernel=False)
    return state


def test_cpu_problem_takes_the_plain_decode():
    """decode_banded on a CPU problem is _decode_state (a delegation, so one
    ragged layout holds it): the same labels and energy, to the bit, from
    zero messages and from a warm state; no kernel launch is counted."""
    _, bp = _problem(4, 7, 9, 3, 4, 1)
    before = t_bd.decode_banded.launches
    for sweeps in (0, 2):
        state = _warm(bp, sweeps)
        labels, energy = t_bd.decode_banded(bp, state)
        ref, e_ref = t_banded._decode_state(bp, state)
        assert labels.dtype == torch.int32 and torch.equal(labels, ref)
        assert energy.dtype == e_ref.dtype and torch.equal(energy, e_ref)
    assert t_bd.decode_banded.launches == before


class _Spy:
    """Counts the calls of a module function, passing them on."""

    def __init__(self, monkeypatch, module, name):
        self.calls, fn = 0, getattr(module, name)

        def spy(*args, **kwargs):
            self.calls += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("sweep", ["fused", "steps"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_solve_banded_decodes_through_the_dispatch(monkeypatch, use_kernel,
                                                   sweep):
    """solve_banded decodes once a check: through decode_banded with
    use_kernel (which takes _decode_state for a CPU problem), straight
    through _decode_state without; the result is the same either way."""
    prob, _ = _problem(5, 9, 11, 4, 5, 1)
    plain = _Spy(monkeypatch, t_banded, "_decode_state")
    wrapper = _Spy(monkeypatch, t_bd, "decode_banded")
    res = t_banded.solve_banded(*prob, kernel=1, tol=1.0, Bh=4, Bw=5,
                                maxiter=6, max_relgap=0.0, check_every=2,
                                use_kernel=use_kernel, sweep=sweep)
    assert res.iterations == 6
    assert plain.calls == 3
    assert wrapper.calls == (3 if use_kernel else 0)
    monkeypatch.undo()
    ref = t_banded.solve_banded(*prob, kernel=1, tol=1.0, Bh=4, Bw=5,
                                maxiter=6, max_relgap=0.0, check_every=2,
                                use_kernel=not use_kernel, sweep=sweep)
    assert torch.equal(res.labels, ref.labels)
    assert torch.equal(res.energy, ref.energy)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_banded_run_decodes_through_the_dispatch(monkeypatch, use_kernel):
    """BandedRun.run's banded decode: decode_banded with use_kernel, plain
    _decode_state without, once every decode_every sweeps; the raster
    decode reaches neither."""
    prob, _ = _problem(4, 8, 10, 4, 5, 2)
    plain = _Spy(monkeypatch, t_banded, "_decode_state")
    wrapper = _Spy(monkeypatch, t_bd, "decode_banded")
    run = t_banded.BandedRun(*prob, kernel=2, tol=1.0, Bh=4, Bw=5,
                             use_kernel=use_kernel)
    run.run(run.init_state(), 4, 2)
    assert plain.calls == 2 and wrapper.calls == (2 if use_kernel else 0)
    raster = t_banded.BandedRun(*prob, kernel=2, tol=1.0, Bh=4, Bw=5,
                                use_kernel=use_kernel, decode="raster")
    raster.run(raster.init_state(), 2, 1)
    assert plain.calls == 2 and wrapper.calls == (2 if use_kernel else 0)


def test_pointer_order_matches_the_kernel_source():
    """The wrapper hands the kernel its pointers in the order of
    csrc/banded_decode.cu's ``enum Ptr``: the problem's arrays, the state's,
    then the scratch and the outputs."""
    src = os.path.join(os.path.dirname(t_bd.__file__), os.pardir, "csrc",
                       "banded_decode.cu")
    with open(src) as f:
        body = re.search(r"enum Ptr \{(.*?)\};", f.read(), re.S).group(1)
    enum = [n.strip() for n in body.replace("\n", " ").split(",")]
    names = (t_bd.PROBLEM_F32 + t_bd.PROBLEM_MASKS + t_bd.STATE
             + ("sols", "eacc", "labels", "energy"))
    assert enum[-1] == "P_COUNT"
    assert enum[:-1] == ["P_" + n.upper() for n in names]


def test_decode_bytes_and_shapes():
    """The bytes bound counts eight K-planes and 16 scalars a real pixel;
    every array the wrapper checks has a shape in problem_shapes."""
    assert t_bd.decode_bytes(79, 375 * 450) == 375 * 450 * (8 * 79 + 16) * 4
    shapes = t_bk.problem_shapes(t_banded.BandedSpec(7, 9, 3, 4), 5)
    for name in t_bd.PROBLEM_F32 + t_bd.PROBLEM_MASKS + t_bd.STATE:
        assert name in shapes
