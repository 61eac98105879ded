"""Tests that need an NVIDIA GPU: the hand-written CUDA kernels against their
plain PyTorch versions, bit for bit in float32, and the solver through them.
A CUDA kernel has no interpret mode, so without a card these skip.

This file imports only the port, so it also runs where the JAX package's
dependencies are missing:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import types

import numpy as np
import pytest
import torch

from stereo_tpu_torch import testing
from stereo_tpu_torch.ops import banded_kernel as t_bk
from stereo_tpu_torch.ops import minplus as t_mp
from stereo_tpu_torch.ops import phase_kernel as t_pk
from stereo_tpu_torch.ops import wavefront_kernel as t_wfk
from stereo_tpu_torch.solvers import banded as t_banded
from stereo_tpu_torch.solvers import trws as t_trws
from stereo_tpu_torch.solvers import wavefront as t_wf

pytestmark = pytest.mark.cuda

COMPACT_ARGS, FULL_ARGS = testing.COMPACT_ARGS, testing.FULL_ARGS


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no interpret mode")
    return torch.device("cuda")


# K not a multiple of a thread's 20 targets or of a staged chunk of 32
# sources, and beyond one pass of a block's 8 x 20 targets (97 is not, 202
# is); a < 0 at a third of the pixels (the kernels' plain-term branch); tol
# with almost every term truncated, and with none
PHASE_SHAPES = [(2, 5, 9), (15, 19, 53), (79, 19, 53), (3, 19, 53),
                (17, 19, 53), (41, 19, 53), (97, 19, 53), (202, 19, 53)]
PHASE_VARIANTS = [(None, False), (None, True), (1e-3, False), (1e6, False)]


@pytest.mark.parametrize("tol,negative", PHASE_VARIANTS)
@pytest.mark.parametrize("kernel", [1, 2])
@pytest.mark.parametrize("K,Hc,W", PHASE_SHAPES)
def test_compact_kernel_bitwise_on_card(cuda, K, Hc, W, kernel, tol,
                                        negative):
    inp = testing.phase_inputs(K, K, Hc, W, np.float32)
    if negative:
        inp = testing.negate_alphas(inp, K)
    tol = 1.1 if tol is None else tol
    args = [torch.as_tensor(inp[k], device=cuda) for k in COMPACT_ARGS]
    before = t_pk.phase_messages_compact.launches
    got = t_pk.phase_messages_compact(*args, tol, kernel)
    torch.cuda.synchronize()
    assert t_pk.phase_messages_compact.launches == before + 1
    ref = t_pk.phase_messages_compact_ref(*args, tol, kernel)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("tol,negative", PHASE_VARIANTS)
@pytest.mark.parametrize("kernel", [1, 2])
@pytest.mark.parametrize("K,H,W", [(2, 9, 10)] + [(K, 37, 53) for K in (
    15, 79, 3, 17, 41, 97, 202)])
def test_full_kernel_bitwise_on_card(cuda, K, H, W, kernel, tol, negative):
    tol = 0.9 if tol is None else tol
    for color in (0, 1):
        inp = testing.phase_inputs_full(K, K, H, W, color, np.float32)
        if negative:
            inp = testing.negate_alphas(inp, K + color)
        args = [torch.as_tensor(inp[k], device=cuda) for k in FULL_ARGS]
        before = t_pk.phase_messages.launches
        got = t_pk.phase_messages(*args, tol, kernel)
        torch.cuda.synchronize()
        assert t_pk.phase_messages.launches == before + 1
        ref = t_pk.phase_messages_ref(*args, tol, kernel)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)


def test_wrapper_raises_on_card_for_bad_input(cuda):
    inp = testing.phase_inputs(0, 3, 4, 5, np.float32)
    args = [torch.as_tensor(inp[k], device=cuda) for k in COMPACT_ARGS]
    bad = list(args)
    bad[2] = bad[2].double()
    with pytest.raises(ValueError, match="float32"):
        t_pk.phase_messages_compact(*bad, 1.0, 1)
    bad = list(args)
    bad[4] = bad[4].cpu()
    with pytest.raises(ValueError, match="expected"):
        t_pk.phase_messages_compact(*bad, 1.0, 1)
    bad = list(args)
    bad[0] = bad[0].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        t_pk.phase_messages_compact(*bad, 1.0, 1)


@pytest.mark.parametrize("compact", [True, False])
def test_solve_on_card_kernel_equals_plain(cuda, compact):
    prob = [torch.as_tensor(a, device=cuda)
            for a in testing.synthetic_problem(8, 37, 53, seed=1)]
    kw = dict(kernel=1, tol=0.02, maxiter=3, max_relgap=0.0, compact=compact)
    got = t_trws.solve(*prob, **kw)
    ref = t_trws.solve(*prob, **kw, use_kernel=False)
    assert torch.equal(got.labels, ref.labels)
    assert torch.equal(got.messages, ref.messages)
    assert float(got.lower_bound) <= float(got.energy)


def test_default_compact_on_card(cuda):
    prob = [torch.as_tensor(a, device=cuda)
            for a in testing.synthetic_problem(4, 9, 10)]
    assert t_trws._Problem(*prob, 1, 1.0, "trws", None, None).compact is True


# ------------------------------------------------ the banded schedule's kernels
@pytest.mark.parametrize("kernel", [1, 2])
@pytest.mark.parametrize("B,K,L", [(1, 2, 53), (2, 15, 96), (2, 79, 53),
                                   (1, 256, 40), (2, 300, 40),
                                   (1, 1000, 33)])  # 1000: global staging
def test_send_kernel_bitwise_on_card(cuda, B, K, L, kernel):
    args = [torch.as_tensor(a, device=cuda)
            for a in testing.send_inputs(K, B, K, L)]
    before = t_mp.minplus_send.launches
    got = t_mp.minplus_send(*args, 1.1, kernel)
    torch.cuda.synchronize()
    assert t_mp.minplus_send.launches == before + 1
    ref = t_mp.minplus_send_ref(*args, 1.1, kernel)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def _banded_problem(cuda, K, H, W, Bh, Bw, kernel):
    prob = [torch.as_tensor(a, device=cuda)
            for a in testing.trws_problem(K + H, K, H, W, np.float32)]
    spec = t_banded.BandedSpec(H, W, Bh, Bw)
    bp = t_banded._BandedProblem(*prob, spec, kernel, 1.0)
    state = t_banded.messages_to_state(
        torch.zeros((4, K, H, W), device=cuda), bp)
    return prob, bp, state


def _clone(state):
    MA, MB, S = state
    return MA.clone(), MB.clone(), tuple(s.clone() for s in S)


@pytest.mark.parametrize("kernel", [1, 2])
@pytest.mark.parametrize("K,H,W,Bh,Bw", [
    (3, 8, 10, 4, 5), (4, 9, 8, 4, 4), (3, 10, 11, 5, 4), (3, 9, 4, 4, 4),
    (3, 4, 9, 4, 3), (3, 6, 5, 6, 5), (15, 40, 47, 8, 16), (9, 13, 11, 2, 2),
    (96, 7, 9, 3, 4),  # 96 labels: one pass of the widest block
    (97, 7, 9, 3, 4), (202, 10, 11, 5, 4)])  # several passes
def test_banded_sweep_kernel_on_card(cuda, K, H, W, Bh, Bw, kernel):
    """Two sweeps (zero, then warm state): messages and seam arrays bit for
    bit, the bound to float32 rounding."""
    _, bp, state = _banded_problem(cuda, K, H, W, Bh, Bw, kernel)
    for _ in range(2):
        ref, lb_ref = t_banded._sweep_steps(bp, _clone(state),
                                            use_kernel=False)
        before = t_bk.sweep_banded.launches
        state, lb = t_bk.sweep_banded(bp, state)
        torch.cuda.synchronize()
        assert t_bk.sweep_banded.launches == before + 1
        assert torch.equal(state[0], ref[0]) and torch.equal(state[1], ref[1])
        for g, r in zip(state[2], ref[2]):
            assert torch.equal(g, r)
        np.testing.assert_allclose(float(lb), float(lb_ref), rtol=1e-5)


@pytest.mark.parametrize("sweep", ["fused", "steps"])
def test_solve_banded_on_card_kernel_equals_plain(cuda, sweep):
    prob = [torch.as_tensor(a, device=cuda)
            for a in testing.synthetic_problem(8, 37, 53, seed=1)]
    kw = dict(kernel=1, tol=0.02, Bh=8, Bw=16, maxiter=3, max_relgap=0.0,
              sweep=sweep)
    got = t_banded.solve_banded(*prob, **kw)
    ref = t_banded.solve_banded(*prob, **kw, use_kernel=False)
    assert torch.equal(got.labels, ref.labels)
    assert torch.equal(got.messages, ref.messages)
    assert float(got.lower_bound) <= float(got.energy)


def test_banded_wrappers_raise_on_card_for_bad_input(cuda):
    prob, bp, state = _banded_problem(cuda, 3, 8, 10, 4, 5, 1)
    MA, MB, S = state
    with pytest.raises(ValueError, match="expected"):
        t_bk.sweep_banded(bp, (MA.cpu(), MB, S))  # a CPU tensor
    with pytest.raises(ValueError, match="float32"):
        t_bk.sweep_banded(bp, (MA.double(), MB, S))
    with pytest.raises(ValueError, match="shape"):
        t_bk.sweep_banded(bp, (MA[:-1].contiguous(), MB, S))
    with pytest.raises(ValueError, match="contiguous"):
        t_bk.sweep_banded(bp, (MA, MB, (S[0].t().contiguous().t(), *S[1:])))
    # 97 labels, once refused: two passes of the targets, bit for bit
    _, wide, wide_state = _banded_problem(cuda, 97, 6, 6, 3, 3, 1)
    ref, _ = t_banded._sweep_steps(wide, _clone(wide_state), use_kernel=False)
    got, _ = t_bk.sweep_banded(wide, wide_state)
    torch.cuda.synchronize()
    assert all(torch.equal(g, r) for g, r in zip(got[:2], ref[:2]))
    assert all(torch.equal(g, r) for g, r in zip(got[2], ref[2]))
    hs, p, r, alpha = [torch.as_tensor(a, device=cuda)
                       for a in testing.send_inputs(0, 2, 3, 40)]
    with pytest.raises(ValueError, match="float32"):
        t_mp.minplus_send(hs, p.double(), r, alpha, 1.0, 1)
    with pytest.raises(ValueError, match="expected"):
        t_mp.minplus_send(hs, p, r.cpu(), alpha, 1.0, 1)
    with pytest.raises(ValueError, match="kernel"):
        t_mp.minplus_send(hs, p, r, alpha, 1.0, 3)


# ------------------------------------------- the min-plus pair kernel
@pytest.mark.parametrize("kernel", [1, 2])
@pytest.mark.parametrize("K,H,W", [(2, 5, 9), (8, 19, 53), (15, 37, 53),
                                   (79, 19, 53), (256, 3, 40),
                                   (300, 3, 40), (1000, 2, 17)])
def test_pair_kernel_bitwise_on_card(cuda, K, H, W, kernel):
    args = [torch.as_tensor(a, device=cuda)
            for a in testing.pair_inputs(K, K, H, W)]
    before = t_mp.minplus_pair.launches
    got = t_mp.minplus_pair(*args, 1.1, kernel)
    torch.cuda.synchronize()
    assert t_mp.minplus_pair.launches == before + 1
    ref = t_mp.minplus_pair_ref(*args, 1.1, kernel)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


# ------------------------------------------- the raster wavefront's kernels
def _wavefront_problem(cuda, K, H, W, kernel):
    prob = [torch.as_tensor(a, device=cuda)
            for a in testing.trws_problem(K + H, K, H, W, np.float32)]
    sk = t_wf._Skewed(*prob, kernel, 1.0)
    M = t_wf.messages_to_groups(torch.zeros((4, K, H, W), device=cuda), W)
    return prob, sk, M


@pytest.mark.parametrize("kernel", [1, 2])
@pytest.mark.parametrize("K,H,W", [
    (3, 6, 9), (4, 7, 6), (3, 40, 9), (3, 9, 40), (3, 2, 9), (3, 9, 2),
    (3, 1, 5), (3, 5, 1), (2, 1, 1), (15, 40, 47),
    (128, 7, 9), (202, 9, 12)])  # beyond one pass of the targets
def test_wavefront_sweep_kernel_on_card(cuda, K, H, W, kernel):
    """Two sweeps (zero, then warm state): messages bit for bit, the bound
    to float32 rounding."""
    _, sk, M = _wavefront_problem(cuda, K, H, W, kernel)
    for _ in range(2):
        ref, lb_ref = t_wf._sweep_steps(sk, tuple(m.clone() for m in M),
                                        use_kernel=False)
        before = t_wfk.sweep_wavefront.launches
        M, lb = t_wfk.sweep_wavefront(sk, M)
        torch.cuda.synchronize()
        assert t_wfk.sweep_wavefront.launches == before + 1
        assert torch.equal(M[0], ref[0]) and torch.equal(M[1], ref[1])
        np.testing.assert_allclose(float(lb), float(lb_ref), rtol=1e-5)


@pytest.mark.parametrize("sweep", ["fused", "steps"])
def test_solve_wavefront_on_card_kernel_equals_plain(cuda, sweep):
    prob = [torch.as_tensor(a, device=cuda)
            for a in testing.synthetic_problem(8, 37, 53, seed=1)]
    kw = dict(kernel=1, tol=0.02, maxiter=3, max_relgap=0.0, sweep=sweep)
    got = t_wf.solve_wavefront(*prob, **kw)
    ref = t_wf.solve_wavefront(*prob, **kw, use_kernel=False)
    assert torch.equal(got.labels, ref.labels)
    assert torch.equal(got.messages, ref.messages)
    assert float(got.lower_bound) <= float(got.energy)


def test_wavefront_and_pair_wrappers_raise_on_card_for_bad_input(cuda):
    _, sk, (MA, MB) = _wavefront_problem(cuda, 3, 6, 9, 1)
    with pytest.raises(ValueError, match="expected"):
        t_wfk.sweep_wavefront(sk, (MA.cpu(), MB))  # a CPU tensor
    with pytest.raises(ValueError, match="float32"):
        t_wfk.sweep_wavefront(sk, (MA.double(), MB))
    with pytest.raises(ValueError, match="shape"):
        t_wfk.sweep_wavefront(sk, (MA[:-1].contiguous(), MB))
    with pytest.raises(ValueError, match="contiguous"):
        t_wfk.sweep_wavefront(
            sk, (MA, MB.transpose(2, 3).contiguous().transpose(2, 3)))
    # 129 labels, once refused: three passes of the targets, bit for bit
    _, wide, wide_M = _wavefront_problem(cuda, 129, 4, 5, 1)
    ref, _ = t_wf._sweep_steps(wide, tuple(m.clone() for m in wide_M),
                               use_kernel=False)
    got, _ = t_wfk.sweep_wavefront(wide, wide_M)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    # no pixel, T = 0: such a problem cannot be built, so a stand-in
    empty = types.SimpleNamespace(theta=MA, K=3, H=0, W=1, T=0, device=cuda)
    with pytest.raises(ValueError, match="at least"):
        t_wfk.sweep_wavefront(empty, (MA, MB))
    args = [torch.as_tensor(a, device=cuda)
            for a in testing.pair_inputs(0, 3, 4, 5)]
    bad = list(args)
    bad[2] = bad[2].double()
    with pytest.raises(ValueError, match="float32"):
        t_mp.minplus_pair(*bad, 1.0, 1)
    bad = list(args)
    bad[4] = bad[4].cpu()
    with pytest.raises(ValueError, match="expected"):
        t_mp.minplus_pair(*bad, 1.0, 1)
    bad = list(args)
    bad[0] = bad[0].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        t_mp.minplus_pair(*bad, 1.0, 1)
    with pytest.raises(ValueError, match="kernel"):
        t_mp.minplus_pair(*args, 1.0, 3)
    # 257 labels, once refused: several passes, bit for bit
    wide = [torch.as_tensor(a, device=cuda)
            for a in testing.pair_inputs(1, 257, 2, 3)]
    got = t_mp.minplus_pair(*wide, 1.0, 1)
    ref = t_mp.minplus_pair_ref(*wide, 1.0, 1)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    wide = [torch.as_tensor(a, device=cuda)
            for a in testing.send_inputs(1, 1, 257, 40)]
    got = t_mp.minplus_send(*wide, 1.0, 1)
    ref = t_mp.minplus_send_ref(*wide, 1.0, 1)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
