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
from stereo_tpu_torch.ops import banded_decode as t_bd
from stereo_tpu_torch.ops import banded_kernel as t_bk
from stereo_tpu_torch.ops import minplus as t_mp
from stereo_tpu_torch.ops import phase_kernel as t_pk
from stereo_tpu_torch.ops import wavefront_kernel as t_wfk
from stereo_tpu_torch.solvers import banded as t_banded
from stereo_tpu_torch.solvers import scanline as t_scan
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


# narrow message storage: K in one pass and in several (202: the earlier
# passes parked in float32 scratch), a < 0 on a third of the pixels
NARROW_SHAPES = [(2, 5, 9), (15, 19, 53), (79, 19, 53), (202, 19, 53)]


@pytest.mark.parametrize("negative", [False, True])
@pytest.mark.parametrize("kernel", [1, 2])
@pytest.mark.parametrize("K,Hc,W", NARROW_SHAPES)
@pytest.mark.parametrize("m_dtype", [torch.bfloat16, torch.float16])
def test_narrow_storage_kernels_bitwise_on_card(cuda, m_dtype, K, Hc, W,
                                                kernel, negative):
    """Both phase kernels with messages stored in ``m_dtype`` against their
    plain versions, bit for bit: the new messages in ``m_dtype``, the
    minima float32."""
    inp = testing.phase_inputs(K, K, Hc, W, np.float32)
    if negative:
        inp = testing.negate_alphas(inp, K)
    args = [torch.as_tensor(inp[k], device=cuda) for k in COMPACT_ARGS]
    args[2], args[3] = args[2].to(m_dtype), args[3].to(m_dtype)
    got = t_pk.phase_messages_compact(*args, 1.1, kernel)
    torch.cuda.synchronize()
    ref = t_pk.phase_messages_compact_ref(*args, 1.1, kernel)
    assert [g.dtype for g in got] == [m_dtype] * 2 + [torch.float32] * 2
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    for color in (0, 1):
        inp = testing.phase_inputs_full(K, K, 2 * Hc - 1, W, color,
                                        np.float32)
        if negative:
            inp = testing.negate_alphas(inp, K + color)
        args = [torch.as_tensor(inp[k], device=cuda) for k in FULL_ARGS]
        args[2] = args[2].to(m_dtype)
        got = t_pk.phase_messages(*args, 0.9, kernel)
        torch.cuda.synchronize()
        ref = t_pk.phase_messages_ref(*args, 0.9, kernel)
        assert got[0].dtype == m_dtype
        for g, r in zip(got, ref):
            assert torch.equal(g, r)


def test_wrapper_refuses_storage_on_card(cuda):
    """Mixed M_s / M_o dtypes and a storage dtype no kernel instantiates
    (float64) raise before any launch; there is no plain fallback."""
    inp = testing.phase_inputs(0, 3, 4, 5, np.float32)
    args = [torch.as_tensor(inp[k], device=cuda) for k in COMPACT_ARGS]
    before = t_pk.phase_messages_compact.launches
    bad = list(args)
    bad[2] = bad[2].to(torch.bfloat16)
    with pytest.raises(ValueError, match="one dtype"):
        t_pk.phase_messages_compact(*bad, 1.0, 1)
    bad[3] = bad[3].to(torch.bfloat16)
    bad[0] = bad[0].to(torch.bfloat16)  # only the messages may be narrow
    with pytest.raises(ValueError, match="float32"):
        t_pk.phase_messages_compact(*bad, 1.0, 1)
    bad = list(args)
    bad[2], bad[3] = bad[2].double(), bad[3].double()
    with pytest.raises(ValueError, match="no CUDA kernel stores"):
        t_pk.phase_messages_compact(*bad, 1.0, 1)
    full = testing.phase_inputs_full(0, 3, 7, 5, 0, np.float32)
    fargs = [torch.as_tensor(full[k], device=cuda) for k in FULL_ARGS]
    fargs[2] = fargs[2].double()
    with pytest.raises(ValueError, match="no CUDA kernel stores"):
        t_pk.phase_messages(*fargs, 1.0, 1)
    assert t_pk.phase_messages_compact.launches == before


@pytest.mark.parametrize("compact", [True, False])
def test_solve_bf16_on_card_kernel_equals_plain(cuda, compact):
    prob = [torch.as_tensor(a, device=cuda)
            for a in testing.synthetic_problem(8, 37, 53, seed=2)]
    kw = dict(kernel=1, tol=0.02, maxiter=4, max_relgap=0.0,
              compact=compact, message_dtype=torch.bfloat16)
    got = t_trws.solve(*prob, **kw)
    ref = t_trws.solve(*prob, **kw, use_kernel=False)
    assert got.messages.dtype == torch.bfloat16
    assert torch.equal(got.labels, ref.labels)
    assert torch.equal(got.messages, ref.messages)
    assert float(got.lower_bound) <= float(got.energy)


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


# a banded step's six problems and a wavefront step's two, gathered in one
# launch: one block a tile (teddy's L = 1536 banded, K = 79 and 202) and a
# tile split over a cluster (few tiles: L = 53, and the wavefront step at
# L = 375); K beyond one thread's targets, one pass and shared memory's old
# staging limit; a < 0 at a third of the lanes; tol with almost every term
# truncated, and with none
SEND_STEPS = [("banded", 79, 1536), ("banded", 202, 1536),
              ("wavefront", 79, 375)] + [
    (sched, K, 53) for sched in ("banded", "wavefront")
    for K in (1, 3, 17, 41, 97, 1000)]


@pytest.mark.parametrize("tol,negative", PHASE_VARIANTS)
@pytest.mark.parametrize("kernel", [1, 2])
@pytest.mark.parametrize("schedule,K,L", SEND_STEPS)
def test_send_many_bitwise_on_card(cuda, schedule, K, L, kernel, tol,
                                   negative):
    problems = testing.send_step_problems(
        K + L, K, L, schedule, Lp=L if L > 100 else 96,
        negative=1 / 3 if negative else 0.0,
        to=lambda a: torch.as_tensor(a, device=cuda))
    tol = 1.1 if tol is None else tol
    before = t_mp.minplus_send.launches
    got = t_mp.minplus_send_many(problems, tol, kernel)
    torch.cuda.synchronize()
    assert t_mp.minplus_send.launches == before + 1
    ref = t_mp.minplus_send_many_ref(problems, tol, kernel)
    for g, r in zip(got, ref):
        assert torch.equal(g[0], r[0]) and torch.equal(g[1], r[1])


def test_send_many_raises_on_card_for_bad_input(cuda):
    problems = testing.send_step_problems(
        0, 3, 40, "banded", to=lambda a: torch.as_tensor(a, device=cuda))
    g, m, xt, ys, alpha = problems[2]
    with pytest.raises(ValueError, match="float32"):
        t_mp.minplus_send_many([(g, m.double(), xt, ys, alpha)], 1.0, 1)
    with pytest.raises(ValueError, match="expected"):
        t_mp.minplus_send_many([(g, m, xt.cpu(), ys, alpha)], 1.0, 1)
    with pytest.raises(ValueError, match="shape"):
        t_mp.minplus_send_many([(g, m, xt, ys, alpha[:-1])], 1.0, 1)
    with pytest.raises(ValueError, match="problems"):
        t_mp.minplus_send_many(problems + problems[:3], 1.0, 1)


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


# ------------------------------------------- the banded decode kernel
def _warm_state(bp, state, sweeps):
    for _ in range(sweeps):
        state, _ = t_bk.sweep_banded(bp, state)
    return state


# the decode kernel sums the energy per lane in double, the plain version in
# float32 (teddy K = 79 reads about 3e-7 apart)
DECODE_RTOL = 1e-6


def _decode_both(bp, state):
    """The kernel's and the plain version's decode of one state: labels
    bit for bit, the energy to float32 rounding; one launch."""
    before = t_bd.decode_banded.launches
    got, e = t_bd.decode_banded(bp, state)
    torch.cuda.synchronize()
    assert t_bd.decode_banded.launches == before + 1
    ref, e_ref = t_banded._decode_state(bp, state)
    assert got.dtype == torch.int32 and got.shape == ref.shape
    assert torch.equal(got, ref)
    np.testing.assert_allclose(float(e), float(e_ref), rtol=DECODE_RTOL)


@pytest.mark.parametrize("kernel", [1, 2])
@pytest.mark.parametrize("K,H,W,Bh,Bw", [
    (2, 9, 10, 4, 5), (15, 40, 47, 8, 16), (15, 37, 53, 16, 8),
    (79, 21, 23, 5, 4), (202, 10, 11, 5, 4), (1000, 6, 7, 3, 4),
    (2, 5, 7, 2, 2), (15, 6, 5, 2, 2), (79, 3, 4, 2, 2)])  # T = 3
def test_banded_decode_kernel_on_card(cuda, K, H, W, Bh, Bw, kernel):
    """The decode kernel against _decode_state from zero messages and after
    one and three sweeps: ragged rows and columns, Bh != Bw both ways,
    T = 3, K beyond every pass of the sweep's block and beyond its shared
    memory (1000)."""
    _, bp, state = _banded_problem(cuda, K, H, W, Bh, Bw, kernel)
    _decode_both(bp, state)
    state = _warm_state(bp, state, 1)
    _decode_both(bp, state)
    _decode_both(bp, _warm_state(bp, state, 2))


@pytest.mark.parametrize("K", [2, 15, 79])
def test_banded_decode_ties_go_to_the_lowest_label(cuda, K):
    """Equal unaries in pairs, positions the same for every label, zero
    messages: every pixel's conditioned terms tie and the lowest label
    among the smallest unaries wins, as torch.argmin."""
    H, W = 19, 23
    theta, D0, Q, alphas = testing.trws_problem(K, K, H, W, np.float32)
    theta = np.floor(theta / 2.5).astype(np.float32)  # 0 or 1: many ties
    D0 = np.broadcast_to(D0[:1], D0.shape).copy()
    Q = np.broadcast_to(Q[:, :1], Q.shape).copy()
    prob = [torch.as_tensor(a, device=cuda) for a in (theta, D0, Q, alphas)]
    bp = t_banded._BandedProblem(*prob, t_banded.BandedSpec(H, W, 4, 8), 1,
                                 1.0)
    state = t_banded.messages_to_state(
        torch.zeros((4, K, H, W), device=cuda), bp)
    _decode_both(bp, state)
    got, _ = t_bd.decode_banded(bp, state)
    first = torch.as_tensor(np.argmin(theta, axis=0), device=cuda)
    assert torch.equal(got.long(), first)


def test_solve_banded_decodes_once_a_check_on_card(cuda):
    """A teddy-shaped solve of 192 sweeps with a check every 8: one decode
    launch a check, 24 in all, beside 192 sweep launches; labels and
    energy those of the plain decode."""
    K, H, W = 79, 375, 450
    prob = [torch.as_tensor(a, device=cuda)
            for a in testing.synthetic_problem(K, H, W, seed=3)]
    kw = dict(kernel=1, tol=8.0, Bh=128, Bw=128, maxiter=192,
              max_relgap=0.0, check_every=8)
    sweeps, decodes = t_bk.sweep_banded.launches, t_bd.decode_banded.launches
    got = t_banded.solve_banded(*prob, **kw)
    torch.cuda.synchronize()
    assert got.iterations == 192
    assert t_bk.sweep_banded.launches - sweeps == 192
    assert t_bd.decode_banded.launches - decodes == 24
    bp = t_banded._BandedProblem(*prob, t_banded.BandedSpec(H, W, 128, 128),
                                 1, 8.0)
    ref, e_ref = t_banded._decode_state(
        bp, t_banded.messages_to_state(got.messages, bp))
    assert torch.equal(got.labels, ref)
    np.testing.assert_allclose(float(got.energy), float(e_ref),
                               rtol=DECODE_RTOL)


def test_banded_run_incumbent_kernel_equals_plain_on_card(cuda):
    """A warm-started BandedRun.run with a decode every 2 sweeps: the same
    incumbent labels and energy through the decode kernel as through the
    plain decode, one launch a decode."""
    K, H, W = 15, 37, 53
    prob = [torch.as_tensor(a, device=cuda)
            for a in testing.synthetic_problem(K, H, W, seed=2)]
    kw = dict(kernel=1, tol=0.5, Bh=8, Bw=16)
    warm = t_banded.solve_banded(*prob, **kw, maxiter=3, max_relgap=0.0,
                                 use_kernel=False).messages
    out = {}
    for use_kernel in (True, False):
        run = t_banded.BandedRun(*prob, **kw, use_kernel=use_kernel)
        before = t_bd.decode_banded.launches
        _, bestE, lb, bestL = run.run(run.init_state(warm), 6, 2)
        torch.cuda.synchronize()
        assert t_bd.decode_banded.launches - before == (3 if use_kernel
                                                        else 0)
        out[use_kernel] = (bestE, lb, bestL)
    assert torch.equal(out[True][2], out[False][2])
    np.testing.assert_allclose(float(out[True][0]), float(out[False][0]),
                               rtol=DECODE_RTOL)
    np.testing.assert_allclose(float(out[True][1]), float(out[False][1]),
                               rtol=1e-5)


def test_banded_decode_raises_on_card_for_bad_input(cuda):
    _, bp, state = _banded_problem(cuda, 3, 8, 10, 4, 5, 1)
    MA, MB, S = state
    with pytest.raises(ValueError, match="expected"):
        t_bd.decode_banded(bp, (MA.cpu(), MB, S))
    with pytest.raises(ValueError, match="float32"):
        t_bd.decode_banded(bp, (MA, MB.double(), S))
    with pytest.raises(ValueError, match="shape"):
        t_bd.decode_banded(bp, (MA, MB, (S[0][:-1].contiguous(), *S[1:])))
    prob = [torch.as_tensor(a, device=cuda)
            for a in testing.trws_problem(1, 3, 8, 10, np.float32)]
    stripe = t_banded._BandedProblem(*prob, bp.spec, 1, 1.0,
                                     stripe=(0, 16, False, True))
    with pytest.raises(ValueError, match="stripe"):
        t_bd.decode_banded(stripe, state)


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


@pytest.mark.parametrize("tol,negative", PHASE_VARIANTS[1:])
@pytest.mark.parametrize("kernel", [1, 2])
@pytest.mark.parametrize("K,H,W", [(3, 19, 53), (17, 19, 53), (79, 19, 53),
                                   (202, 5, 53)])
def test_pair_kernel_hoist_cases_on_card(cuda, K, H, W, kernel, tol,
                                         negative):
    """a < 0 at a third of the pixels (the plain-term branch) and tol with
    almost every term truncated, and with none."""
    inp = list(testing.pair_inputs(K, K, H, W))
    if negative:
        flip = np.random.default_rng(K).uniform(size=(H, W)) < 1 / 3
        inp[4] = np.where(flip, -inp[4], inp[4]).astype(np.float32)
    args = [torch.as_tensor(a, device=cuda) for a in inp]
    tol = 1.1 if tol is None else tol
    got = t_mp.minplus_pair(*args, tol, kernel)
    torch.cuda.synchronize()
    ref = t_mp.minplus_pair_ref(*args, tol, kernel)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def _negate_third(prob, seed):
    """The problem with the weights of a third of the pixels negated: their
    lanes walk the plain term, the others the hoisted one."""
    theta, D0, Q, alphas = prob
    rng = np.random.default_rng(seed)
    flip = torch.as_tensor(rng.uniform(0, 1, alphas.shape[1:]) < 1 / 3,
                           device=alphas.device)
    return theta, D0, Q, torch.where(flip[None], -alphas, alphas)


@pytest.mark.parametrize("negative", [False, True])
@pytest.mark.parametrize("width", [0, 32, 16, 8])
@pytest.mark.parametrize("K,H,W,Bh,Bw", [
    (3, 8, 10, 4, 5), (15, 40, 47, 8, 16), (15, 96, 128, 32, 32),
    (97, 48, 40, 8, 8), (202, 10, 11, 5, 4)])
def test_banded_sweep_widths_on_card(cuda, K, H, W, Bh, Bw, width,
                                     negative):
    """Each phase-B job width, forced (32, 16, 8) and chosen a step (0),
    from one state as the plain sweep: messages and seam arrays bit for
    bit, the bound to float32 rounding; both smoothness kernels, two
    sweeps."""
    for kernel in (1, 2):
        prob, bp, state = _banded_problem(cuda, K, H, W, Bh, Bw, kernel)
        if negative:
            bp = t_banded._BandedProblem(*_negate_third(prob, K + H),
                                         bp.spec, kernel, 1.0)
        for _ in range(2):
            ref, lb_ref = t_banded._sweep_steps(bp, _clone(state),
                                                use_kernel=False)
            state, lb = t_bk.sweep_banded(bp, _clone(state), width)
            torch.cuda.synchronize()
            for g, r in zip((state[0], state[1], *state[2]),
                            (ref[0], ref[1], *ref[2])):
                assert torch.equal(g, r)
            np.testing.assert_allclose(float(lb), float(lb_ref), rtol=1e-5)


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


@pytest.mark.parametrize("negative", [False, True])
@pytest.mark.parametrize("width", [0, 32, 16, 8])
@pytest.mark.parametrize("K,H,W", [(3, 40, 9), (15, 40, 47), (79, 70, 33),
                                   (128, 7, 9), (202, 9, 40)])
def test_wavefront_sweep_widths_on_card(cuda, K, H, W, width, negative):
    """Each phase-B job width, forced (32, 16, 8) and chosen a step (0),
    from one state as the plain sweep: messages bit for bit, the bound to
    float32 rounding; both smoothness kernels, two sweeps."""
    for kernel in (1, 2):
        prob, sk, M = _wavefront_problem(cuda, K, H, W, kernel)
        if negative:
            sk = t_wf._Skewed(*_negate_third(prob, K + H), kernel, 1.0)
        for _ in range(2):
            ref, lb_ref = t_wf._sweep_steps(sk, tuple(m.clone() for m in M),
                                            use_kernel=False)
            M, lb = t_wfk.sweep_wavefront(sk, tuple(m.clone() for m in M),
                                          width)
            torch.cuda.synchronize()
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


@pytest.mark.parametrize("kernel", [1, 2])
@pytest.mark.parametrize("K,H,W", [(8, 37, 53), (15, 9, 70), (79, 6, 40)])
def test_solve_scanline_on_card_kernel_equals_plain(cuda, K, H, W, kernel):
    """The scanline sweeps through kernel 4 (four launches a row) against
    the plain version of the same calls: messages, labels and energy bit
    for bit, the bound to float32 rounding; from zero and warm messages."""
    prob = [torch.as_tensor(a, device=cuda)
            for a in testing.synthetic_problem(K, H, W, seed=K)]
    kw = dict(kernel=kernel, tol=0.9, maxiter=2, max_relgap=0.0)
    msgs = None
    for _ in range(2):
        before = t_mp.minplus_send.launches
        got = t_scan.solve_scanline(*prob, **kw, messages=msgs)
        torch.cuda.synchronize()
        assert t_mp.minplus_send.launches == before + 4 * H * 2
        ref = t_scan.solve_scanline(*prob, **kw, messages=msgs,
                                    use_kernel=False)
        assert torch.equal(got.messages, ref.messages)
        assert torch.equal(got.labels, ref.labels)
        assert float(got.energy) == float(ref.energy)
        np.testing.assert_allclose(float(got.lower_bound),
                                   float(ref.lower_bound), rtol=1e-5)
        assert float(got.lower_bound) <= float(got.energy)
        msgs = got.messages


def test_scanline_raises_on_card_for_float64(cuda):
    """No fallback: a float64 problem on the card reaches the send kernel's
    argument check and raises."""
    prob = [torch.as_tensor(a, device=cuda)
            for a in testing.trws_problem(0, 3, 4, 5)]
    with pytest.raises(ValueError, match="float32"):
        t_scan.solve_scanline(*prob, kernel=1, tol=1.0, maxiter=1)


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


# ------------------------------------------------ the SegPln chain's ops
# (plain PyTorch, not kernels of this package: the same functions on the
# card and on the CPU, where a division by a Python number, a reduction
# order or a fused multiply-add would show)


def _baby2_crop(y0, x0, h, w):
    from stereo_tpu_torch.utils import io

    pair = io.load_pair("baby2", dtype=np.float32)
    return [np.ascontiguousarray(im[y0:y0 + h, x0:x0 + w])
            for im in pair.images]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("crop", [(60, 90, 24, 32), (100, 120, 96, 128)])
def test_mean_shift_filter_card_equals_cpu(cuda, crop, dtype):
    from stereo_tpu_torch.proposals import segmentation

    im = _baby2_crop(*crop)[0].astype(dtype)
    luv = segmentation.rgb_to_luv(im)
    on_cpu = segmentation.mean_shift_filter(luv, 4, 6.5)
    on_card = segmentation.mean_shift_filter(luv.to(cuda), 4, 6.5)
    assert on_card.is_cuda and on_card.dtype == on_cpu.dtype
    same = (on_card.cpu() == on_cpu).all(dim=-1)
    print(f"mean-shift filter, baby2 crop {crop}, {np.dtype(dtype).name}: "
          f"{int(same.sum())} of {same.numel()} pixels bit-identical, "
          f"largest difference "
          f"{float((on_card.cpu() - on_cpu).abs().max()):.3g}")
    assert bool(same.all())


def test_valid_average_and_unary_card_vs_cpu(cuda):
    from stereo_tpu_torch.ops import filters, photo
    from stereo_tpu_torch.utils import io

    pair = io.load_pair("baby2", dtype=np.float32)
    H, W, _ = pair.images[0].shape
    rng = np.random.default_rng(0)
    x = rng.uniform(0.0, np.log(2.0), (16, H, W)).astype(np.float32)
    a_cpu = filters.valid_average_2d(torch.as_tensor(x), 2)
    a_card = filters.valid_average_2d(torch.as_tensor(x, device=cuda), 2)
    err_avg = float((a_card.cpu() - a_cpu).abs().max())
    planes = np.zeros((4, H, W), np.float32)
    planes[0] = rng.normal(0, 0.05, (H, W))
    planes[1] = rng.normal(0, 0.05, (H, W))
    planes[2] = 1.0
    planes[3] = -rng.uniform(0, 255, (H, W))

    def unary(dev):
        ims = [torch.as_tensor(im, device=dev) for im in pair.images]
        return photo.unary_cost(
            torch.as_tensor(planes, device=dev), ims[0], ims[1],
            torch.as_tensor(pair.P[1], dtype=torch.float32, device=dev),
            30.0, d_min=0.0, d_step=255.0)

    u_cpu, u_card = unary("cpu"), unary(cuda)
    err_u = float((u_card.cpu() - u_cpu).abs().max())
    print(f"baby2 {H}x{W}: valid_average_2d largest difference {err_avg:.3g}"
          f" ({int((a_card.cpu() == a_cpu).sum())} of {a_cpu.numel()} equal);"
          f" unary_cost largest difference {err_u:.3g} "
          f"({int((u_card.cpu() == u_cpu).sum())} of {u_cpu.numel()} equal)")
    # shifted adds and an IEEE division: the same bits
    assert err_avg == 0.0
    # exp and log of the card's math library may differ from the CPU's by
    # a few ulp of values below log 2
    assert err_u <= 1e-6


def _second_order_scene(H=10, W=14, seed=0):
    rng = np.random.default_rng(seed)
    im0 = np.clip(rng.uniform(0, 255, (H, W, 3)) * 0.5
                  + np.linspace(0, 255, W)[None, :, None] * 0.5, 0, 255)
    P = np.zeros((3, 4))
    P[:, :3] = np.eye(3)
    P[0, 3] = -1.0
    D1 = np.full((H, W), 2.0)  # fronto-parallel: u ties down each column
    D2 = rng.uniform(0, 4, (H, W))
    return im0, np.roll(im0, -2, axis=1), P, D1, D2


def test_visibility_terms_card_equal_cpu(cuda):
    """Projections (multiply, add, divide: one rounding each) are bit for
    bit between card and CPU, so the stable sort and the window scan find
    the same pairs; the graph's edges are equal, its photo costs within
    the card's exp / log."""
    from stereo_tpu_torch.models import visibility as t_vis

    R, im, P, D1, D2 = _second_order_scene()
    terms = {}
    for dev in ("cpu", cuda):
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
        u, v, z, pc = t_vis.project_candidates(
            f32(D1), f32(D2), f32(P), f32(im), f32(R), 30.0)
        terms[str(dev)] = (
            [a.cpu().numpy() for a in (u, v, z, pc)],
            t_vis.build_visibility_terms(f32(D1), f32(D2), [f32(im)],
                                         P[None], f32(R), 30.0, 0.7))
    (cpu_p, cpu_t), (card_p, card_t) = terms["cpu"], terms["cuda"]
    for a, b in zip(cpu_p[:3], card_p[:3]):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_allclose(card_p[3], cpu_p[3], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(card_t["interactions"][0],
                                  cpu_t["interactions"][0])
    for a, b in zip(cpu_t["edges"][:2], card_t["edges"][:2]):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("use_variance", [0, 2])
def test_truncquad_modes_card_equals_cpu(cuda, use_variance):
    from stereo_tpu_torch.render import modes as t_modes

    rng = np.random.default_rng(use_variance)
    I = np.round(rng.uniform(0, 10, (3, 2, 3, 5, 6)))
    I[..., 4, :] = I[..., 0, :]
    for dtype in (torch.float32, torch.float64):
        cpu = t_modes.truncquad_modes(torch.as_tensor(I, dtype=dtype), 6.0,
                                      use_variance=use_variance)
        card = t_modes.truncquad_modes(
            torch.as_tensor(I, dtype=dtype, device=cuda), 6.0,
            use_variance=use_variance)
        for k in cpu:
            np.testing.assert_array_equal(card[k].cpu().numpy(),
                                          cpu[k].numpy(), err_msg=k)


def test_checkpoint_resume_on_card_bitwise(cuda, tmp_path):
    """6 sweeps through the compact phase kernel straight, against 3, an
    async checkpoint, a load and 3 more: equal bit for bit."""
    from stereo_tpu_torch.utils.checkpoint import Checkpointer

    args = [torch.as_tensor(a, dtype=torch.float32, device=cuda)
            for a in testing.trws_problem(0, 15, 19, 24)]
    kw = dict(kernel=1, tol=1.5, max_relgap=0.0)
    full = t_trws.solve(*args, maxiter=6, **kw)
    half = t_trws.solve(*args, maxiter=3, **kw)
    ck = Checkpointer(str(tmp_path), async_save=True)
    ck.save(3, {"messages": half.messages})
    ck.wait()
    resumed = t_trws.solve(*args, maxiter=3, **kw, messages=torch.as_tensor(
        ck.load()[1]["['messages']"], device=cuda))
    assert torch.equal(resumed.labels, full.labels)
    assert torch.equal(resumed.messages, full.messages)
    assert float(resumed.energy) == float(full.energy)
    assert float(resumed.lower_bound) == float(full.lower_bound)


# ------------------------------------------- the distribution layer
@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("n", [2, 3])
def test_column_shards_on_one_card(cuda, n, compact):
    """n column shards on one card through kernel 1 (compact) or kernel 2:
    labels and messages bit for bit the one-device solve's, 2 launches a
    sweep a shard."""
    from stereo_tpu_torch.parallel import mesh as t_mesh

    prob = [torch.as_tensor(a, device=cuda)
            for a in testing.synthetic_problem(15, 37, 66)]
    kw = dict(kernel=1, tol=0.5, maxiter=6, max_relgap=0.0, compact=compact)
    ref = t_trws.solve(*prob, **kw)
    m = t_mesh.make_mesh(n, devices=[cuda] * n)
    wrapper = (t_pk.phase_messages_compact if compact
               else t_pk.phase_messages)
    wrapper.launches = 0
    res = t_mesh.sharded_solve(m, *prob, **kw)
    assert wrapper.launches == 2 * 6 * n
    assert torch.equal(res.labels, ref.labels)
    assert torch.equal(res.messages, ref.messages)
    assert float(res.energy) == pytest.approx(float(ref.energy), rel=1e-5)


@pytest.mark.parametrize("n", [2, 3])
def test_fusion_step_shards_on_one_card(cuda, n):
    """A fusion move over n column shards of one card, float32: the take
    mask bit for bit the one-device move's (sorted verdicts)."""
    from stereo_tpu_torch import energy as t_energy
    from stereo_tpu_torch.parallel import fusion_dist, mesh as t_mesh
    from stereo_tpu_torch.solvers import binary as t_binary

    H, W = 40, 66
    cur, prop = (torch.as_tensor(testing.random_planes(s, H, W),
                                 dtype=torch.float32, device=cuda)
                 for s in (n, n + 10))
    rng = np.random.default_rng(n)
    U0, U1 = (torch.as_tensor(rng.uniform(0, 3, (H, W)), dtype=torch.float32,
                              device=cuda) for _ in range(2))
    w = t_energy.default_weights(H, W, dtype=torch.float32, device=cuda)
    D0, Q = t_binary.fusion_problem(cur, prop)
    kw = dict(kernel=1, tol=0.9, maxiter=20, max_relgap=0.0)
    ref = t_binary.binary_fuse(U0, U1, D0, Q, w, **kw, accept_method="sort")
    m = t_mesh.make_mesh(n, devices=[cuda] * n)
    _, take, _, _ = fusion_dist.sharded_fusion_step(m, cur, prop, U0, U1, w,
                                                    **kw)
    assert torch.equal(take, ref.take)


@pytest.mark.parametrize("n", [2, 3])
def test_banded_stripes_on_one_card(cuda, n):
    """n gy stripes on one card, one launch of the column send kernel a
    step a stripe: labels and messages bit for bit the one-device steps
    path's."""
    from stereo_tpu_torch.solvers import banded_dist

    H, W, Bh, Bw = 48, 40, 8, 8
    prob = [torch.as_tensor(a, device=cuda)
            for a in testing.synthetic_problem(15, H, W)]
    run = t_banded.BandedRun(*prob, kernel=1, tol=0.5, Bh=Bh, Bw=Bw,
                             sweep="steps")
    st, _, _, bestL = run.run(run.init_state(), 2, 2)
    mesh = banded_dist.make_y_mesh(n, devices=[cuda] * n)
    t_mp.minplus_send.launches = 0
    res = banded_dist.sharded_banded_run(mesh, *prob, kernel=1, tol=0.5,
                                         Bh=Bh, Bw=Bw, sweeps=2,
                                         decode_every=2)
    spec = t_banded.BandedSpec(H // n, W, Bh, Bw)
    assert t_mp.minplus_send.launches == 2 * 2 * spec.T * n
    assert torch.equal(res.labels, bestL)
    assert torch.equal(res.messages, run.messages(st))


# ------------------------------------------- the K = 2 block kernel
# the kernel sums the bound and the energy in double, the plain version in
# float32
K2_RTOL = 1e-5


def _k2_inputs(cuda, seed, H, W, kernel=1, tol=0.9):
    """(theta0, theta1, M, V, gamma, valid, cb) of a random fusion move on
    the card, as binary_fuse builds them, with zero messages."""
    from stereo_tpu_torch import energy as t_energy
    from stereo_tpu_torch.solvers import binary as t_binary

    mv = {k: torch.as_tensor(v, device=cuda)
          for k, v in testing.fusion_move(seed, H, W).items()}
    D0, Q = t_binary.fusion_problem(mv["cur"], mv["prop"])
    return (mv["U0"], mv["U1"], torch.zeros((4, H, W), device=cuda),
            t_binary._tables(D0, Q, mv["w"], kernel, tol),
            t_trws.node_gamma(H, W, torch.float32, device=cuda),
            t_energy.default_weights(H, W, torch.float32, device=cuda),
            t_trws.checkerboard(H, W, device=cuda))


@pytest.mark.parametrize("check_every", [5, 1])
@pytest.mark.parametrize("H,W,kernel", [(375, 450, 1), (7, 9, 2), (2, 5, 1),
                                        (40, 66, 1), (33, 2, 2)])
def test_k2_block_kernel_on_card(cuda, H, W, kernel, check_every):
    """The block kernel against binary._k2_block over 10 blocks in a row,
    each from the last one's messages (checked after 1, 2 and 10): the
    messages and the labelling bit for bit, the bound and the energy to
    float32 rounding; one launch a block; the input messages unchanged."""
    from stereo_tpu_torch.ops import k2_block as t_k2
    from stereo_tpu_torch.solvers import binary as t_binary

    inp = list(_k2_inputs(cuda, H * W, H, W, kernel))
    before = t_k2.k2_block.launches
    for block in range(1, 11):
        M0 = inp[2].clone()
        M, lb, z, e = t_k2.k2_block(*inp, check_every)
        torch.cuda.synchronize()
        assert torch.equal(inp[2], M0)
        rM, rlb, rz, re_ = t_binary._k2_block(*inp, check_every)
        if block in (1, 2, 10):
            assert torch.equal(M, rM) and torch.equal(z, rz)
            assert lb.dtype == e.dtype == torch.float32 and lb.dim() == 0
            np.testing.assert_allclose(float(lb), float(rlb), rtol=K2_RTOL)
            np.testing.assert_allclose(float(e), float(re_), rtol=K2_RTOL)
        inp[2] = rM
    assert t_k2.k2_block.launches - before == 10
    assert M.abs().max() > 0 and 0 < int(z.sum()) < H * W


def test_k2_block_kernel_is_repeatable_on_card(cuda):
    """Two launches on one warm state at teddy's shape give the same bits:
    messages, labelling, bound and energy."""
    from stereo_tpu_torch.ops import k2_block as t_k2

    inp = list(_k2_inputs(cuda, 11, 375, 450))
    inp[2] = t_k2.k2_block(*inp, 5)[0]
    runs = [t_k2.k2_block(*inp, 5) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("maxiter", [20, 50])
def test_binary_fuse_take_kernel_equals_plain_on_card(cuda, monkeypatch,
                                                      maxiter):
    """binary_fuse at teddy's shape at max_relgap 0 (the iteration cap
    stops it): through the kernel, one launch a block, the same take,
    iterations and energy as with the plain block."""
    from stereo_tpu_torch.ops import k2_block as t_k2
    from stereo_tpu_torch.solvers import binary as t_binary

    H, W = 375, 450
    mv = {k: torch.as_tensor(v, device=cuda)
          for k, v in testing.fusion_move(7, H, W).items()}
    D0, Q = t_binary.fusion_problem(mv["cur"], mv["prop"])
    kw = dict(kernel=1, tol=0.9, maxiter=maxiter, max_relgap=0.0)
    before = t_k2.k2_block.launches
    got = t_binary.binary_fuse(mv["U0"], mv["U1"], D0, Q, mv["w"], **kw)
    torch.cuda.synchronize()
    assert t_k2.k2_block.launches - before == maxiter // 5
    monkeypatch.setattr(t_binary, "k2_block", t_binary._k2_block)
    ref = t_binary.binary_fuse(mv["U0"], mv["U1"], D0, Q, mv["w"], **kw)
    assert got.iterations == ref.iterations == maxiter
    assert torch.equal(got.take, ref.take) and int(got.take.sum()) > 0
    assert torch.equal(got.energy, ref.energy)
    np.testing.assert_allclose(float(got.lower_bound),
                               float(ref.lower_bound), rtol=K2_RTOL)


def test_k2_block_raises_on_card_for_bad_input(cuda):
    from stereo_tpu_torch.ops import k2_block as t_k2

    inp = list(_k2_inputs(cuda, 3, 8, 10))

    def call(i, t, check_every=5):
        args = list(inp)
        args[i] = t
        return t_k2.k2_block(*args, check_every)
    with pytest.raises(ValueError, match="float32"):
        call(0, inp[0].double())
    with pytest.raises(ValueError, match="expected"):
        call(1, inp[1].cpu())
    with pytest.raises(ValueError, match="shape"):
        call(3, inp[3][:, :, :, :-1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        call(2, inp[2].transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="int32"):
        call(6, inp[6].long())
    with pytest.raises(ValueError, match="check_every"):
        call(2, inp[2], 0)
    small = _k2_inputs(cuda, 3, 1, 10)
    with pytest.raises(ValueError, match="H, W >= 2"):
        t_k2.k2_block(*small, 5)
