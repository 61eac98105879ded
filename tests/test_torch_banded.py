"""stereo_tpu_torch.solvers.banded vs stereo_tpu.solvers.banded (its scan
path and its Pallas kernel in interpret mode) and vs the sequential numpy
oracle under the banded order.  CPU, same numpy inputs.

Tolerances.  float64: layouts exact; messages atol 1e-10; energy and lower
bound rel 1e-9; labels equal (the two packages add the incident buffers in the
same order, so in practice they agree to the last few bits).  float32 against
the Pallas kernel: rtol 1e-5 / atol 1e-5 on messages, rtol 1e-5 / atol 1e-4
on the bound, as tests/test_banded_kernel.py holds that kernel to its own
scan path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles
from stereo_tpu.ops import banded_kernel as j_bk
from stereo_tpu.solvers import banded as j_banded
from stereo_tpu_torch import convert, testing
from stereo_tpu_torch.ops import banded_kernel as t_bk
from stereo_tpu_torch.solvers import banded as t_banded

torch.set_num_threads(1)

T = lambda arrs: [torch.as_tensor(a) for a in arrs]
J = lambda arrs: [jnp.asarray(a) for a in arrs]

# (H, W, Bh, Bw): even split; padding in both axes; Bw > Bh (Lp > L); one
# block; no x-seams; no y-seams
LAYOUTS = [(6, 6, 3, 3), (7, 9, 3, 4), (5, 8, 2, 4), (6, 5, 6, 5),
           (9, 4, 4, 4), (4, 9, 4, 3)]


def _problems(K, H, W, Bh, Bw, kernel=1, tol=1.0, dtype=np.float64, seed=0):
    prob = testing.trws_problem(seed + K + H, K, H, W, dtype)
    jspec = j_banded.BandedSpec(H, W, Bh, Bw)
    tspec = t_banded.BandedSpec(H, W, Bh, Bw)
    jbp = j_banded._BandedProblem(*J(prob), jspec, kernel, tol)
    tbp = t_banded._BandedProblem(*T(prob), tspec, kernel, tol)
    return prob, jbp, tbp


def _assert_state(tstate, jstate, atol):
    tMA, tMB, tS = tstate
    jMA, jMB, jS = jstate
    np.testing.assert_allclose(tMA.numpy(), np.asarray(jMA), rtol=0, atol=atol)
    np.testing.assert_allclose(tMB.numpy(), np.asarray(jMB), rtol=0, atol=atol)
    for a, b in zip(tS, jS):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=atol)


# ------------------------------------------------------------------ layouts
@pytest.mark.parametrize("H,W,Bh,Bw", LAYOUTS)
def test_spec_order_gamma_and_layouts_match_jax(H, W, Bh, Bw):
    jspec = j_banded.BandedSpec(H, W, Bh, Bw)
    tspec = t_banded.BandedSpec(H, W, Bh, Bw)
    for f in ("Gy", "Gx", "nb", "L", "L2", "Lp", "T", "Hp", "Wp"):
        assert getattr(tspec, f) == getattr(jspec, f)
    assert t_banded.banded_order(H, W, Bh, Bw) == j_banded.banded_order(
        H, W, Bh, Bw)
    np.testing.assert_array_equal(
        t_banded.banded_gamma(tspec, torch.float64, "cpu").numpy(),
        np.asarray(j_banded.banded_gamma(jspec, jnp.float64)))
    a = np.random.default_rng(H + W).random((2, 3, H, W))
    cols = t_banded.to_cols(torch.as_tensor(a), tspec)
    assert cols.shape == (tspec.T + 2, 2, 3, tspec.L)
    np.testing.assert_array_equal(
        cols.numpy(), np.asarray(j_banded.to_cols(jnp.asarray(a), jspec)))
    np.testing.assert_array_equal(t_banded.from_cols(cols, tspec).numpy(), a)
    for xb in (0, Bw - 1):
        lanes = t_banded._x_lanes(torch.as_tensor(a), tspec, xb)
        np.testing.assert_array_equal(
            lanes.numpy(),
            np.asarray(j_banded._x_lanes(jnp.asarray(a), jspec, xb)))
        np.testing.assert_array_equal(
            t_banded._x_lanes_back(lanes, tspec, xb).numpy(),
            np.asarray(j_banded._x_lanes_back(jnp.asarray(lanes.numpy()),
                                              jspec, xb)))
    for yb in (0, Bh - 1):
        lanes = t_banded._y_lanes(torch.as_tensor(a), tspec, yb)
        assert lanes.shape[-1] == tspec.Lp
        np.testing.assert_array_equal(
            lanes.numpy(),
            np.asarray(j_banded._y_lanes(jnp.asarray(a), jspec, yb)))
        np.testing.assert_array_equal(
            t_banded._y_lanes_back(lanes, tspec, yb).numpy(),
            np.asarray(j_banded._y_lanes_back(jnp.asarray(lanes.numpy()),
                                              jspec, yb)))


def test_spec_rejects_unit_blocks():
    with pytest.raises(ValueError, match="Bh, Bw >= 2"):
        t_banded.BandedSpec(5, 5, 1, 3)


@pytest.mark.parametrize("H,W,Bh,Bw", LAYOUTS)
def test_problem_and_message_state_match_jax(H, W, Bh, Bw):
    K = 3
    prob, jbp, tbp = _problems(K, H, W, Bh, Bw)
    for f in j_banded._BandedProblem._ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(tbp, f).numpy(),
                                      np.asarray(getattr(jbp, f)), err_msg=f)
        assert getattr(tbp, f).is_contiguous(), f
    M = np.random.default_rng(3).random((4, K, H, W)) * testing.border_weights(
        H, W)[:, None]
    tstate = t_banded.messages_to_state(torch.as_tensor(M), tbp)
    jstate = j_banded.messages_to_state(jnp.asarray(M), jbp)
    _assert_state(tstate, jstate, atol=0)
    back = t_banded.state_to_messages(tstate, tbp).numpy()
    np.testing.assert_allclose(back, M, rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        back, np.asarray(j_banded.state_to_messages(jstate, jbp)), rtol=0,
        atol=1e-12)
    shapes = t_bk.problem_shapes(tbp.spec, K)
    for name, t in zip(("MA", "MB", "SxL", "SxR", "SyU", "SyD"),
                       (tstate[0], tstate[1], *tstate[2])):
        assert tuple(t.shape) == shapes[name]


# ------------------------------------------------------------------- oracle
@pytest.mark.parametrize("kernel", [1, 2])
@pytest.mark.parametrize("seed,H,W,K,Bh,Bw", [
    (0, 6, 6, 3, 3, 3),      # even split, square blocks
    (1, 7, 9, 3, 3, 4),      # padding in both axes, rectangular blocks
    (2, 5, 8, 2, 2, 4),      # minimal Bh
    (3, 6, 5, 4, 6, 5),      # single block == raster
    (4, 9, 4, 3, 4, 4),      # Gy=3, Gx=1 (no x-seams)
    (5, 4, 9, 3, 4, 3),      # Gy=1, Gx=3 (no y-seams)
])
def test_matches_sequential_banded_oracle(kernel, seed, H, W, K, Bh, Bw):
    """Banded sweeps == sequential TRW-S under the banded order: energies,
    bounds and labels match the oracle to fp roundoff, every iteration."""
    rng = np.random.default_rng(seed)
    theta, D0, Q, alphas = oracles.grid_trws_inputs(rng, H, W, K,
                                                    kernel=kernel)
    tol = 1.0
    theta_flat, edges = oracles.grid_edges_for_oracle(theta, D0, Q, alphas)
    order = t_banded.banded_order(H, W, Bh, Bw)
    oracle = oracles.SequentialTRWS(theta_flat, edges, order, kernel, tol)
    msgs = None
    for it in range(4):
        res = t_banded.solve_banded(
            *T((theta, D0, Q, alphas)), kernel=kernel, tol=tol, Bh=Bh, Bw=Bw,
            maxiter=1, max_relgap=0.0, messages=msgs)
        msgs = res.messages
        oE, oLB, oLab = oracle.iterate()
        assert float(res.lower_bound) == pytest.approx(oLB, rel=1e-9,
                                                       abs=1e-9), f"iter {it}"
        assert float(res.energy) == pytest.approx(oE, rel=1e-9,
                                                  abs=1e-9), f"iter {it}"
        np.testing.assert_array_equal(res.labels.numpy().ravel(), oLab,
                                      f"iter {it}")
        assert res.labels.dtype == torch.int32


# ------------------------------------------------------------ the JAX solver
@pytest.mark.parametrize("kernel,K,H,W,Bh,Bw", [
    (1, 3, 7, 9, 3, 4), (2, 4, 5, 8, 2, 4)])
def test_one_and_two_sweeps_match_jax(kernel, K, H, W, Bh, Bw):
    prob = testing.trws_problem(K + W, K, H, W)
    kw = dict(kernel=kernel, tol=1.3, Bh=Bh, Bw=Bw, max_relgap=0.0)
    for sweeps in (1, 2):
        want = j_banded.solve_banded(*J(prob), **kw, maxiter=sweeps,
                                     check_every=sweeps, use_pallas=False)
        got = t_banded.solve_banded(*T(prob), **kw, maxiter=sweeps,
                                    check_every=sweeps)
        np.testing.assert_array_equal(got.labels.numpy(),
                                      np.asarray(want.labels))
        np.testing.assert_allclose(float(got.energy), float(want.energy),
                                   rtol=1e-9)
        np.testing.assert_allclose(float(got.lower_bound),
                                   float(want.lower_bound), rtol=1e-9)
        np.testing.assert_allclose(got.messages.numpy(),
                                   np.asarray(want.messages), rtol=0,
                                   atol=1e-10)
        assert got.iterations == int(want.iterations) == sweeps


def test_stopping_rule_matches_jax():
    prob = testing.trws_problem(5, 3, 8, 9)
    kw = dict(kernel=1, tol=1.0, Bh=4, Bw=4, maxiter=40, max_relgap=3e-2,
              check_every=2)
    want = j_banded.solve_banded(*J(prob), **kw, use_pallas=False)
    got = t_banded.solve_banded(*T(prob), **kw)
    assert 0 < got.iterations < 40  # the relgap rule fired, at the same sweep
    assert got.iterations == int(want.iterations)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(float(got.energy), float(want.energy),
                               rtol=1e-9)


@pytest.mark.parametrize("K,H,W,Bh,Bw,kernel", [
    (3, 8, 10, 4, 5, 1),   # padding-free 2x2 blocks
    (4, 9, 8, 4, 4, 2),    # padded rows, square blocks
    (3, 10, 11, 5, 4, 1),  # padded cols
    (3, 48, 40, 8, 8, 1),  # more than 128 lanes
    (2, 40, 47, 8, 8, 2),  # kernel 2, padded cols
])
def test_plain_sweep_matches_pallas_kernel_interpret(K, H, W, Bh, Bw, kernel):
    """float32: the port's plain sweep (the CUDA kernel's reference) against
    the TPU kernel run in interpret mode, two sweeps from zero messages."""
    tol = 1.5
    prob = testing.synthetic_problem(K, H, W)
    jspec = j_banded.BandedSpec(H, W, Bh, Bw)
    jbp = j_banded._BandedProblem(*J(prob), jspec, kernel, tol)
    tbp = t_banded._BandedProblem(*T(prob), t_banded.BandedSpec(H, W, Bh, Bw),
                                  kernel, tol)
    zeros = np.zeros((4, K, H, W), np.float32)
    jstate = j_banded.messages_to_state(jnp.asarray(zeros), jbp)
    tstate = t_banded.messages_to_state(torch.as_tensor(zeros), tbp)
    sweep_fn = j_bk.make_sweep(jbp, interpret=True)
    for _ in range(2):
        jstate, jlb = sweep_fn(jstate)
        tstate, tlb = t_bk.sweep_banded(tbp, tstate)  # CPU: the plain sweep
        assert tlb.dtype == torch.float32
        np.testing.assert_allclose(float(tlb), float(jlb), rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_allclose(
            t_banded.state_to_messages(tstate, tbp).numpy(),
            np.asarray(j_banded.state_to_messages(jstate, jbp)), rtol=1e-5,
            atol=1e-5)


# ---------------------------------------------------------------- invariants
def test_invariants_and_warm_start():
    """Monotone lb, lb <= E; maxiter=2 == two chained maxiter=1 solves."""
    prob = T(testing.trws_problem(7, 4, 10, 12))
    kw = dict(kernel=1, tol=1.0, Bh=4, Bw=4, max_relgap=0.0)
    lbs, msgs = [], None
    for _ in range(8):
        res = t_banded.solve_banded(*prob, maxiter=1, messages=msgs, **kw)
        msgs = res.messages
        lbs.append(float(res.lower_bound))
        assert float(res.lower_bound) <= float(res.energy) + 1e-9
    for a, b in zip(lbs, lbs[1:]):
        assert b >= a - 1e-9, f"lb decreased: {a} -> {b}"

    a2 = t_banded.solve_banded(*prob, maxiter=2, check_every=2, **kw)
    r1 = t_banded.solve_banded(*prob, maxiter=1, **kw)
    r2 = t_banded.solve_banded(*prob, maxiter=1, messages=r1.messages, **kw)
    assert float(a2.energy) == pytest.approx(float(r2.energy), rel=1e-12)
    assert float(a2.lower_bound) == pytest.approx(float(r2.lower_bound),
                                                  rel=1e-12)
    assert torch.equal(a2.labels, r2.labels)
    # the warm start is not written to
    before = r1.messages.clone()
    t_banded.solve_banded(*prob, maxiter=1, messages=r1.messages, **kw)
    assert torch.equal(r1.messages, before)


@pytest.mark.parametrize("sweep", ["fused", "steps"])
def test_banded_run_matches_solve(sweep):
    """BandedRun chunked driving == solve_banded, chunk by chunk."""
    prob = T(testing.trws_problem(9, 3, 9, 11))
    kw = dict(kernel=1, tol=1.0, Bh=4, Bw=4)
    run = t_banded.BandedRun(*prob, **kw, sweep=sweep)
    state = run.init_state()
    msgs = None
    for _ in range(3):
        state, e, lb, labels = run.run(state, 2)
        ref = t_banded.solve_banded(*prob, **kw, maxiter=2, max_relgap=0.0,
                                    check_every=2, messages=msgs)
        msgs = ref.messages
        assert float(e) == pytest.approx(float(ref.energy), rel=1e-9)
        assert float(lb) == pytest.approx(float(ref.lower_bound), rel=1e-9)
        assert torch.equal(labels, ref.labels)
    np.testing.assert_allclose(run.messages(state).numpy(), msgs.numpy(),
                               rtol=0, atol=1e-12)


def test_banded_run_decode_every_keeps_the_incumbent():
    prob = T(testing.trws_problem(2, 4, 14, 11))
    kw = dict(kernel=1, tol=1.0, Bh=4, Bw=3)
    run = t_banded.BandedRun(*prob, **kw)
    _, e_last, lb_last, _ = run.run(run.init_state(), 6)
    state, e_best, lb, labels = run.run(run.init_state(), 6, decode_every=1)
    # same sweeps, so the same final bound; the incumbent is the best of the
    # six decodes, the last of which is the single decode above
    assert float(lb) == pytest.approx(float(lb_last), rel=1e-12)
    energies = []
    msgs = None
    for _ in range(6):
        res = t_banded.solve_banded(*prob, **kw, maxiter=1, max_relgap=0.0,
                                    messages=msgs)
        msgs = res.messages
        energies.append(float(res.energy))
    assert float(e_best) == pytest.approx(min(energies), rel=1e-12)
    assert float(e_best) <= float(e_last) + 1e-12
    assert labels.dtype == torch.int32 and tuple(labels.shape) == (14, 11)


@pytest.mark.parametrize("H,W,Bh,Bw", [(7, 9, 3, 4), (5, 8, 2, 4),
                                       (9, 4, 4, 4), (3, 4, 2, 2)])
def test_steps_and_fused_sweeps_agree_on_cpu(H, W, Bh, Bw):
    """Both are plain PyTorch on the CPU; with and without ``use_kernel``
    all four give the same state."""
    prob = T(testing.trws_problem(H, 3, H, W))
    kw = dict(kernel=2, tol=0.9, Bh=Bh, Bw=Bw, maxiter=2, max_relgap=0.0,
              check_every=2)
    ref = t_banded.solve_banded(*prob, **kw)
    for sweep in ("fused", "steps"):
        for use_kernel in (True, False):
            got = t_banded.solve_banded(*prob, **kw, sweep=sweep,
                                        use_kernel=use_kernel)
            assert torch.equal(got.messages, ref.messages)
            assert torch.equal(got.labels, ref.labels)
            assert float(got.lower_bound) == float(ref.lower_bound)
    with pytest.raises(ValueError, match="sweep"):
        t_banded.solve_banded(*prob, **kw, sweep="scan")
    assert t_banded.sends_per_sweep(t_banded.BandedSpec(H, W, Bh, Bw)) == (
        2 * (Bh + Bw - 1))


# ------------------------------------------------- state across the packages
def test_convert_carries_the_banded_state_both_ways():
    """Two sweeps in the JAX package, its state carried over, one more sweep
    in each: same state; and back again."""
    K, H, W, Bh, Bw = 3, 7, 9, 3, 4
    prob, jbp, tbp = _problems(K, H, W, Bh, Bw)
    jstate = j_banded.messages_to_state(jnp.zeros((4, K, H, W)), jbp)
    for _ in range(2):
        jstate, _ = j_banded._sweep_scan(jbp, jstate)
    tstate = convert.banded_state_from_numpy(jstate, device="cpu")
    assert tstate[0].dtype == torch.float64 and tstate[0].is_contiguous()
    jstate, jlb = j_banded._sweep_scan(jbp, jstate)
    tstate, tlb = t_bk.sweep_banded(tbp, tstate)
    _assert_state(tstate, jstate, atol=1e-10)
    np.testing.assert_allclose(float(tlb), float(jlb), rtol=1e-9)
    MA, MB, S = convert.banded_state_to_numpy(tstate)
    back = (jnp.asarray(MA), jnp.asarray(MB), tuple(jnp.asarray(s)
                                                    for s in S))
    jl, je = j_banded._decode_state(jbp, back)
    tl, te = t_banded._decode_state(tbp, tstate)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(float(te), float(je), rtol=1e-9)
    with pytest.raises(ValueError, match="seam"):
        convert.banded_state_from_numpy((MA, MB, S[:3]), device="cpu")
