"""stereo_tpu_torch.solvers.scanline vs stereo_tpu.solvers.scanline, vs the
sequential numpy oracle in scanline order, and the scanline schedule of
DispMapNCC against the JAX model.  CPU, float64, same numpy inputs.

Tolerances: labels equal; messages atol 1e-10; energy and lower bound rel
1e-10 (the port's row loop adds the incident buffers in the JAX module's
order; only the lower bound's sum over rows is taken in another order).  The
oracle, as tests/test_scanline.py holds the JAX module to it: rel 1e-10,
abs 1e-9."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles
from stereo_tpu.models.ncc import DispMapNCC as JDispMapNCC
from stereo_tpu.solvers import scanline as j_scan
from stereo_tpu_torch import testing
from stereo_tpu_torch.models.ncc import DispMapNCC as TDispMapNCC
from stereo_tpu_torch.solvers import scanline as t_scan
from stereo_tpu_torch.solvers import trws as t_trws

torch.set_num_threads(1)

T = lambda arrs: [torch.as_tensor(a) for a in arrs]
J = lambda arrs: [jnp.asarray(a) for a in arrs]
RTOL = 1e-10


def scanline_order(H, W):
    """Node ids in scanline rank (y, parity(x), x)."""
    nodes = sorted((y, x % 2, x) for y in range(H) for x in range(W))
    return [y * W + x for (y, _, x) in nodes]


@pytest.mark.parametrize("H,W", [(1, 1), (1, 6), (5, 1), (4, 7), (6, 5)])
def test_scanline_gamma_matches_jax(H, W):
    got = t_scan.scanline_gamma(H, W, torch.float64, device="cpu")
    want = j_scan.scanline_gamma(H, W, jnp.float64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shift", [1, -1, 2, -3])
def test_roll_cols_matches_jax(shift):
    x = np.random.default_rng(shift + 5).normal(size=(3, 7))
    np.testing.assert_array_equal(
        t_scan._roll_cols(torch.as_tensor(x), shift).numpy(),
        np.asarray(j_scan._roll_cols(jnp.asarray(x), shift)))


def _assert_result(got, want):
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(float(got.energy), float(want.energy),
                               rtol=RTOL)
    np.testing.assert_allclose(float(got.lower_bound),
                               float(want.lower_bound), rtol=RTOL)
    np.testing.assert_allclose(got.messages.numpy(), np.asarray(want.messages),
                               rtol=0, atol=1e-10)
    assert float(got.lower_bound) <= float(got.energy) + 1e-9


@pytest.mark.parametrize("kernel", [1, 2])
@pytest.mark.parametrize("K,H,W", [(4, 5, 7), (3, 6, 5)])
def test_solve_scanline_matches_jax_from_zero_and_warm(kernel, K, H, W):
    """Six sweeps of the JAX solver (one call, so each case compiles once)
    against the port's six from zero messages, and against the port's
    three from zero followed by three from the messages they left (what
    chunked driving does)."""
    prob = testing.trws_problem(K + 7 * kernel, K, H, W)
    kw = dict(kernel=kernel, tol=1.3, max_relgap=0.0)
    want = j_scan.solve_scanline(*J(prob), **kw, maxiter=6)
    assert int(want.iterations) == 6
    whole = t_scan.solve_scanline(*T(prob), **kw, maxiter=6)
    assert whole.iterations == 6
    _assert_result(whole, want)
    first = t_scan.solve_scanline(*T(prob), **kw, maxiter=3)
    warm = t_scan.solve_scanline(*T(prob), **kw, maxiter=3,
                                 messages=first.messages)
    assert warm.iterations == 3
    _assert_result(warm, want)
    np.testing.assert_array_equal(warm.messages.numpy(),
                                  whole.messages.numpy())


@pytest.mark.parametrize("kernel", [1, 2])
@pytest.mark.parametrize("seed,H,W,K", [(0, 4, 5, 3), (1, 3, 6, 4),
                                        (2, 5, 4, 2)])
def test_solve_scanline_matches_sequential_oracle(kernel, seed, H, W, K):
    """Exact TRW-S in scanline order: sweep by sweep, the energy and bound
    of the numpy sequential oracle run in that order."""
    rng = np.random.default_rng(seed)
    theta, D0, Q, alphas = oracles.grid_trws_inputs(rng, H, W, K,
                                                    kernel=kernel)
    tol = 1.0
    theta_flat, edges = oracles.grid_edges_for_oracle(theta, D0, Q, alphas)
    oracle = oracles.SequentialTRWS(theta_flat, edges, scanline_order(H, W),
                                    kernel, tol)
    msgs = None
    for it in range(4):
        res = t_scan.solve_scanline(*T((theta, D0, Q, alphas)),
                                    kernel=kernel, tol=tol, maxiter=1,
                                    max_relgap=0.0, messages=msgs)
        msgs = res.messages
        oE, oLB, _ = oracle.iterate()
        assert float(res.lower_bound) == pytest.approx(oLB, rel=1e-10,
                                                       abs=1e-9), it
        assert float(res.energy) == pytest.approx(oE, rel=1e-10,
                                                  abs=1e-9), it


def test_solve_scanline_stopping_rule_and_plain_switch():
    """The stopping rule tests every ``check_every`` sweeps and stops once
    the gap closes; ``use_kernel=False`` runs the same plain calls (on the
    CPU both are the plain version) and the energy is that of the labels."""
    prob = T(testing.trws_problem(3, 3, 6, 7, alpha_scale=0.2))
    kw = dict(kernel=1, tol=1.0, maxiter=40, max_relgap=1e-3,
              check_every=2)
    a = t_scan.solve_scanline(*prob, **kw)
    b = t_scan.solve_scanline(*prob, **kw, use_kernel=False)
    assert a.iterations % 2 == 0 and a.iterations <= 40
    assert torch.equal(a.messages, b.messages)
    assert torch.equal(a.labels, b.labels)
    gap = (float(a.energy) - float(a.lower_bound)) / float(a.energy)
    assert gap < 1e-3 or a.iterations == 40
    e = t_trws.labeling_energy(a.labels, prob[0], prob[1], prob[2], prob[3],
                               1, 1.0)
    np.testing.assert_allclose(float(e), float(a.energy), rtol=1e-12)


# ------------------------------------------------------------ the model
H, W = 24, 32
DISPARITIES = np.arange(0, 7)
KW = dict(kernel=1, unary_weight=40.0, tol=8.0, maxiter=4, check_every=2)


def test_dispmap_ncc_scanline_matches_jax():
    """schedule="scanline": the port's model against the JAX model from a
    shared assignment and proposals (the JAX model's); chunked driving
    (one chunk per check) warm-starts the messages: the same bound."""
    im0, im1 = testing.textured_pair(2, H, W, shift=3)
    jm = JDispMapNCC([im0, im1], DISPARITIES, **KW, schedule="scanline")
    tm = TDispMapNCC([im0, im1], DISPARITIES, **KW, schedule="scanline",
                     device="cpu")
    assert tm.solver_chunk_scanline == jm.solver_chunk_scanline == 50
    jp = [jm.generate_new_plane_RANSAC(x, y, 5.0)
          for x in (8, 24) for y in (8, 18)]
    jp += [jnp.asarray(np.asarray(p)) for p in
           [np.stack([np.zeros((H, W)), np.zeros((H, W)), np.ones((H, W)),
                      np.full((H, W), -float(d))]) for d in (0, 3, 6)]]
    tp = [torch.as_tensor(np.array(p)) for p in jp]
    jm.restart()
    tm.assignment = np.asarray(jm.assignment)
    np.testing.assert_allclose(tm.energy(), jm.energy(), rtol=RTOL)
    start = np.asarray(jm.assignment)

    jE, jlb, jit = jm.simultaneous_fusion(jp)
    tE, tlb, tit = tm.simultaneous_fusion(tp)
    assert tit == jit == KW["maxiter"]
    np.testing.assert_allclose([tE, tlb], [jE, jlb], rtol=RTOL)
    assert tlb <= tE
    np.testing.assert_array_equal(tm.assignment.numpy(),
                                  np.asarray(jm.assignment))
    tm.assignment = tm.assignment
    np.testing.assert_allclose(tm.energy(), tE, rtol=1e-12)

    # the chunked run keeps the best of its decodes (the one-chunk run's
    # last decode is among them); its bound is the one-chunk run's
    tm.assignment = start
    tm.solver_chunk_scanline = KW["check_every"]
    cE, clb, cit = tm.simultaneous_fusion(tp)
    np.testing.assert_allclose(clb, tlb, rtol=RTOL)
    assert cit == tit and clb <= cE <= tE
