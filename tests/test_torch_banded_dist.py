"""stereo_tpu_torch.solvers.banded_dist (banded TRW-S over gy stripes) and
banded._BandedProblem(stripe=) vs the port's one-device BandedRun and vs the
JAX package.  CPU, float64, the mesh a list of CPU devices.

Tolerances: a stripe's problem arrays equal the JAX package's; labels equal
and messages within atol 1e-12 (in practice equal) against the one-device
run; energy rel 1e-12 and bound rel 1e-9 (per-stripe partials)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles
from stereo_tpu.solvers import banded as j_banded
from stereo_tpu_torch.solvers import banded as t_banded
from stereo_tpu_torch.solvers import banded_dist

torch.set_num_threads(1)

T = lambda arrs: [torch.as_tensor(a) for a in arrs]  # noqa: E731


def y_mesh(n, batch=1):
    return banded_dist.make_y_mesh(n * batch, devices=["cpu"] * (n * batch),
                                   batch=batch)


@pytest.mark.parametrize("row0,Himg,above,below", [
    (0, 30, False, True), (8, 30, True, True), (24, 30, True, False),
    (0, 8, False, False)])
def test_stripe_problem_matches_jax(row0, Himg, above, below):
    """A stripe's masks, gammas and seam data equal the JAX package's
    (the last stripe carries the image's pad rows)."""
    K, Hl, W, Bh, Bw = 3, 8, 11, 4, 4
    rng = np.random.default_rng(row0 + Himg)
    prob = oracles.grid_trws_inputs(rng, Hl, W, K)
    spec_t = t_banded.BandedSpec(Hl, W, Bh, Bw)
    spec_j = j_banded.BandedSpec(Hl, W, Bh, Bw)
    stripe = (row0, Himg, above, below)
    got = t_banded._BandedProblem(*T(prob), spec_t, 1, 1.0, stripe=stripe)
    want = j_banded._BandedProblem(*(jnp.asarray(a) for a in prob), spec_j,
                                   1, 1.0, stripe=(row0, Himg,
                                                   jnp.asarray(above),
                                                   jnp.asarray(below)))
    for name in j_banded._BandedProblem._ARRAY_FIELDS:
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            err_msg=name)
    np.testing.assert_array_equal(
        t_banded.banded_gamma(spec_t, torch.float64, "cpu", row0,
                              Himg).numpy(),
        np.asarray(j_banded.banded_gamma(spec_j, jnp.float64, row0, Himg)))


def test_stripe_gammas_are_rows_of_the_image():
    full = t_banded.banded_gamma(t_banded.BandedSpec(30, 11, 4, 5),
                                 torch.float64, "cpu")
    for row0 in (0, 8, 16, 24):
        g = t_banded.banded_gamma(t_banded.BandedSpec(8, 11, 4, 5),
                                  torch.float64, "cpu", row0, 30)
        rows = min(8, 30 - row0)
        assert torch.equal(g[:rows], full[row0:row0 + rows])


def _ref_and_dist(H, W, K, Bh, Bw, kernel, n, sweeps, dec, seed=0,
                  warm=False):
    rng = np.random.default_rng(seed)
    prob = T(oracles.grid_trws_inputs(rng, H, W, K))
    run = t_banded.BandedRun(*prob, kernel=kernel, tol=1.0, Bh=Bh, Bw=Bw,
                             sweep="steps")
    st = run.init_state()
    msgs_in = None
    if warm:
        st, _, _, _ = run.run(st, 2, 2)
        msgs_in = run.messages(st)
        st = run.init_state(msgs_in)
    st, bestE, lb, bestL = run.run(st, sweeps, dec)
    res = banded_dist.sharded_banded_run(
        y_mesh(n), *prob, kernel=kernel, tol=1.0, Bh=Bh, Bw=Bw,
        sweeps=sweeps, decode_every=dec, messages=msgs_in)
    return (bestE, lb, bestL, run.messages(st)), res


def _same(ref, res):
    bestE, lb, bestL, msgs = ref
    assert torch.equal(res.labels, bestL)
    np.testing.assert_allclose(res.messages.numpy(), msgs.numpy(), rtol=0,
                               atol=1e-12)
    assert float(res.energy) == pytest.approx(float(bestE), rel=1e-12)
    assert float(res.lower_bound) == pytest.approx(float(lb), rel=1e-9)


@pytest.mark.parametrize("n,Bh,Bw,kernel", [(2, 4, 4, 1), (4, 4, 4, 1),
                                            (8, 2, 3, 2), (4, 4, 5, 2)])
def test_sharded_banded_equals_single_device(n, Bh, Bw, kernel):
    """Ragged W (x padding in every configuration)."""
    _same(*_ref_and_dist(32, 13, 4, Bh, Bw, kernel, n, sweeps=6, dec=3))


def test_sharded_banded_labels_match_jax():
    ref, res = _ref_and_dist(16, 10, 3, 2, 4, 1, 4, sweeps=4, dec=2,
                             seed=4)
    rng = np.random.default_rng(4)
    prob = [jnp.asarray(a) for a in oracles.grid_trws_inputs(rng, 16, 10, 3)]
    run = j_banded.BandedRun(*prob, kernel=1, tol=1.0, Bh=2, Bw=4,
                             use_pallas=False)
    _, e, _, labels = run.run(run.init_state(), 4, 2)
    np.testing.assert_array_equal(res.labels.numpy(), np.asarray(labels))
    assert float(res.energy) == pytest.approx(float(e), rel=1e-10)


def test_sharded_banded_ragged_rows_and_warm_start():
    """The last stripe carries the image's pad rows; warm-started messages
    round-trip through the stripe layout."""
    _same(*_ref_and_dist(30, 11, 3, 4, 4, 1, n=4, sweeps=4, dec=2, seed=3,
                         warm=True))


def test_sharded_banded_rejects_uneven_stripes():
    rng = np.random.default_rng(0)
    prob = T(oracles.grid_trws_inputs(rng, 12, 8, 3))
    with pytest.raises(ValueError, match="block-rows"):
        banded_dist.sharded_banded_run(y_mesh(8), *prob, kernel=1, tol=1.0,
                                       Bh=2, Bw=4, sweeps=2)


def test_sharded_banded_batched_pairs():
    """A (2, 4) mesh: two pairs over 'batch', each pair's stripes over
    'y' — labels and messages per pair those of the one-device run."""
    rng = np.random.default_rng(1)
    H, W, K, Bh, Bw = 24, 10, 3, 3, 4
    a = T(oracles.grid_trws_inputs(rng, H, W, K))
    b = T(oracles.grid_trws_inputs(rng, H, W, K))
    stack = [torch.stack([x, y]) for x, y in zip(a, b)]
    res = banded_dist.sharded_banded_run(
        y_mesh(4, batch=2), *stack, kernel=1, tol=1.0, Bh=Bh, Bw=Bw,
        sweeps=4, decode_every=2)
    assert res.energy.shape == (2,)
    with pytest.raises(ValueError, match="'batch' mesh axis of size 2"):
        banded_dist.sharded_banded_run(y_mesh(4), *stack, kernel=1, tol=1.0,
                                       Bh=Bh, Bw=Bw, sweeps=2)
    for i, inp in enumerate((a, b)):
        run = t_banded.BandedRun(*inp, kernel=1, tol=1.0, Bh=Bh, Bw=Bw,
                                 sweep="steps")
        st, bestE, lb, bestL = run.run(run.init_state(), 4, 2)
        assert torch.equal(res.labels[i], bestL)
        assert torch.equal(res.messages[i], run.messages(st))
        assert float(res.energy[i]) == pytest.approx(float(bestE),
                                                     rel=1e-12)
        assert float(res.lower_bound[i]) == pytest.approx(float(lb),
                                                          rel=1e-9)
