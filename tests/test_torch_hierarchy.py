"""stereo_tpu_torch.solvers.hierarchy vs stereo_tpu.solvers.hierarchy.  CPU,
float64, same numpy inputs.

Tolerances: coarsened fields and upsampled messages atol 1e-10 (block sums
may be taken in another order); energies and bounds rel 1e-10 (the coarse
levels' messages warm-start the fine level, so rounding carries through the
whole pyramid); labels equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_tpu.solvers import hierarchy as j_h
from stereo_tpu_torch import testing
from stereo_tpu_torch.solvers import hierarchy as t_h
from stereo_tpu_torch.solvers import wavefront as t_wf

torch.set_num_threads(1)

T = lambda arrs: [torch.as_tensor(a) for a in arrs]
J = lambda arrs: [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("H,W", [(8, 10), (9, 11), (7, 6)])
def test_coarsen_and_upsample_match_jax(H, W):
    K = 3
    prob = testing.trws_problem(H, K, H, W)
    got = t_h.coarsen(*T(prob))
    want = j_h.coarsen(*J(prob))
    for g, w, shape in zip(got, want, ((K,), (K,), (4, K), (4,))):
        assert tuple(g.shape) == shape + (H // 2, W // 2)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-10)
    # the coarse border has no in-edges
    assert float(got[3][0][:, 0].abs().sum()) == 0.0
    assert float(got[3][3][-1, :].abs().sum()) == 0.0
    M = np.random.default_rng(W).random((4, K, H // 2, W // 2))
    up = t_h.upsample_messages(torch.as_tensor(M), (H, W))
    assert tuple(up.shape) == (4, K, H, W)
    np.testing.assert_allclose(
        up.numpy(), np.asarray(j_h.upsample_messages(jnp.asarray(M), (H, W))),
        rtol=0, atol=1e-10)
    np.testing.assert_array_equal(up[..., 1, 1].numpy(), M[..., 0, 0] / 2)


def test_pool_and_crop():
    x = torch.arange(5 * 7, dtype=torch.float64).reshape(1, 5, 7)
    c = t_h._crop_to_multiple(x, 2)
    assert tuple(c.shape) == (1, 4, 6)
    p = t_h._pool_sum(c, 2)
    assert tuple(p.shape) == (1, 2, 3)
    assert float(p[0, 0, 0]) == 0 + 1 + 7 + 8
    np.testing.assert_array_equal(
        p.numpy(), np.asarray(j_h._pool_sum(jnp.asarray(c.numpy()), 2)))


def test_solve_hierarchical_matches_jax():
    """Two levels (32 x 20 -> 16 x 10; the second is under 16 pixels and is
    not coarsened again)."""
    prob = testing.trws_problem(3, 3, 32, 20)
    kw = dict(kernel=1, tol=1.0, maxiter=8, max_relgap=0.0, levels=3,
              coarse_sweeps=8, check_every=4)
    want = j_h.solve_hierarchical(*J(prob), **kw, use_pallas=False)
    got = t_h.solve_hierarchical(*T(prob), **kw)
    assert got.iterations == int(want.iterations) == 8
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(float(got.energy), float(want.energy),
                               rtol=1e-10)
    np.testing.assert_allclose(float(got.lower_bound),
                               float(want.lower_bound), rtol=1e-10)
    np.testing.assert_allclose(got.messages.numpy(),
                               np.asarray(want.messages), rtol=0, atol=1e-10)
    assert float(got.lower_bound) <= float(got.energy)
    # with and without the kernel switch the CPU gives the same thing
    plain = t_h.solve_hierarchical(*T(prob), **kw, use_kernel=False)
    assert torch.equal(plain.messages, got.messages)


def test_wavefront_warm_start_matches_jax():
    prob = testing.trws_problem(4, 3, 18, 16)
    kw = dict(kernel=2, tol=0.9, levels=2, coarse_sweeps=3)
    want = j_h.wavefront_warm_start(*J(prob), **kw, use_pallas=False)
    got = t_h.wavefront_warm_start(*T(prob), **kw)
    assert tuple(got.shape) == (4, 3, 18, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-10)
    # it is only an initializer: the fine solve keeps a valid bound
    res = t_wf.solve_wavefront(*T(prob), kernel=2, tol=0.9, maxiter=2,
                               max_relgap=0.0, messages=got)
    assert float(res.lower_bound) <= float(res.energy) + 1e-9
    # a problem too small to coarsen has no warm start
    small = testing.trws_problem(0, 3, 6, 7)
    assert t_h.wavefront_warm_start(*T(small), **kw) is None
    assert j_h.wavefront_warm_start(*J(small), **kw,
                                    use_pallas=False) is None
