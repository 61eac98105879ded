"""stereo_tpu_torch.ops.minplus.minplus_send (its plain version; the CUDA
kernel is held against it on the card) vs the JAX package's Pallas send
kernel in interpret mode and vs the dense formula.

Tolerances: float32 against the Pallas kernel rtol 1e-5 (its docstring allows
1-2 ulp of contraction noise); float64 against the dense formula 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_tpu.ops import minplus as j_minplus
from stereo_tpu_torch import testing
from stereo_tpu_torch.ops import minplus as t_minplus
from stereo_tpu_torch.solvers import wavefront as t_wavefront

torch.set_num_threads(1)


def _dense(hs, p, r, alpha, tol, kernel):
    """msg[t] = min_s hs[s] + alpha * TR(p[t] - r[s]), numpy, [K, L]."""
    diff = p[None, :, :] - r[:, None, :]  # [s, t, L]
    tr = np.minimum(np.abs(diff) if kernel == 1 else diff * diff, tol)
    acc = (hs[:, None, :] + alpha[None, None, :] * tr).min(axis=0)
    vmin = acc.min(axis=0)
    return acc - vmin[None], vmin


@pytest.mark.parametrize("kernel", [1, 2])
@pytest.mark.parametrize("K,L", [(2, 7), (8, 130), (24, 53), (79, 37)])
def test_ref_matches_pallas_send_kernel_interpret(K, L, kernel):
    hs, p, r, alpha = (a[0] for a in testing.send_inputs(K + L, 1, K, L))
    tol = 1.1
    jm, jv = j_minplus.minplus_send_pallas(
        jnp.asarray(hs), jnp.asarray(p), jnp.asarray(r), jnp.asarray(alpha),
        tol, kernel, interpret=True)
    tm, tv = t_minplus.minplus_send(*map(torch.as_tensor, (hs, p, r, alpha)),
                                    tol, kernel)  # CPU: the plain version
    assert tm.dtype == torch.float32 and tuple(tm.shape) == (K, L)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("kernel", [1, 2])
@pytest.mark.parametrize("K,L", [(2, 5), (8, 33), (24, 19), (79, 9)])
def test_ref_matches_dense_formula_float64(K, L, kernel):
    hs, p, r, alpha = testing.send_inputs(K, 3, K, L, np.float64)
    tm, tv = t_minplus.minplus_send_ref(
        *map(torch.as_tensor, (hs, p, r, alpha)), 0.9, kernel)
    assert tuple(tm.shape) == (3, K, L) and tuple(tv.shape) == (3, L)
    for b in range(3):
        dm, dv = _dense(hs[b], p[b], r[b], alpha[b], 0.9, kernel)
        np.testing.assert_allclose(tm[b].numpy(), dm, rtol=0, atol=1e-12)
        np.testing.assert_allclose(tv[b].numpy(), dv, rtol=0, atol=1e-12)
    assert float(tm.min(dim=-2).values.abs().max()) == 0.0  # normalised


def test_leading_axes_broadcast():
    hs, p, r, alpha = map(torch.as_tensor,
                          testing.send_inputs(4, 2, 5, 11, np.float64))
    # as the interior sends call it: r shared by the direction pair
    gm, gv = t_minplus.minplus_send(hs, p, r[:1], alpha, 1.0, 1)
    for b in range(2):
        dm, dv = _dense(hs[b].numpy(), p[b].numpy(), r[0].numpy(),
                        alpha[b].numpy(), 1.0, 1)
        np.testing.assert_allclose(gm[b].numpy(), dm, atol=1e-12)
        np.testing.assert_allclose(gv[b].numpy(), dv, atol=1e-12)
    # two leading axes, and none
    gm2, gv2 = t_minplus.minplus_send(hs[None], p[None], r[None],
                                      alpha[None], 1.0, 1)
    assert tuple(gm2.shape) == (1, 2, 5, 11) and tuple(gv2.shape) == (1, 2, 11)
    gm0, gv0 = t_minplus.minplus_send(hs[0], p[0], r[0], alpha[0], 1.0, 1)
    assert torch.equal(gm2[0, 0], gm0) and torch.equal(gv2[0, 0], gv0)
    with pytest.raises(ValueError, match="kernel"):
        t_minplus.minplus_send(hs, p, r, alpha, 1.0, 3)


@pytest.mark.parametrize("kernel", [1, 2])
def test_head_and_tail_operand_order(kernel):
    """_head: targets carry Q; _tail: targets carry D0 and the operands
    change places — against the formulas of the JAX package's
    solvers/wavefront.py, which never swaps them (TR is even); each sent
    through _sends alone and both in one call."""
    rng = np.random.default_rng(kernel)
    K, L = 6, 13
    gD, Mold = rng.uniform(0, 2, (2, K, L)), rng.uniform(0, 1, (2, K, L))
    Q, D0 = rng.uniform(-3, 3, (2, K, L)), rng.uniform(-3, 3, (1, K, L))
    alpha = rng.uniform(0.5, 2.0, (2, L))
    tol = 1.2
    Hs = gD - Mold

    def tr(d):
        return np.minimum(np.abs(d) if kernel == 1 else d * d, tol)

    # head: msg[kt] = min_kh Hs[kh] + a TR(Q[kt] - D0[kh])
    term = alpha[:, None, None, :] * tr(Q[:, None, :, :] - D0[:, :, None, :])
    acc = (Hs[:, :, None, :] + term).min(axis=1)
    args = [torch.as_tensor(a) for a in (gD, Mold, Q, D0, alpha)]
    for use_kernel in (True, False):
        (m, v), = t_wavefront._sends([t_wavefront._head(*args)], kernel, tol,
                                     use_kernel)
        np.testing.assert_allclose(v.numpy(), acc.min(axis=1), atol=1e-12)
        np.testing.assert_allclose(m.numpy(), acc - acc.min(axis=1)[:, None],
                                   atol=1e-12)
    # tail: msg[kh] = min_kt Hs[kt] + a TR(Q[kt] - D0[kh])
    term = alpha[:, None, None, :] * tr(Q[:, :, None, :] - D0[:, None, :, :])
    acc = (Hs[:, :, None, :] + term).min(axis=1)
    both = t_wavefront._sends([t_wavefront._head(*args),
                               t_wavefront._tail(*args)], kernel, tol)
    m, v = both[1]
    np.testing.assert_allclose(v.numpy(), acc.min(axis=1), atol=1e-12)
    np.testing.assert_allclose(m.numpy(), acc - acc.min(axis=1)[:, None],
                               atol=1e-12)


def test_skew_unskew_match_jax():
    from stereo_tpu.solvers import wavefront as j_wavefront

    a = np.random.default_rng(0).random((2, 3, 5, 4))
    s = t_wavefront.skew(torch.as_tensor(a), 4)
    assert tuple(s.shape) == (2, 3, 5, 8)
    np.testing.assert_array_equal(
        s.numpy(), np.asarray(j_wavefront.skew(jnp.asarray(a), 4)))
    np.testing.assert_array_equal(t_wavefront.unskew(s, 4).numpy(), a)
    assert (t_wavefront.LT, t_wavefront.RT, t_wavefront.UP,
            t_wavefront.DN) == (j_wavefront.LT, j_wavefront.RT,
                                j_wavefront.UP, j_wavefront.DN)
    assert t_wavefront.GROUP_A == j_wavefront.GROUP_A
    assert t_wavefront.GROUP_B == j_wavefront.GROUP_B
