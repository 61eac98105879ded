"""stereo_tpu_torch.ops.minplus.minplus_pair (its plain version; the CUDA
kernel is held against it on the card) vs the JAX package's XLA formulation,
its Pallas tile kernel in interpret mode, and the dense formula.

Tolerances: float64 against minplus_pair_xla and the dense formula 1e-10
(the same additions, so in practice exact); float32 against the Pallas
kernel rtol 1e-5 / atol 1e-6 (contraction noise of 1-2 ulp)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_tpu.ops import minplus as j_minplus
from stereo_tpu_torch import testing
from stereo_tpu_torch.ops import minplus as t_minplus
from stereo_tpu_torch.ops import phase_kernel as t_pk

torch.set_num_threads(1)

T = lambda arrs: [torch.as_tensor(a) for a in arrs]
J = lambda arrs: [jnp.asarray(a) for a in arrs]


def _dense(HA, HB, P, R, alpha, tol, kernel):
    diff = P[:, None] - R[None, :]  # [i, j, H, W]
    tr = np.minimum(np.abs(diff) if kernel == 1 else diff * diff, tol)
    term = alpha[None, None] * tr
    return ((HA[:, None] + term).min(axis=0),
            (HB[None, :] + term).min(axis=1))


@pytest.mark.parametrize("kernel", [1, 2])
@pytest.mark.parametrize("K,H,W", [(2, 3, 4), (5, 9, 11), (8, 4, 33),
                                   (11, 7, 5)])
def test_pair_matches_xla_and_dense_float64(K, H, W, kernel):
    inp = testing.pair_inputs(K + W, K, H, W, np.float64)
    tol = 1.3
    gA, gB = t_minplus.minplus_pair(*T(inp), tol, kernel)  # CPU: plain
    assert gA.dtype == torch.float64 and tuple(gA.shape) == (K, H, W)
    wA, wB = j_minplus.minplus_pair_xla(*J(inp), kernel, tol)
    np.testing.assert_allclose(gA.numpy(), np.asarray(wA), rtol=0, atol=1e-10)
    np.testing.assert_allclose(gB.numpy(), np.asarray(wB), rtol=0, atol=1e-10)
    dA, dB = _dense(*inp, tol, kernel)
    np.testing.assert_allclose(gA.numpy(), dA, rtol=0, atol=1e-10)
    np.testing.assert_allclose(gB.numpy(), dB, rtol=0, atol=1e-10)
    # alpha = 0 on the first row and column: the minima are those of H alone
    np.testing.assert_allclose(
        gA[:, 0].numpy(), np.broadcast_to(inp[0][:, 0].min(axis=0),
                                          (K, W)), rtol=0, atol=1e-12)
    assert bool(torch.isfinite(gA).all() and torch.isfinite(gB).all())


@pytest.mark.parametrize("kernel", [1, 2])
@pytest.mark.parametrize("K,H,W", [(3, 5, 7), (5, 9, 11), (9, 8, 130)])
def test_pair_matches_pallas_tile_kernel_interpret(K, H, W, kernel):
    inp = testing.pair_inputs(K + H, K, H, W, np.float32)
    tol = 1.1
    wA, wB = j_minplus.minplus_pair_pallas(*J(inp), tol, kernel,
                                           interpret=True)
    gA, gB = t_minplus.minplus_pair(*T(inp), tol, kernel)
    assert gA.dtype == torch.float32
    np.testing.assert_allclose(gA.numpy(), np.asarray(wA), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(gB.numpy(), np.asarray(wB), rtol=1e-5,
                               atol=1e-6)


def test_wrapper_is_the_plain_version_on_the_cpu_and_counts_nothing():
    inp = T(testing.pair_inputs(0, 4, 5, 6, np.float64))
    before = t_minplus.minplus_pair.launches
    got = t_minplus.minplus_pair(*inp, 0.9, 2)
    ref = t_minplus.minplus_pair_ref(*inp, 0.9, 2)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert t_minplus.minplus_pair.launches == before
    with pytest.raises(ValueError, match="kernel"):
        t_minplus.minplus_pair(*inp, 0.9, 3)


@pytest.mark.parametrize("color", [0, 1])
def test_full_grid_phase_assembled_from_pairs(color):
    """One full-grid phase assembled per direction from minplus_pair as the
    JAX solver assembles it (select by colour, subtract the minimum, mask by
    valid) equals phase_messages_ref: the plain phase is made of the plain
    pair."""
    K, H, W, tol, kernel = 4, 7, 9, 1.2, 1
    inp = testing.phase_inputs_full(color, K, H, W, color, np.float64)
    a = {k: torch.as_tensor(v) for k, v in inp.items()}
    want_M, want_v = t_pk.phase_messages_ref(
        *(a[k] for k in testing.FULL_ARGS), tol, kernel)
    for d in range(4):
        msgA, msgB = t_minplus.minplus_pair(
            a["gD_shifted"][d] - a["M"][d], a["gD"] - a["M"][d], a["Q"][d],
            a["D0"], a["alphas"][d], tol, kernel)
        msg = torch.where(a["src_is_head"][None] > 0, msgB, msgA)
        vmin = msg.min(dim=0).values
        assert torch.equal((msg - vmin[None]) * a["valid"][d][None],
                           want_M[d])
        assert torch.equal(vmin, want_v[d])
