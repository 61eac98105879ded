"""The plain PyTorch versions of the two checkerboard phase kernels vs the
JAX package's Pallas kernels (interpret mode, as the JAX package's own CPU
tests run them) and vs its XLA branches.  Same numpy inputs, CPU.

Tolerances: float64 atol 1e-12; float32 2 ulp at the magnitude of the
un-normalised messages (|msg| < 16, so 2 * 2^-20 ~ 1.9e-6) — XLA:CPU may
contract h + a*TR into an FMA, min/abs/sub are exact.

The CUDA kernels themselves are held against these plain versions, bit for
bit, in tests/test_torch_cuda.py (marked ``cuda``) and in chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_tpu.ops import minplus as j_minplus
from stereo_tpu.ops import phase_kernel as j_pk
from stereo_tpu.solvers import trws as j_trws
from stereo_tpu_torch import energy as t_energy
from stereo_tpu_torch import testing
from stereo_tpu_torch.ops import phase_kernel as t_pk

torch.set_num_threads(1)

ATOL = {np.float32: 1.9e-6, np.float64: 1e-12}
COMPACT_ARGS, FULL_ARGS = testing.COMPACT_ARGS, testing.FULL_ARGS


def _close(got, want, dtype):
    for g, w in zip(got, want):
        assert g.dtype == {np.float32: torch.float32,
                           np.float64: torch.float64}[dtype]
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL[dtype])


# Hc = 5 stands for an odd H (the pad row rides along as ordinary pixels of
# the half-grid); K = 5 and 9 are not multiples of 8
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kernel", [1, 2])
@pytest.mark.parametrize("K,Hc,W", [(5, 5, 9), (9, 4, 7)])
def test_compact_ref_vs_pallas_interpret(K, Hc, W, kernel, dtype):
    inp = testing.phase_inputs(K + W, K, Hc, W, dtype)
    tol = 1.1
    got = t_pk.phase_messages_compact(
        *(torch.as_tensor(inp[k]) for k in COMPACT_ARGS), tol, kernel)
    want = j_pk.phase_messages_compact_pallas(
        *(jnp.asarray(inp[k]) for k in COMPACT_ARGS), tol, kernel,
        interpret=True)
    _close(got, want, dtype)
    # the wrapper on CPU tensors IS the plain version
    ref = t_pk.phase_messages_compact_ref(
        *(torch.as_tensor(inp[k]) for k in COMPACT_ARGS), tol, kernel)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert t_pk.phase_messages_compact.launches == 0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kernel", [1, 2])
@pytest.mark.parametrize("color", [0, 1])
def test_full_ref_vs_pallas_interpret(color, kernel, dtype):
    K, H, W = 5, 7, 9
    inp = testing.phase_inputs_full(3 + color, K, H, W, color, dtype)
    tol = 0.9
    got = t_pk.phase_messages(
        *(torch.as_tensor(inp[k]) for k in FULL_ARGS), tol, kernel)
    want = j_pk.phase_messages_pallas(
        *(jnp.asarray(inp[k]) for k in FULL_ARGS), tol, kernel,
        interpret=True)
    _close(got, want, dtype)
    assert t_pk.phase_messages.launches == 0


@pytest.mark.parametrize("kernel", [1, 2])
def test_minplus_pair_vs_xla(kernel):
    from stereo_tpu_torch.ops import minplus as t_minplus

    rng = np.random.default_rng(kernel)
    K, H, W = 6, 5, 7
    HA, HB, P, R = (rng.normal(0, 2, (K, H, W)) for _ in range(4))
    a = rng.uniform(0.5, 2, (H, W))
    gA, gB = t_minplus.minplus_pair(*(torch.as_tensor(x) for x in
                                      (HA, HB, P, R, a)), 1.3, kernel)
    wA, wB = j_minplus.minplus_pair_xla(*(jnp.asarray(x) for x in
                                          (HA, HB, P, R, a)), kernel, 1.3)
    np.testing.assert_allclose(gA.numpy(), np.asarray(wA), rtol=0, atol=1e-12)
    np.testing.assert_allclose(gB.numpy(), np.asarray(wB), rtol=0, atol=1e-12)


@pytest.mark.parametrize("kernel", [1, 2])
@pytest.mark.parametrize("s", [0, 1])
def test_phase_compact_vs_xla_branch(s, kernel):
    """trws._phase_compact of the port == the JAX package's XLA branch, on an
    odd-H problem (H = 9 -> Hc = 5 with a pad row)."""
    from stereo_tpu.ops import checker as j_checker
    from stereo_tpu_torch.ops import checker as t_checker
    from stereo_tpu_torch.solvers import trws as t_trws

    K, H, W = 4, 9, 10
    theta, D0, Q, alphas = testing.trws_problem(5, K, H, W)
    M = np.random.default_rng(11).normal(0, 1, (4, K, H, W))
    tol = 1.1

    def pack(xp, checker, gamma, valid, asarray):
        ch = lambda a: (checker.compact_h(a, 0), checker.compact_h(a, 1))
        pix = ch(asarray(np.ones((H, W))))
        return ([ch(asarray(a)) for a in (theta, M, D0, Q, alphas)]
                + [ch(valid), ch(gamma), (pix[0], pix[1], H)])

    jvalid = jnp.stack([__import__("stereo_tpu").geometry.valid_mask(
        H, W, d, dtype=jnp.float64) for d in range(4)], 0)
    jp = pack(jnp, j_checker, j_trws.node_gamma(H, W, jnp.float64), jvalid,
              jnp.asarray)
    tp = pack(torch, t_checker,
              t_trws.node_gamma(H, W, torch.float64, device="cpu"),
              t_energy.default_weights(H, W, torch.float64, device="cpu"),
              torch.as_tensor)
    want, wn, wm = j_trws._phase_compact(*jp, s, kernel, tol,
                                         accumulate_lb=True, use_pallas=False)
    got, gn, gm = t_trws._phase_compact(*tp, s, kernel, tol,
                                        accumulate_lb=True)
    for c in (0, 1):
        np.testing.assert_allclose(got[c].numpy(), np.asarray(want[c]),
                                   rtol=0, atol=1e-12)
    np.testing.assert_allclose(float(gn), float(wn), rtol=1e-12)
    np.testing.assert_allclose(float(gm), float(wm), rtol=1e-12)


# ---------------------------------------------- the kernels' hoisted truncation
# The CUDA kernels take the truncation out of their K^2 loop: for a >= 0
#   min_s (h + a * min(c, tol)) == min(min_s (h + a * c), min_s (h + a * tol))
# bit for bit in float32, since rounding is monotone.  These tests hold that
# form against the plain one on the CPU (the kernels themselves are compared
# with the plain versions on the card).
A_CASES = {"random": None, "zero": 0.0, "negzero": -0.0, "tiny": 1e-30,
           "huge": 3e38}


def _cost(d, kernel):
    return d.abs() if kernel == 1 else d * d


def _plain_min(h, xt, ys, a, tol, kernel, target_first):
    """min_s h[s] + a * TR: h, ys [K_s, N]; xt [K_t, N]; a [N] -> [K_t, N]."""
    d = xt[:, None] - ys[None] if target_first else ys[None] - xt[:, None]
    term = a * t_energy.truncated_kernel(d, kernel, tol)
    return (h[None] + term).amin(dim=1)


def _hoisted_min(h, xt, ys, a, tol, kernel, target_first):
    """The same minimum with the truncation out of the loop over s."""
    d = xt[:, None] - ys[None] if target_first else ys[None] - xt[:, None]
    near = (h[None] + a * _cost(d, kernel)).amin(dim=1)
    far = (h + a * tol).amin(dim=0)
    return torch.minimum(near, far[None])


def _bits(t):
    return t.contiguous().view(torch.int32)


def _tol_at(where, diffs, kernel):
    """A float32 tol below every |diff|^kernel, above every one, or at
    their median."""
    c = _cost(diffs, kernel)
    tol = {"below": 0.5 * float(c.min()), "above": 2.0 * float(c.max()),
           "between": float(c.median())}[where]
    return float(np.float32(tol))


def _with_alphas(inp, a_kind):
    out = dict(inp)
    if A_CASES[a_kind] is not None:
        for k in ("a_s", "a_o"):
            out[k] = np.full_like(inp[k], A_CASES[a_kind])
    return out


def _compact_hoisted(gD_s, gDn, M_s, M_o, Q_s, Q_o, D0_s, D0_o, a_s, a_o,
                     valid_s, valid_o, tol, kernel):
    """phase_messages_compact_ref's function in the kernels' hoisted form."""
    K, Hc, W = gD_s.shape
    flat = lambda t: t.reshape(t.shape[0], -1)
    outs = {"s": ([], []), "o": ([], [])}
    for d in range(4):
        for c, h, xt, ys, a, valid, tq in (
                ("s", gD_s - M_s[d], Q_s[d], D0_s, a_s[d], valid_s[d], True),
                ("o", gDn[d] - M_o[d], D0_o, Q_o[d], a_o[d], valid_o[d],
                 False)):
            acc = _hoisted_min(flat(h), flat(xt), flat(ys), a.reshape(-1),
                               tol, kernel, tq).reshape(K, Hc, W)
            vmin = torch.min(acc, dim=0).values
            outs[c][0].append((acc - vmin[None]) * valid[None])
            outs[c][1].append(vmin)
    return (torch.stack(outs["s"][0]), torch.stack(outs["o"][0]),
            torch.stack(outs["s"][1]), torch.stack(outs["o"][1]))


@pytest.mark.parametrize("K", [1, 8, 79])
@pytest.mark.parametrize("tol_at", ["below", "between", "above"])
@pytest.mark.parametrize("a_kind", list(A_CASES))
@pytest.mark.parametrize("kernel", [1, 2])
def test_hoisted_truncation_bitwise(kernel, a_kind, tol_at, K):
    """The hoisted form equals the plain form bit for bit in float32, for
    both operand orders, and gives phase_messages_compact_ref's bits."""
    rng = np.random.default_rng(K + 10 * kernel)
    N = 64
    h = torch.as_tensor(rng.uniform(-2, 2, (K, N)).astype(np.float32))
    xt, ys = (torch.as_tensor(rng.uniform(-3, 3, (K, N)).astype(np.float32))
              for _ in range(2))
    a = torch.as_tensor(rng.uniform(0, 2, N).astype(np.float32)
                        if A_CASES[a_kind] is None
                        else np.full(N, A_CASES[a_kind], np.float32))
    tol = _tol_at(tol_at, xt[:, None] - ys[None], kernel)
    for tq in (True, False):
        want = _plain_min(h, xt, ys, a, tol, kernel, tq)
        got = _hoisted_min(h, xt, ys, a, tol, kernel, tq)
        assert torch.equal(_bits(got), _bits(want))

    inp = _with_alphas(testing.phase_inputs(K + kernel, K, 3, 5), a_kind)
    args = [torch.as_tensor(inp[k]) for k in COMPACT_ARGS]
    diffs = torch.cat([(args[4][:, :, None] - args[6][None, None]).flatten(),
                       (args[5][:, :, None] - args[7][None, None]).flatten()])
    tol = _tol_at(tol_at, diffs, kernel)
    want = t_pk.phase_messages_compact_ref(*args, tol, kernel)
    got = _compact_hoisted(*args, tol, kernel)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("kernel", [1, 2])
def test_hoisted_truncation_fails_for_negative_alpha(kernel):
    """With a < 0 the hoisted form is wrong (the minimum over the truncation
    becomes a maximum), which is why the kernels walk the plain term at such
    a pixel; that per-pixel choice gives the plain bits on a problem with
    both signs."""
    h = torch.tensor([[0.0], [0.0]])
    xt = torch.tensor([[0.0]])
    ys = torch.tensor([[0.0], [5.0]])
    a = torch.tensor([-1.0])
    want = _plain_min(h, xt, ys, a, 1.0, kernel, True)
    got = _hoisted_min(h, xt, ys, a, 1.0, kernel, True)
    assert float(want) == -1.0 and float(got) == -5.0 * (5.0 if kernel == 2
                                                          else 1.0)
    rng = np.random.default_rng(kernel)
    K, N = 17, 96
    h, xt, ys = (torch.as_tensor(rng.uniform(-3, 3, (K, N)).astype(
        np.float32)) for _ in range(3))
    a = torch.as_tensor((rng.uniform(0.5, 2, N) * np.where(
        rng.uniform(size=N) < 1 / 3, -1, 1)).astype(np.float32))
    tol = 1.1 if kernel == 1 else 0.9
    want = _plain_min(h, xt, ys, a, tol, kernel, False)
    got = torch.where(a[None] >= 0,
                      _hoisted_min(h, xt, ys, a, tol, kernel, False),
                      _plain_min(h, xt, ys, a, tol, kernel, False))
    assert torch.equal(_bits(got), _bits(want))
    assert not torch.equal(_hoisted_min(h, xt, ys, a, tol, kernel, False),
                           want)
