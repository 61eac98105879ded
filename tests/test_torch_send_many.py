"""stereo_tpu_torch.ops.minplus.minplus_send_many (its plain version; the CUDA
kernel is held against it on the card, bit for bit, in
tests/test_torch_cuda.py and chip_smoke.py), the descriptors its CUDA path
hands the kernel, the hoisted truncation of the send and pair kernels, and
the one send call per step of the two steps paths.

Tolerances: the plain version against minplus_send_ref on the pre-subtracted
heights, and the hoisted forms against the plain ones, bit for bit (int32
views of float32); float64 against the dense numpy formula atol 1e-12;
float32 against the JAX package's Pallas send kernel in interpret mode rtol
1e-5 / atol 1e-6 (its docstring allows 1-2 ulp of contraction noise)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_tpu.ops import minplus as j_minplus
from stereo_tpu_torch import testing
from stereo_tpu_torch.energy import truncated_kernel
from stereo_tpu_torch.ops import minplus as t_mp
from stereo_tpu_torch.solvers import banded as t_banded
from stereo_tpu_torch.solvers import wavefront as t_wf

torch.set_num_threads(1)

T = lambda a: torch.as_tensor(a)


def _step(seed, K, dtype=np.float32, negative=0.0):
    """Eight problems of mixed L: a banded step's six (L = 53, its y-seam
    tail-send Lp = 130) and a wavefront step's two (L = 96)."""
    return (testing.send_step_problems(seed, K, 53, "banded", Lp=130,
                                       dtype=dtype, to=T, negative=negative)
            + testing.send_step_problems(seed + 1, K, 96, "wavefront",
                                         dtype=dtype, to=T,
                                         negative=negative))


def _dense(h, xt, ys, alpha, tol, kernel):
    """msg[t] = min_s h[s] + alpha * TR(xt[t] - ys[s]), numpy, [..., K, L]."""
    d = xt[..., None, :, :] - ys[..., :, None, :]  # [.., s, t, L]
    tr = np.minimum(np.abs(d) if kernel == 1 else d * d, tol)
    acc = (h[..., :, None, :] + alpha[..., None, None, :] * tr).min(axis=-3)
    vmin = acc.min(axis=-2)
    return acc - vmin[..., None, :], vmin


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kernel", [1, 2])
@pytest.mark.parametrize("K", [1, 8, 79])
def test_plain_version_per_problem(K, kernel, dtype):
    """Each problem's result is minplus_send_ref of h = g - m subtracted
    beforehand (bit for bit), and the dense formula (float64); the CPU call
    launches nothing."""
    problems = _step(K, K, dtype)
    before = t_mp.minplus_send.launches
    got = t_mp.minplus_send_many(problems, 0.9, kernel)
    assert t_mp.minplus_send.launches == before and len(got) == 8
    for (g, m, xt, ys, alpha), (msg, vmin) in zip(problems, got):
        lead = torch.broadcast_shapes(g.shape[:-2], m.shape[:-2],
                                      xt.shape[:-2], alpha.shape[:-1])
        assert msg.shape == lead + xt.shape[-2:] and vmin.shape == (
            lead + xt.shape[-1:])
        hs = T(np.ascontiguousarray(g.numpy() - m.numpy()))
        ref = t_mp.minplus_send_ref(hs, xt, ys, alpha, 0.9, kernel)
        assert torch.equal(_bits(msg), _bits(ref[0]))
        assert torch.equal(_bits(vmin), _bits(ref[1]))
        if dtype == np.float64:
            dm, dv = _dense(hs.numpy(), xt.numpy(), ys.numpy(),
                            alpha.numpy(), 0.9, kernel)
            np.testing.assert_allclose(msg.numpy(), np.broadcast_to(
                dm, msg.shape), rtol=0, atol=1e-12)
            np.testing.assert_allclose(vmin.numpy(), np.broadcast_to(
                dv, vmin.shape), rtol=0, atol=1e-12)


@pytest.mark.parametrize("kernel", [1, 2])
@pytest.mark.parametrize("K", [1, 8, 79])
def test_plain_version_vs_pallas_send_interpret(K, kernel):
    """The interior head-send of a step (g and ys read at batch stride 0)
    against the JAX package's Pallas send: batch entry 0 with kernel 1,
    entry 1 with kernel 2 (one interpret-mode call a case)."""
    problems = testing.send_step_problems(K + kernel, K, 53, "wavefront",
                                          to=T)
    g, m, xt, ys, alpha = problems[0]
    (msg, vmin), = t_mp.minplus_send_many(problems[:1], 1.1, kernel)
    for b in (kernel - 1,):
        jm, jv = j_minplus.minplus_send_pallas(
            jnp.asarray((g[0] - m[b]).numpy()), jnp.asarray(xt[b].numpy()),
            jnp.asarray(ys[0].numpy()), jnp.asarray(alpha[b].numpy()), 1.1,
            kernel, interpret=True)
        np.testing.assert_allclose(msg[b].numpy(), np.asarray(jm), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(vmin[b].numpy(), np.asarray(jv),
                                   rtol=1e-5, atol=1e-6)


def _read(ptr, b, k, shape, tensors):
    """The [B, K, L] (or [B, L]) array a descriptor entry points at, read
    through its strides from whichever of ``tensors`` holds the pointer."""
    for t in tensors:
        if t is None:
            continue
        st = t.untyped_storage()
        if st.data_ptr() <= ptr < st.data_ptr() + st.nbytes():
            flat = torch.empty(0, dtype=t.dtype).set_(st)
            strides = (b, k, 1) if len(shape) == 3 else (b, 1)
            return flat.as_strided(shape, strides,
                                   (ptr - st.data_ptr()) // 4)
    raise AssertionError("pointer outside every tensor")


def test_descriptors_read_operands_in_place():
    """The descriptors of a banded and a wavefront step (18 int64 words a
    problem, csrc/minplus_send.cu::Problem) point into the solver's own
    tensors, broadcast operands at batch stride 0 and the y-seam m through
    its label stride, with no copy; each reads back its operand, and the
    outputs are the returned views.  Two leading axes are flattened."""
    K = 5
    problems = _step(3, K)
    words, results, keep = t_mp._describe(problems, torch.device("cpu"))
    desc = np.frombuffer(words, dtype=np.int64).reshape(len(problems), 18)
    for i, (prob, (msg, vmin)) in enumerate(zip(problems, results)):
        d = desc[i]
        L, B = int(d[16]), int(d[17])
        assert L == prob[2].shape[-1] and B == (2 if i in (0, 1, 6, 7)
                                                else 1)
        for j, t in enumerate(prob[:4]):
            ptr, bs, ks = int(d[j]), int(d[7 + 2 * j]), int(d[8 + 2 * j])
            assert ptr == t.data_ptr()  # no copy
            if t.dim() == 2 or t.shape[0] == 1:
                assert bs == 0
            want = t.expand((B, K, L))
            assert torch.equal(_read(ptr, bs, ks, (B, K, L), [t]), want)
        a = prob[4]
        assert torch.equal(_read(int(d[4]), int(d[15]), 0, (B, L), [a]),
                           a.expand((B, L)))
        assert int(d[5]) == msg.data_ptr() and int(d[6]) == vmin.data_ptr()
        assert msg.is_contiguous() and vmin.is_contiguous()
    # the banded y-seam head-send's m: a slice of a [K, Lp] array
    assert int(desc[3][10]) == 130 and int(desc[3][8]) == 53
    # two leading axes [2, 3] and a broadcast [3] -> one batch of 6
    hs, p, r, alpha = map(T, testing.send_inputs(5, 3, K, 7))
    g2, xt2 = hs[None].expand(2, 3, K, 7).contiguous(), p[None]
    words, results, keep = t_mp._describe(
        [(g2, None, xt2, r, alpha)], torch.device("cpu"))
    d = np.frombuffer(words, dtype=np.int64)
    assert int(d[1]) == 0 and int(d[17]) == 6
    assert tuple(results[0][0].shape) == (2, 3, K, 7)
    assert torch.equal(_read(int(d[2]), int(d[11]), int(d[12]), (6, K, 7),
                             keep), xt2.expand(2, 3, K, 7).reshape(6, K, 7))


def test_send_many_rejects_what_the_kernel_does_not_take():
    problems = _step(1, 4)
    with pytest.raises(ValueError, match="problems"):
        t_mp.minplus_send_many(problems + problems[:1], 1.0, 1)
    with pytest.raises(ValueError, match="problems"):
        t_mp.minplus_send_many([], 1.0, 1)
    with pytest.raises(ValueError, match="kernel"):
        t_mp.minplus_send_many(problems, 1.0, 3)
    cpu = torch.device("cpu")
    g, m, xt, ys, alpha = problems[2]
    with pytest.raises(ValueError, match="float32"):
        t_mp._describe([(g.double(), m, xt, ys, alpha)], cpu)
    with pytest.raises(ValueError, match="shape"):
        t_mp._describe([(g, m[:-1], xt, ys, alpha)], cpu)
    with pytest.raises(ValueError, match="broadcast"):
        t_mp._describe([(g, m.expand(2, -1, -1), xt, ys,
                         alpha.expand(3, -1))], cpu)
    # lanes that are not contiguous are copied, not refused
    wide = T(np.random.default_rng(0).uniform(size=(4, 2 * g.shape[-1]))
             .astype(np.float32))
    _, _, keep = t_mp._describe([(g, m, xt, wide[:, ::2], alpha)], cpu)
    assert keep[3].is_contiguous() and torch.equal(keep[3], wide[:, ::2])


# ------------------------------------------- the kernels' hoisted truncation
# The send and pair kernels take the truncation out of their K^2 loops: for
# a >= 0,
#   min_s (h + a * min(c, tol)) == min(min_s (h + a * c), min_s (h + a * tol))
# bit for bit in float32, since rounding is monotone; the pair applies it to
# both outputs.  A lane or pixel with a < 0 walks the plain term.
A_CASES = {"random": None, "zero": 0.0, "negzero": -0.0, "tiny": 1e-30,
           "huge": 3e38}


def _cost(d, kernel):
    return d.abs() if kernel == 1 else d * d


def _tol_at(where, diffs, kernel):
    """A float32 tol below every |diff|^kernel, above every one, or at
    their median."""
    c = _cost(diffs, kernel)
    tol = {"below": 0.5 * float(c.min()), "above": 2.0 * float(c.max()),
           "between": float(c.median())}[where]
    return float(np.float32(tol))


def _hoisted_send(h, xt, ys, a, tol, kernel, hoist):
    """The send in the kernel's form: h, xt, ys [K, N], a [N]; the lanes
    where ``hoist`` is False walk the plain term.  -> (msg, vmin, the
    un-normalised minimum)."""
    d = xt[None] - ys[:, None]  # [s, t, N]
    near = (h[:, None] + a * _cost(d, kernel)).amin(dim=0)
    far = (h + a * tol).amin(dim=0)
    plain = (h[:, None] + a * truncated_kernel(d, kernel, tol)).amin(dim=0)
    acc = torch.where(hoist, torch.minimum(near, far[None]), plain)
    vmin = acc.amin(dim=0)
    return acc - vmin[None], vmin, acc


def _hoisted_pair(HA, HB, P, R, a, tol, kernel, hoist):
    """The pair in the kernel's form: [K, N] each, a [N]."""
    d = P[:, None] - R[None]  # [i, j, N]
    term = a * _cost(d, kernel)
    plain = a * truncated_kernel(d, kernel, tol)
    nearA = (HA[:, None] + term).amin(dim=0)
    nearB = (HB[None] + term).amin(dim=1)
    farA, farB = (HA + a * tol).amin(dim=0), (HB + a * tol).amin(dim=0)
    msgA = torch.where(hoist, torch.minimum(nearA, farA[None]),
                       (HA[:, None] + plain).amin(dim=0))
    msgB = torch.where(hoist, torch.minimum(nearB, farB[None]),
                       (HB[None] + plain).amin(dim=1))
    return msgA, msgB


def _inputs(K, kernel, a_kind, tol_at, N=64):
    rng = np.random.default_rng(K + 10 * kernel)
    h, g, xt, ys = (T(rng.uniform(lo, 3, (K, N)).astype(np.float32))
                    for lo in (-2, -2, -3, -3))
    a = T(rng.uniform(0, 2, N).astype(np.float32) if A_CASES[a_kind] is None
          else np.full(N, A_CASES[a_kind], np.float32))
    tol = _tol_at(tol_at, xt[None] - ys[:, None], kernel)
    return h, g, xt, ys, a, tol


@pytest.mark.parametrize("K", [1, 8, 79])
@pytest.mark.parametrize("tol_at", ["below", "between", "above"])
@pytest.mark.parametrize("a_kind", list(A_CASES))
@pytest.mark.parametrize("kernel", [1, 2])
def test_send_hoisted_truncation_bitwise(kernel, a_kind, tol_at, K):
    """The send's hoisted form gives minplus_send_ref's bits."""
    h, _, xt, ys, a, tol = _inputs(K, kernel, a_kind, tol_at)
    want = t_mp.minplus_send_ref(h, xt, ys, a, tol, kernel)
    got = _hoisted_send(h, xt, ys, a, tol, kernel, torch.ones_like(a) > 0)
    for g_, w in zip(got[:2], want):
        assert torch.equal(_bits(g_), _bits(w))


@pytest.mark.parametrize("K", [1, 8, 79])
@pytest.mark.parametrize("tol_at", ["below", "between", "above"])
@pytest.mark.parametrize("a_kind", list(A_CASES))
@pytest.mark.parametrize("kernel", [1, 2])
def test_pair_hoisted_truncation_bitwise(kernel, a_kind, tol_at, K):
    """The pair's hoisted form gives minplus_pair_ref's bits, both
    outputs."""
    HA, HB, P, R, a, tol = _inputs(K, kernel, a_kind, tol_at)
    want = t_mp.minplus_pair_ref(HA, HB, P, R, a, tol, kernel)
    got = _hoisted_pair(HA, HB, P, R, a, tol, kernel, torch.ones_like(a) > 0)
    for g_, w in zip(got, want):
        assert torch.equal(_bits(g_), _bits(w))


@pytest.mark.parametrize("kernel", [1, 2])
def test_hoisted_truncation_fails_for_negative_alpha(kernel):
    """With a < 0 the hoisted form is wrong (the minimum over the
    truncation becomes a maximum), which is why the kernels walk the plain
    term at such a lane; that per-lane choice gives the plain bits on data
    with both signs, for the send and for both outputs of the pair."""
    # two sources (h = 0; at 0 and 5), two targets at 0, a = -1, tol = 1:
    # the plain minimum is -1, the hoisted one -5^kernel
    z = torch.zeros((2, 1))
    xt, ys = torch.zeros((2, 1)), torch.tensor([[0.0], [5.0]])
    a, far = torch.tensor([-1.0]), -5.0 ** kernel
    _, _, acc = _hoisted_send(z, xt, ys, a, 1.0, kernel, torch.tensor([True]))
    plain = (z[:, None] + a * truncated_kernel(xt[None] - ys[:, None], kernel,
                                               1.0)).amin(dim=0)
    assert plain.tolist() == [[-1.0], [-1.0]] and acc.tolist() == [[far]] * 2
    hA, _ = _hoisted_pair(z, z, ys, xt, a, 1.0, kernel, torch.tensor([True]))
    pA, _ = t_mp.minplus_pair_ref(z, z, ys, xt, a, 1.0, kernel)
    assert pA.tolist() == [[-1.0], [-1.0]] and hA.tolist() == [[far]] * 2
    rng = np.random.default_rng(kernel)
    K, N = 17, 96
    h, HB, xt, ys = (T(rng.uniform(-3, 3, (K, N)).astype(np.float32))
                     for _ in range(4))
    a = T(np.where(rng.uniform(size=N) < 1 / 3, -1.0, 1.0).astype(np.float32)
          * rng.uniform(0.5, 2.0, N).astype(np.float32))
    hoist = a >= 0
    for g_, w in zip(_hoisted_send(h, xt, ys, a, 1.1, kernel, hoist)[:2],
                     t_mp.minplus_send_ref(h, xt, ys, a, 1.1, kernel)):
        assert torch.equal(_bits(g_), _bits(w))
    for g_, w in zip(_hoisted_pair(h, HB, xt, ys, a, 1.1, kernel, hoist),
                     t_mp.minplus_pair_ref(h, HB, xt, ys, a, 1.1, kernel)):
        assert torch.equal(_bits(g_), _bits(w))


# ------------------------------------------- one send call per solver step
@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("schedule", ["banded", "wavefront"])
def test_steps_sweep_sends_once_per_step(schedule, use_kernel, monkeypatch):
    """One sweep="steps" sweep calls the gathered send (its plain version
    with use_kernel=False) once a step: 2T calls, as sends_per_sweep says,
    each with the step's six (banded) or two (wavefront) problems."""
    K, H, W = 3, 9, 11
    prob = [T(a) for a in testing.trws_problem(2, K, H, W, np.float32)]
    name = "minplus_send_many" if use_kernel else "minplus_send_many_ref"
    real, calls = getattr(t_wf, name), []

    def count(problems, tol, kernel):
        calls.append(len(problems))
        return real(problems, tol, kernel)

    monkeypatch.setattr(t_wf, name, count)
    if schedule == "banded":
        spec = t_banded.BandedSpec(H, W, 4, 5)
        bp = t_banded._BandedProblem(*prob, spec, 1, 1.0)
        state = t_banded.messages_to_state(torch.zeros((4, K, H, W)), bp)
        t_banded._sweep_steps(bp, state, use_kernel)
        T2, per_call = 2 * spec.T, 6
        assert t_banded.sends_per_sweep(spec) == T2
    else:
        sk = t_wf._Skewed(*prob, 1, 1.0)
        M = t_wf.messages_to_groups(torch.zeros((4, K, H, W)), W)
        t_wf._sweep_steps(sk, M, use_kernel)
        T2, per_call = 2 * (H + W - 1), 2
        assert t_wf.sends_per_sweep(H + W - 1) == T2
    assert calls == [per_call] * T2
