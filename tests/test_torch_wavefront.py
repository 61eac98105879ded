"""stereo_tpu_torch.solvers.wavefront vs stereo_tpu.solvers.wavefront (its
scan path and its Pallas kernel in interpret mode) and vs the sequential numpy
oracle under the raster order.  CPU, same numpy inputs.

Tolerances.  float64: layouts exact; messages atol 1e-10; energy and lower
bound rel 1e-10; labels equal (the two packages add the incident buffers in
the same order, so in practice they agree to the last few bits).  float32
against the Pallas kernel: rtol 1e-5 / atol 1e-5 on messages, rtol 1e-5 /
atol 1e-4 on the bound, as tests/test_wavefront_kernel.py holds that kernel
to its own scan path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles
from stereo_tpu.ops import wavefront_kernel as j_wfk
from stereo_tpu.solvers import banded as j_banded
from stereo_tpu.solvers import wavefront as j_wf
from stereo_tpu_torch import convert, testing
from stereo_tpu_torch.ops import wavefront_kernel as t_wfk
from stereo_tpu_torch.ops.minplus import TILE
from stereo_tpu_torch.solvers import banded as t_banded
from stereo_tpu_torch.solvers import wavefront as t_wf

torch.set_num_threads(1)

T = lambda arrs: [torch.as_tensor(a) for a in arrs]
J = lambda arrs: [jnp.asarray(a) for a in arrs]

# (H, W): H < W, H > W, square, a single row, a single column, two rows
SIZES = [(4, 7), (8, 5), (5, 5), (1, 6), (6, 1), (2, 9)]


def _skewed(K, H, W, kernel=1, tol=1.0, dtype=np.float64, seed=0):
    prob = testing.trws_problem(seed + K + H, K, H, W, dtype)
    return (prob, j_wf._Skewed(*J(prob), kernel, tol),
            t_wf._Skewed(*T(prob), kernel, tol))


def _assert_groups(tM, jM, atol, rtol=0):
    for a, b in zip(tM, jM):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                   atol=atol)


# ------------------------------------------------------------------ layouts
@pytest.mark.parametrize("H,W", SIZES)
def test_skewed_fields_gamma_and_groups_match_jax(H, W):
    K = 3
    prob, jsk, tsk = _skewed(K, H, W)
    assert (tsk.K, tsk.H, tsk.W, tsk.T) == (jsk.K, jsk.H, jsk.W, jsk.T)
    shapes = t_wfk.problem_shapes(K, H, W)
    for f in j_wf._Skewed._ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(tsk, f).numpy(),
                                      np.asarray(getattr(jsk, f)), err_msg=f)
        assert getattr(tsk, f).is_contiguous(), f
        assert tuple(getattr(tsk, f).shape) == shapes[f], f
    np.testing.assert_array_equal(
        t_wf.raster_gamma(H, W, torch.float64, "cpu").numpy(),
        np.asarray(j_wf.raster_gamma(H, W, jnp.float64)))
    M = np.random.default_rng(H).random((4, K, H, W))
    tM = t_wf.messages_to_groups(torch.as_tensor(M), W)
    jM = j_wf.messages_to_groups(jnp.asarray(M), W)
    _assert_groups(tM, jM, atol=0)
    assert tuple(tM[0].shape) == shapes["MA"] and tM[1].is_contiguous()
    np.testing.assert_array_equal(t_wf.groups_to_messages(*tM, W).numpy(), M)
    np.testing.assert_array_equal(
        np.asarray(j_wf.groups_to_messages(*jM, W)), M)


def test_shifts_and_tlead_roundtrip():
    v = torch.arange(12.0).reshape(3, 4)
    assert t_wf._shift_down(v)[:, 0].abs().sum() == 0
    assert torch.equal(t_wf._shift_down(v)[:, 1:], v[:, :-1])
    assert t_wf._shift_up(v)[:, -1].abs().sum() == 0
    assert torch.equal(t_wf._shift_up(v)[:, :-1], v[:, 1:])
    a = torch.as_tensor(np.random.default_rng(1).random((2, 3, 5, 7)))
    cols = t_wf._tlead(a, 7)
    assert tuple(cols.shape) == (5 + 7 - 1 + 2, 2, 3, 5)
    assert float(cols[0].abs().sum()) == float(cols[-1].abs().sum()) == 0.0
    assert torch.equal(t_wf._tlead_inv(cols, 7), a)
    np.testing.assert_array_equal(cols.numpy(),
                                  np.asarray(j_wf._tlead(jnp.asarray(
                                      a.numpy()), 7)))


# ------------------------------------------------------------------- oracle
@pytest.mark.parametrize("kernel", [1, 2])
@pytest.mark.parametrize("seed,H,W,K", [(0, 4, 5, 3), (1, 3, 6, 4),
                                        (2, 5, 5, 2), (3, 1, 6, 3),
                                        (4, 6, 1, 3)])
def test_matches_sequential_raster_oracle(kernel, seed, H, W, K):
    """Wavefront == sequential raster TRW-S: energies, bounds and labels
    match the oracle to fp roundoff, every iteration."""
    rng = np.random.default_rng(seed)
    theta, D0, Q, alphas = oracles.grid_trws_inputs(rng, H, W, K,
                                                    kernel=kernel)
    tol = 1.0
    theta_flat, edges = oracles.grid_edges_for_oracle(theta, D0, Q, alphas)
    oracle = oracles.SequentialTRWS(theta_flat, edges, list(range(H * W)),
                                    kernel, tol)
    msgs = None
    for it in range(5):
        res = t_wf.solve_wavefront(
            *T((theta, D0, Q, alphas)), kernel=kernel, tol=tol, maxiter=1,
            max_relgap=0.0, messages=msgs)
        msgs = res.messages
        oE, oLB, oLab = oracle.iterate()
        assert float(res.lower_bound) == pytest.approx(
            oLB, rel=1e-10, abs=1e-10), f"iter {it}"
        assert float(res.energy) == pytest.approx(
            oE, rel=1e-10, abs=1e-10), f"iter {it}"
        np.testing.assert_array_equal(res.labels.numpy().ravel(), oLab,
                                      f"iter {it}")
        assert res.labels.dtype == torch.int32


# ------------------------------------------------------------ the JAX solver
@pytest.mark.parametrize("kernel,K,H,W", [(1, 3, 7, 9), (2, 4, 8, 5),
                                          (1, 5, 2, 6)])
def test_one_and_two_sweeps_match_jax(kernel, K, H, W):
    prob = testing.trws_problem(K + W, K, H, W)
    kw = dict(kernel=kernel, tol=1.3, max_relgap=0.0)
    for sweeps in (1, 2):
        want = j_wf.solve_wavefront(*J(prob), **kw, maxiter=sweeps,
                                    check_every=sweeps, use_pallas=False)
        got = t_wf.solve_wavefront(*T(prob), **kw, maxiter=sweeps,
                                   check_every=sweeps)
        np.testing.assert_array_equal(got.labels.numpy(),
                                      np.asarray(want.labels))
        np.testing.assert_allclose(float(got.energy), float(want.energy),
                                   rtol=1e-10)
        np.testing.assert_allclose(float(got.lower_bound),
                                   float(want.lower_bound), rtol=1e-10)
        np.testing.assert_allclose(got.messages.numpy(),
                                   np.asarray(want.messages), rtol=0,
                                   atol=1e-10)
        assert got.iterations == int(want.iterations) == sweeps


def test_stopping_rule_matches_jax():
    prob = testing.trws_problem(5, 3, 8, 9)
    kw = dict(kernel=1, tol=1.0, maxiter=40, max_relgap=3e-2, check_every=2)
    want = j_wf.solve_wavefront(*J(prob), **kw, use_pallas=False)
    got = t_wf.solve_wavefront(*T(prob), **kw)
    assert 0 < got.iterations < 40  # the relgap rule fired, at the same sweep
    assert got.iterations == int(want.iterations)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(float(got.energy), float(want.energy),
                               rtol=1e-10)
    np.testing.assert_allclose(float(got.lower_bound),
                               float(want.lower_bound), rtol=1e-10)


def _jax_problem32(K, H, W, seed=0):
    """The inputs of tests/test_wavefront_kernel.py (weights not zeroed at
    the borders: the validity masks must do that)."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 5, (K, H, W))
    D0 = rng.uniform(0, 10, (K, H, W))
    Q = D0[None] + rng.normal(0, 0.3, (4, K, H, W))
    alphas = rng.uniform(0.5, 2.0, (4, H, W))
    return tuple(a.astype(np.float32) for a in (theta, D0, Q, alphas))


@pytest.mark.parametrize("K,H,W,kernel", [(3, 6, 9, 1), (4, 7, 6, 2),
                                          (3, 8, 7, 1)])
def test_plain_sweep_matches_pallas_kernel_interpret(K, H, W, kernel):
    """float32: the port's plain sweep (the CUDA kernel's reference) against
    the TPU kernel run in interpret mode: one sweep from zero messages, one
    from the warm state."""
    tol = 1.5
    prob = _jax_problem32(K, H, W)
    jsk = j_wf._Skewed(*J(prob), kernel, tol)
    tsk = t_wf._Skewed(*T(prob), kernel, tol)
    zeros = np.zeros((4, K, H, W), np.float32)
    jM = j_wf.messages_to_groups(jnp.asarray(zeros), W)
    tM = t_wf.messages_to_groups(torch.as_tensor(zeros), W)
    sweep_fn = j_wfk.make_sweep(jsk, interpret=True)
    before = t_wfk.sweep_wavefront.launches
    for _ in range(2):
        jM, jlb = sweep_fn(jM)
        tM, tlb = t_wfk.sweep_wavefront(tsk, tM)  # CPU: the plain sweep
        assert tlb.dtype == torch.float32
        np.testing.assert_allclose(float(tlb), float(jlb), rtol=1e-5,
                                   atol=1e-4)
        _assert_groups(tM, jM, atol=1e-5, rtol=1e-5)
    assert t_wfk.sweep_wavefront.launches == before


# ---------------------------------------------------------------- invariants
def test_invariants_and_warm_start():
    """Monotone lb, lb <= E; maxiter=2 == two chained maxiter=1 solves."""
    prob = T(testing.trws_problem(7, 4, 10, 12))
    kw = dict(kernel=1, tol=1.0, max_relgap=0.0)
    lbs, msgs = [], None
    for _ in range(8):
        res = t_wf.solve_wavefront(*prob, maxiter=1, messages=msgs, **kw)
        msgs = res.messages
        lbs.append(float(res.lower_bound))
        assert float(res.lower_bound) <= float(res.energy) + 1e-9
    for a, b in zip(lbs, lbs[1:]):
        assert b >= a - 1e-9, f"lb decreased: {a} -> {b}"

    a2 = t_wf.solve_wavefront(*prob, maxiter=2, check_every=2, **kw)
    r1 = t_wf.solve_wavefront(*prob, maxiter=1, **kw)
    r2 = t_wf.solve_wavefront(*prob, maxiter=1, messages=r1.messages, **kw)
    assert float(a2.energy) == pytest.approx(float(r2.energy), rel=1e-12)
    assert float(a2.lower_bound) == pytest.approx(float(r2.lower_bound),
                                                  rel=1e-12)
    assert torch.equal(a2.labels, r2.labels)
    # the warm start is not written to
    before = r1.messages.clone()
    t_wf.solve_wavefront(*prob, maxiter=1, messages=r1.messages, **kw)
    assert torch.equal(r1.messages, before)


@pytest.mark.parametrize("H,W", SIZES)
def test_steps_and_fused_sweeps_agree_on_cpu(H, W):
    """Both are plain PyTorch on the CPU; with and without ``use_kernel``
    all four give the same state."""
    prob = T(testing.trws_problem(H, 3, H, W))
    kw = dict(kernel=2, tol=0.9, maxiter=2, max_relgap=0.0, check_every=2)
    ref = t_wf.solve_wavefront(*prob, **kw)
    for sweep in ("fused", "steps"):
        for use_kernel in (True, False):
            got = t_wf.solve_wavefront(*prob, **kw, sweep=sweep,
                                       use_kernel=use_kernel)
            assert torch.equal(got.messages, ref.messages)
            assert torch.equal(got.labels, ref.labels)
            assert float(got.lower_bound) == float(ref.lower_bound)
    with pytest.raises(ValueError, match="sweep"):
        t_wf.solve_wavefront(*prob, **kw, sweep="scan")
    assert t_wf.sends_per_sweep(H + W - 1) == 2 * (H + W - 1)


def test_a_sweep_updates_the_state_in_place_and_keeps_dead_edges():
    K, H, W = 3, 5, 6
    prob, _, tsk = _skewed(K, H, W)
    M = np.random.default_rng(2).random((4, K, H, W))
    MA, MB = t_wf.messages_to_groups(torch.as_tensor(M), W)
    (MA2, MB2), lb = t_wf._sweep_steps(tsk, (MA, MB))
    assert MA2 is MA and MB2 is MB and lb.dtype == torch.float64
    out = t_wf.groups_to_messages(MA, MB, W).numpy()
    # an edge without a neighbour keeps the message it was given
    np.testing.assert_array_equal(out[t_wf.LT][:, :, 0], M[t_wf.LT][:, :, 0])
    np.testing.assert_array_equal(out[t_wf.RT][:, :, -1],
                                  M[t_wf.RT][:, :, -1])
    np.testing.assert_array_equal(out[t_wf.UP][:, 0], M[t_wf.UP][:, 0])
    np.testing.assert_array_equal(out[t_wf.DN][:, -1], M[t_wf.DN][:, -1])
    assert not np.array_equal(out[t_wf.LT][:, :, 1:], M[t_wf.LT][:, :, 1:])


# ------------------------------------------------------------------- decode
@pytest.mark.parametrize("kernel,K,H,W", [(1, 3, 7, 9), (2, 4, 8, 5),
                                          (1, 3, 1, 6)])
def test_decode_raster_matches_jax(kernel, K, H, W):
    _, jsk, tsk = _skewed(K, H, W, kernel=kernel, tol=1.2)
    M = np.random.default_rng(K).random((4, K, H, W))
    jl, je = j_wf.decode_raster(jsk, j_wf.messages_to_groups(
        jnp.asarray(M), W))
    tl, te = t_wf.decode_raster(tsk, t_wf.messages_to_groups(
        torch.as_tensor(M), W))
    assert tl.dtype == torch.int32 and tuple(tl.shape) == (H, W)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(float(te), float(je), rtol=1e-10)


def test_decode_raster_breaks_ties_to_the_lowest_label():
    K, H, W = 4, 3, 4
    z = torch.zeros((K, H, W), dtype=torch.float64)
    sk = t_wf._Skewed(z, z, torch.zeros((4, K, H, W), dtype=torch.float64),
                      torch.as_tensor(testing.border_weights(H, W)), 1, 1.0)
    labels, e = t_wf.decode_raster(sk, t_wf.messages_to_groups(
        torch.zeros((4, K, H, W), dtype=torch.float64), W))
    assert int(labels.abs().sum()) == 0 and float(e) == 0.0


@pytest.mark.parametrize("H,W,Bh,Bw", [(7, 9, 3, 4), (6, 5, 6, 5)])
def test_banded_run_raster_decode_matches_jax(H, W, Bh, Bw):
    prob = testing.trws_problem(H + W, 3, H, W)
    kw = dict(kernel=1, tol=1.0, Bh=Bh, Bw=Bw)
    jrun = j_banded.BandedRun(*J(prob), **kw, use_pallas=False,
                              decode="raster")
    trun = t_banded.BandedRun(*T(prob), **kw, decode="raster")
    jstate, je, jlb, jl = jrun.run(jrun.init_state(), 4, decode_every=2)
    tstate, te, tlb, tl = trun.run(trun.init_state(), 4, decode_every=2)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(float(te), float(je), rtol=1e-10)
    np.testing.assert_allclose(float(tlb), float(jlb), rtol=1e-10)
    # the banded decode of the same state is another labeling's energy, and
    # the sweeps do not depend on the decode
    brun = t_banded.BandedRun(*T(prob), **kw)
    _, be, blb, _ = brun.run(brun.init_state(), 4, decode_every=2)
    assert float(blb) == float(tlb)
    if (Bh, Bw) == (H, W):  # one block: the banded order is the raster order
        assert float(be) == pytest.approx(float(te), rel=1e-12)
    with pytest.raises(ValueError, match="decode"):
        t_banded.BandedRun(*T(prob), **kw, decode="zigzag")


# ------------------------------------------------- state across the packages
def test_convert_carries_the_groups_both_ways():
    """Two sweeps in the JAX package, its groups carried over, one more
    sweep in each: same state; and back again."""
    K, H, W = 3, 6, 8
    prob, jsk, tsk = _skewed(K, H, W)
    first = j_wf.solve_wavefront(*J(prob), kernel=1, tol=1.0, maxiter=2,
                                 check_every=2, max_relgap=0.0,
                                 use_pallas=False)
    jM = j_wf.messages_to_groups(first.messages, W)
    tM = convert.wavefront_groups_from_numpy(jM, device="cpu")
    assert tM[0].dtype == torch.float64 and tM[0].is_contiguous()
    want = j_wf.solve_wavefront(*J(prob), kernel=1, tol=1.0, maxiter=1,
                                max_relgap=0.0, messages=first.messages,
                                use_pallas=False)
    tM, tlb = t_wfk.sweep_wavefront(tsk, tM)
    np.testing.assert_allclose(float(tlb), float(want.lower_bound),
                               rtol=1e-10)
    np.testing.assert_allclose(t_wf.groups_to_messages(*tM, W).numpy(),
                               np.asarray(want.messages), rtol=0, atol=1e-10)
    MA, MB = convert.wavefront_groups_to_numpy(tM)
    jl, je = j_wf.decode_raster(jsk, (jnp.asarray(MA), jnp.asarray(MB)))
    np.testing.assert_array_equal(np.asarray(jl), np.asarray(want.labels))
    np.testing.assert_allclose(float(je), float(want.energy), rtol=1e-10)
    with pytest.raises(ValueError, match="MA and MB"):
        convert.wavefront_groups_from_numpy((MA, MB[:-1]), device="cpu")
    with pytest.raises(ValueError, match="MA and MB"):
        convert.wavefront_groups_from_numpy((MA[:, :1], MB[:, :1]),
                                            device="cpu")


def test_kernel_limits_are_stated_and_checked():
    """The kernel takes every K (no label limit is left) and every T >= 1."""
    assert not hasattr(t_wfk, "MAX_K")
    assert t_wfk.MIN_T == 1 and t_wfk.LB_SLOTS == 5
    t_wfk.check_limits(1)
    with pytest.raises(ValueError, match="at least"):
        t_wfk.check_limits(0)
    shapes = t_wfk.problem_shapes(5, 4, 7)
    assert shapes["MA"] == shapes["QB"] == (12, 2, 5, 4)
    assert shapes["gamma"] == (12, 4) and shapes["aA"] == (12, 2, 4)


# -------------------------------------- the wait rule of the fused sweep
# H > W, W > H, a single row, a single column, and more than one tile of
# live lanes (40 x 47, 70 x 33)
WAIT_SIZES = [(9, 5), (5, 9), (1, 7), (7, 1), (40, 47), (70, 33)]


def _job_lanes(H, W, t, backward, seg, tile):
    """Target lanes of job (seg, tile) of step t's phase B, as
    csrc/wavefront_kernel.cu::sends_step enumerates them: heads (seg 0, 1)
    at the step's live lanes, tails (seg 2, 3) at those of the step they
    write into."""
    step = t if seg < 2 else (t - 1 if backward else t + 1)
    lo, hi = t_wfk.live_lanes(H, W, step)
    lanes = lo + tile * TILE + np.arange(TILE)
    return lanes[lanes < hi]


def _capture_step(sk, t, backward, monkeypatch):
    """Run one plain step on zero messages with the sends replaced by a
    recorder: gD = lane + 1 at label 0 (and 0 at label 1, so the backward
    step's minimum is 0), so each send's source holds at every lane the gD
    lane it reads (+1, 0 = none); every send writes 1, so the entries that
    change are what the step writes.  -> ((MA, MB), sources by segment)."""
    sources = []

    def fake(problems, *args, **kw):
        out = []
        for src, old, *_ in problems:
            sources.append(src)
            shape = torch.broadcast_shapes(src.shape, old.shape)
            out.append((torch.ones(shape, dtype=old.dtype),
                        torch.zeros(shape[:-2] + shape[-1:],
                                    dtype=old.dtype)))
        return out

    monkeypatch.setattr(t_wf, "_sends", fake)
    sk.theta.zero_()
    sk.theta[t + 1, 0] = torch.arange(1, sk.H + 1, dtype=sk.theta.dtype)
    sk.gamma.fill_(1.0)
    M = tuple(torch.zeros_like(a) for a in (sk.QA, sk.QB))
    if backward:
        M, _ = t_wf._bwd_col(sk, M, t)
    else:
        M = t_wf._fwd_col(sk, M, t)
    monkeypatch.undo()
    heads, tails = sources  # [1 | 2, K, H] each
    return M, {0: heads[0, 0], 1: heads[-1, 0], 2: tails[0, 0],
               3: tails[1, 0]}


def _readers(psk, t, backward, group, d):
    """Lanes of step t's phase A (the plain _beliefs_col, live lanes only)
    that read each lane of message group ``group`` (0: MA, 1: MB) at the
    column the step's sends write it: the group holds a one-hot at (label
    k, lane k), so belief (k, l) is non-zero iff lane l reads lane k.
    -> {lane k: set of reading lanes}."""
    H, c = psk.H, t + 1
    M = [torch.zeros_like(psk.QA), torch.zeros_like(psk.QB)]
    heads = 1 if backward else 0
    col = c if group == heads else (c - 1 if backward else c + 1)
    M[group][col, d] = torch.eye(psk.K, dtype=M[group].dtype)[:, :H]
    D = t_wf._beliefs_col(psk, *M, c)
    lo, hi = t_wfk.live_lanes(H, psk.W, t)
    hit = D[:, lo:hi].numpy() != 0
    return {k: set((lo + np.flatnonzero(hit[k])).tolist())
            for k in range(H) if hit[k].any()}


@pytest.mark.parametrize("H,W", WAIT_SIZES)
def test_wait_rule_covers_every_dependency(H, W, monkeypatch):
    """ops/wavefront_kernel.py::wait_lanes (the rule by which the fused
    sweep's phase-B jobs wait for phase A) against the plain version's own
    index maps: for every step, pass, job and written lane, the gD lane the
    job reads and every lane of phase A that reads the message it overwrites
    lie in the job's wait set."""
    sk = t_wf._Skewed(*T(testing.trws_problem(0, 2, H, W)), 1, 1.0)
    # the probe problem: one label per lane, theta = 0
    psk = t_wf._Skewed(*T(testing.trws_problem(0, max(H, 2), H, W)), 1, 1.0)
    psk.theta.zero_()
    tiles = lambda n: -(-n // TILE)
    checked = 0
    for backward in (False, True):
        heads, tails = (1, 0) if backward else (0, 1)
        for t in range(sk.T):
            (MA, MB), src = _capture_step(sk, t, backward, monkeypatch)
            c = t + 1
            cn = c - 1 if backward else c + 1
            lo, hi = t_wfk.live_lanes(H, W, t)
            tlo, thi = t_wfk.live_lanes(H, W, t - 1 if backward else t + 1)
            groups = (MA, MB)
            for seg in range(4):
                group, d = (heads, seg) if seg < 2 else (tails, seg - 2)
                col = c if seg < 2 else cn
                written = set(np.flatnonzero(
                    groups[group][col, d, 0].numpy() != 0).tolist())
                readers = _readers(psk, t, backward, group, d)
                n = tiles(hi - lo) if seg < 2 else tiles(thi - tlo)
                for tile in range(n):
                    wlo, whi = t_wfk.wait_lanes(H, W, t, backward, seg, tile)
                    assert lo <= wlo and whi <= hi
                    lanes = _job_lanes(H, W, t, backward, seg, tile)
                    for x in lanes:
                        if x not in written:
                            continue  # not written: a dead edge
                        ls = int(src[seg][x]) - 1
                        where = (H, W, t, backward, seg, tile, x)
                        assert lo <= ls < hi, ("gD lane not live", where)
                        assert wlo <= ls < whi, ("gD lane not waited", where)
                        for r in readers.get(x, ()):
                            assert wlo <= r < whi, ("reader not waited",
                                                    where, r)
                        checked += 1
                    written.difference_update(lanes.tolist())
                # every written lane belongs to some job of its segment
                assert not written, (t, backward, seg, written)
    assert checked > 0
