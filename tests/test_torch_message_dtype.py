"""Narrow (bfloat16) message storage: the port's checkerboard TRW-S
(``solvers/trws.py``, ``message_dtype``) and the plain versions of its two
phase kernels against the JAX package on the same numpy inputs, CPU; the
JAX package's own bf16 invariants on the port; bf16 state carried across
by ``convert`` and by the checkpoint.

Tolerances: messages bit for bit (compared as int16 views); labels equal;
energy and lower bound rtol 1e-10 in float64 and 1e-5 in float32 (only the
sums' order differs); the phase kernels' minima as
tests/test_torch_phase_kernel.py holds them (XLA:CPU may contract h + a*TR
into an FMA in float32).  In float32 the bits agree at these sizes only:
an ulp of the FMA-contracted float32 moves a message across a bf16
rounding boundary now and then, and over more sweeps on larger problems
the two packages' bf16 messages part; in float64 they stay bit for bit
(``test_long_run_bit_for_bit_and_bf16_decodes``).

The CUDA kernels' narrow storage is held against these plain versions, bit
for bit, in tests/test_torch_cuda.py (marked ``cuda``) and in
chip_smoke.py."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import oracles
from stereo_tpu.ops import phase_kernel as j_pk
from stereo_tpu.solvers import trws as j_trws
from stereo_tpu.utils.checkpoint import Checkpointer as JCheckpointer
from stereo_tpu_torch import convert, testing
from stereo_tpu_torch.ops import phase_kernel as t_pk
from stereo_tpu_torch.solvers import trws as t_trws
from stereo_tpu_torch.utils.checkpoint import Checkpointer as TCheckpointer

torch.set_num_threads(1)

RTOL = {np.float64: 1e-10, np.float32: 1e-5}
ATOL_VMIN = {np.float32: 1.9e-6, np.float64: 1e-12}
COMPACT_ARGS, FULL_ARGS = testing.COMPACT_ARGS, testing.FULL_ARGS


def _problem(kernel, dtype, seed=11):
    """The JAX package's bf16 test problem: 8 x 9, K = 5."""
    rng = np.random.default_rng(seed)
    return [a.astype(dtype)
            for a in oracles.grid_trws_inputs(rng, 8, 9, 5, kernel=kernel)]


def _bits(m) -> np.ndarray:
    """bfloat16 messages of either package as their int16 patterns."""
    if isinstance(m, torch.Tensor):
        assert m.dtype == torch.bfloat16
        return m.view(torch.int16).numpy()
    m = np.asarray(m)
    assert m.dtype == ml_dtypes.bfloat16
    return m.view(np.int16)


def _same(got, want, dtype):
    """(messages, labels, energy, lower bound) of the port and JAX."""
    np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(float(g), float(w), rtol=RTOL[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("kernel", [1, 2])
def test_solve_matches_jax(kernel, compact, dtype):
    prob = _problem(kernel, dtype)
    kw = dict(kernel=kernel, tol=0.8, maxiter=20, max_relgap=0.0,
              compact=compact)
    want = j_trws.solve(*map(jnp.asarray, prob), **kw, use_pallas=False,
                        message_dtype=jnp.bfloat16)
    got = t_trws.solve(*map(torch.as_tensor, prob), **kw,
                       message_dtype=torch.bfloat16)
    assert got.energy.dtype == torch.as_tensor(prob[0]).dtype
    _same((got.messages, got.labels, got.energy, got.lower_bound),
          (want.messages, want.labels, want.energy, want.lower_bound), dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("compact", [False, True])
def test_trws_run_matches_jax(compact, dtype):
    """Two chunks of ``run`` (6 sweeps, a decode every 3) in each package,
    the state carried from the first to the second."""
    prob = _problem(1, dtype, seed=3)
    kw = dict(kernel=1, tol=0.8, compact=compact)
    jr = j_trws.TRWSRun(*map(jnp.asarray, prob), **kw, use_pallas=False,
                        message_dtype=jnp.bfloat16)
    tr = t_trws.TRWSRun(*map(torch.as_tensor, prob), **kw,
                        message_dtype=torch.bfloat16)
    js, ts = jr.init_state(), tr.init_state()
    for _ in range(2):
        js, je, jlb, jl = jr.run(js, 6, decode_every=3)
        ts, te, tlb, tl = tr.run(ts, 6, decode_every=3)
        _same((tr.messages(ts), tl, te, tlb),
              (jr.messages(js), jl, je, jlb), dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kernel", [1, 2])
def test_compact_ref_vs_pallas_interpret(kernel, dtype):
    """bf16 M_s / M_o: the new messages come out in bf16, bit for bit the
    JAX kernel's, and are the float32 result rounded once."""
    K, Hc, W = 5, 5, 9
    inp = testing.phase_inputs(K + kernel, K, Hc, W, dtype)
    for k in ("M_s", "M_o"):
        inp[k] = inp[k].astype(ml_dtypes.bfloat16)
    args = [convert.messages_from_numpy(inp[k], device="cpu")
            if k.startswith("M_") else torch.as_tensor(inp[k])
            for k in COMPACT_ARGS]
    got = t_pk.phase_messages_compact(*args, 1.1, kernel)
    want = j_pk.phase_messages_compact_pallas(
        *(jnp.asarray(inp[k]) for k in COMPACT_ARGS), 1.1, kernel,
        interpret=True)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    for g, w in zip(got[2:], want[2:]):
        assert g.dtype == torch.as_tensor(inp["gD_s"]).dtype
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL_VMIN[dtype])
    wide = [a.to(args[0].dtype) if i in (2, 3) else a
            for i, a in enumerate(args)]
    ref = t_pk.phase_messages_compact_ref(*wide, 1.1, kernel)
    for g, r in zip(got[:2], ref[:2]):
        assert torch.equal(g, r.to(torch.bfloat16))
    for g, r in zip(got[2:], ref[2:]):
        assert torch.equal(g, r)
    assert t_pk.phase_messages_compact.launches == 0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kernel", [1, 2])
def test_full_ref_vs_pallas_interpret(kernel, dtype):
    K, H, W = 4, 6, 9
    inp = testing.phase_inputs_full(5 + kernel, K, H, W, kernel - 1, dtype)
    inp["M"] = inp["M"].astype(ml_dtypes.bfloat16)
    args = [convert.messages_from_numpy(inp[k], device="cpu") if k == "M"
            else torch.as_tensor(inp[k]) for k in FULL_ARGS]
    got = t_pk.phase_messages(*args, 0.9, kernel)
    want = j_pk.phase_messages_pallas(
        *(jnp.asarray(inp[k]) for k in FULL_ARGS), 0.9, kernel,
        interpret=True)
    np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=ATOL_VMIN[dtype])
    wide = [a.to(args[0].dtype) if i == 2 else a for i, a in enumerate(args)]
    ref = t_pk.phase_messages_ref(*wide, 0.9, kernel)
    assert torch.equal(got[0], ref[0].to(torch.bfloat16))
    assert torch.equal(got[1], ref[1])
    assert t_pk.phase_messages.launches == 0


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("kernel", [1, 2])
def test_bf16_invariants(kernel, compact):
    """The JAX package's bf16 test (tests/test_trws.py::
    test_bf16_message_storage_drift_bounded) on the port: lb <= E, the bf16
    lb below the float32 run's E, drift within 3%, a warm start from bf16
    messages that does not lose the bound."""
    prob = [torch.as_tensor(a) for a in _problem(kernel, np.float32)]
    kw = dict(kernel=kernel, tol=0.8, max_relgap=0.0, compact=compact)
    f32 = t_trws.solve(*prob, maxiter=20, **kw)
    b16 = t_trws.solve(*prob, maxiter=20, message_dtype=torch.bfloat16, **kw)
    assert b16.messages.dtype == torch.bfloat16
    assert f32.messages.dtype == torch.float32
    assert float(b16.lower_bound) <= float(b16.energy) + 1e-6
    assert float(b16.lower_bound) <= float(f32.energy) + 1e-6
    assert float(b16.energy) == pytest.approx(float(f32.energy), rel=0.03)
    assert float(b16.lower_bound) == pytest.approx(float(f32.lower_bound),
                                                   rel=0.03)
    cont = t_trws.solve(*prob, maxiter=5, messages=b16.messages,
                        message_dtype=torch.bfloat16, **kw)
    assert cont.messages.dtype == torch.bfloat16
    assert float(cont.lower_bound) >= float(b16.lower_bound) - 1e-4
    # a float32 warm start is rounded into bf16 storage on entry
    r = t_trws.TRWSRun(*prob, kernel=kernel, tol=0.8, compact=compact,
                       message_dtype=torch.bfloat16)
    assert r.messages(r.init_state(f32.messages)).dtype == torch.bfloat16
    assert torch.equal(r.messages(r.init_state(f32.messages)),
                       f32.messages.to(torch.bfloat16))


def test_long_run_bit_for_bit_and_bf16_decodes():
    """100 sweeps on a fusion-like 40 x 52, K = 15 problem in float64: the
    port's bf16 run equals the JAX package's bit for bit, and both decode
    far above float32 storage's energy while their bounds stay close.  The
    last two assertions pin a property of bf16 storage that the port
    inherits (ROADMAP queue 3): it is the reference's behaviour, not the
    port's fault."""
    prob = testing.synthetic_problem(15, 40, 52, seed=4, dtype=np.float64)
    kw = dict(kernel=1, tol=8.0, maxiter=100, max_relgap=0.0,
              check_every=100, compact=True)
    want = j_trws.solve(*map(jnp.asarray, prob), **kw, use_pallas=False,
                        message_dtype=jnp.bfloat16)
    got = t_trws.solve(*map(torch.as_tensor, prob), **kw,
                       message_dtype=torch.bfloat16)
    _same((got.messages, got.labels, got.energy, got.lower_bound),
          (want.messages, want.labels, want.energy, want.lower_bound),
          np.float64)
    wide = t_trws.solve(*map(torch.as_tensor, prob), **kw)
    assert float(want.energy) > 1.5 * float(wide.energy)
    assert float(want.lower_bound) == pytest.approx(
        float(wide.lower_bound), rel=0.03)


def test_warm_start_from_jax_messages():
    """JAX's bf16 messages, carried across by convert, warm-start the port
    as they warm-start JAX; and the port's carried back warm-start JAX."""
    prob = _problem(1, np.float64, seed=5)
    kw = dict(kernel=1, tol=0.8, max_relgap=0.0, compact=False)
    warm = j_trws.solve(*map(jnp.asarray, prob), maxiter=3, **kw,
                        use_pallas=False, message_dtype=jnp.bfloat16)
    *tprob, msgs = convert.problem_from_numpy(
        *prob, np.asarray(warm.messages), device="cpu")
    assert msgs.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(msgs), _bits(warm.messages))
    got = t_trws.solve(*tprob, maxiter=2, messages=msgs,
                       message_dtype=torch.bfloat16, **kw)
    back = convert.messages_to_numpy(msgs).view(ml_dtypes.bfloat16)
    want = j_trws.solve(*map(jnp.asarray, prob), maxiter=2,
                        messages=jnp.asarray(back), **kw, use_pallas=False,
                        message_dtype=jnp.bfloat16)
    _same((got.messages, got.labels, got.energy, got.lower_bound),
          (want.messages, want.labels, want.energy, want.lower_bound),
          np.float64)


def test_convert_round_trips():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 3, (4, 3, 5, 6))
    jm = jnp.asarray(x, jnp.bfloat16)
    t = convert.messages_from_numpy(np.asarray(jm), device="cpu")
    assert t.dtype == torch.bfloat16 and t.shape == (4, 3, 5, 6)
    np.testing.assert_array_equal(_bits(t), _bits(jm))
    # bf16 round to nearest even alike in both packages, float64 and float32
    for src in (x, x.astype(np.float32)):
        np.testing.assert_array_equal(
            _bits(torch.as_tensor(src).to(torch.bfloat16)),
            _bits(jnp.asarray(src).astype(jnp.bfloat16)))
    back = convert.messages_to_numpy(t)
    assert back.dtype == np.dtype("V2")
    np.testing.assert_array_equal(back.view(ml_dtypes.bfloat16),
                                  np.asarray(jm))
    assert torch.equal(convert.messages_from_numpy(back, device="cpu"), t)
    # the problem's messages: bf16 stays bf16 unless asked otherwise; other
    # messages take the problem's dtype, as before
    K, H, W = 3, 5, 6
    u, q, a = np.zeros((K, H, W)), np.zeros((4, K, H, W)), np.zeros((4, H, W))
    *_, m = convert.problem_from_numpy(u, u, q, a, np.asarray(jm),
                                       device="cpu")
    assert torch.equal(m, t)
    *_, m = convert.problem_from_numpy(u, u, q, a, np.asarray(jm),
                                       message_dtype=torch.float32,
                                       device="cpu")
    assert torch.equal(m, t.float())
    *_, m = convert.problem_from_numpy(u, u, q, a, x.astype(np.float16),
                                       device="cpu")
    assert m.dtype == torch.float64
    *_, m = convert.problem_from_numpy(u, u, q, a, x.astype(np.float16),
                                       message_dtype=torch.float16,
                                       device="cpu")
    assert torch.equal(m, torch.as_tensor(x.astype(np.float16)))


def test_checkpoint_of_bf16_messages(tmp_path):
    """One bf16 message state saved by each package: the two ``.npz``
    entries hold the same 2-byte patterns and load alike (``|V2``), and
    convert turns either file back into the same torch tensor."""
    x = np.random.default_rng(1).normal(0, 2, (4, 3, 5, 6))
    jm = jnp.asarray(x, jnp.bfloat16)
    tm = torch.as_tensor(x).to(torch.bfloat16)
    jc = JCheckpointer(str(tmp_path / "jax"), async_save=False)
    tc = TCheckpointer(str(tmp_path / "torch"), async_save=False)
    jc.save(3, {"messages": jm, "it": 3})
    tc.save(3, {"messages": tm, "it": 3})
    (js, jflat), (ts, tflat) = jc.load(), tc.load()
    assert js == ts == 3 and sorted(jflat) == sorted(tflat)
    key = "['messages']"
    assert jflat[key].dtype == tflat[key].dtype == np.dtype("V2")
    assert jflat[key].shape == tflat[key].shape == (4, 3, 5, 6)
    assert jflat[key].tobytes() == tflat[key].tobytes()
    for flat in (jflat, tflat):
        assert torch.equal(
            convert.messages_from_numpy(flat[key], device="cpu"), tm)
    # each package loads the other's file
    for C, other in ((JCheckpointer, "torch"), (TCheckpointer, "jax")):
        _, flat = C(str(tmp_path / other), async_save=False).load()
        assert flat[key].tobytes() == tflat[key].tobytes()


def test_wrapper_storage_dtypes():
    """The storage dtypes the CUDA kernels take, checked before any launch:
    float32, bfloat16, float16; mixed M_s / M_o or float64 storage raise."""
    z = lambda dt: torch.zeros((4, 2, 3, 5), dtype=dt)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        assert t_pk._storage(z(dt), z(dt)) == dt
        assert t_pk._storage(z(dt)) == dt
    assert sorted(t_pk.MESSAGE_DTYPES.values()) == ["bf16", "f16", "f32"]
    with pytest.raises(ValueError, match="one dtype"):
        t_pk._storage(z(torch.bfloat16), z(torch.float32))
    with pytest.raises(ValueError, match="no CUDA kernel stores"):
        t_pk._storage(z(torch.float64))
    with pytest.raises(ValueError, match="no CUDA kernel stores"):
        t_pk._storage(z(torch.float64), z(torch.float64))
