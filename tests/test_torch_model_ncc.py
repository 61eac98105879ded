"""The slice as a whole: the same textured random pair and the same
proposals through stereo_tpu.models.ncc.DispMapNCC and the port's, on the
CPU in float64.  Binary fusion sweep: energy trace rtol 1e-9, assignment
equal; simultaneous fusion (checkerboard, banded with 8 x 8 blocks, and the
raster wavefront): (E, lb, iters) rtol 1e-9, labels (the resulting plane
field) equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_tpu import geometry as j_geometry
from stereo_tpu.models.ncc import DispMapNCC as JDispMapNCC
from stereo_tpu_torch import convert, testing
from stereo_tpu_torch import geometry as t_geometry
from stereo_tpu_torch.models.ncc import DispMapNCC as TDispMapNCC

torch.set_num_threads(1)

H, W = 40, 56
DISPARITIES = np.arange(0, 7)
KW = dict(kernel=1, unary_weight=40.0, tol=8.0, maxiter=24, check_every=4)
CENTERS = [(x, y) for x in (10, 30, 50) for y in (10, 30)]


@pytest.fixture(scope="module")
def models():
    im0, im1 = testing.textured_pair(1, H, W, shift=3)
    jm = JDispMapNCC([im0, im1], DISPARITIES, **KW)
    tm = TDispMapNCC([im0, im1], DISPARITIES, **KW, device="cpu")
    jp = [jm.generate_new_plane_RANSAC(x, y, 5.0) for x, y in CENTERS]
    tp = [tm.generate_new_plane_RANSAC(x, y, 5.0) for x, y in CENTERS]
    for d in (0, 3, 6):
        jp.append(j_geometry.fronto_parallel(H, W, float(d), jm.dtype))
        tp.append(t_geometry.fronto_parallel(H, W, float(d), tm.dtype,
                                             device="cpu"))
    return jm, tm, jp, tp


def test_setup_matches(models):
    jm, tm, jp, tp = models
    assert tm.dtype == torch.float64 and tm.device.type == "cpu"
    np.testing.assert_allclose(tm.ncc.numpy(), np.asarray(jm.ncc), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(tm.best_disp().numpy(),
                               np.asarray(jm.best_disp()), rtol=1e-9)
    # The WTA parabola's vertex falls exactly between two grid disparities
    # where the volume's zeroed left columns give two equal samples; the two
    # packages round it to either side, the nearest-index tie then flips and
    # the unary of that pixel differs.  So energies are compared on a shared
    # assignment (see _restart_both), the vertices themselves to rtol 1e-9.
    _restart_both(jm, tm)
    np.testing.assert_allclose(tm.energy(), jm.energy(), rtol=1e-9)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7,
                                   atol=1e-9)
    np.testing.assert_allclose(
        tm.unary_map(tp[0]).numpy(),
        np.asarray(jm.unary_map(jnp.asarray(tp[0].numpy()))), rtol=1e-9,
        atol=1e-9)  # w * (1 - ncc) cancels where ncc ~ 1
    np.testing.assert_allclose(tm.current_dispmap().numpy(),
                               np.asarray(jm.current_dispmap()), rtol=1e-9)


def _restart_both(jm, tm):
    """Restart both models, then hand the port the JAX initial assignment."""
    jm.restart()
    tm.restart()
    np.testing.assert_allclose(tm.assignment.numpy(),
                               np.asarray(jm.assignment), rtol=1e-9,
                               atol=1e-12)
    tm.assignment = np.asarray(jm.assignment)


def _shared_proposals(models):
    """The JAX proposals, handed to both (fits agree only to ~1e-7)."""
    jm, tm, jp, _ = models
    return jp, [torch.as_tensor(np.asarray(p)) for p in jp]


def test_binary_fusion_sweep_then_simultaneous(models):
    jm, tm, _, _ = models
    jp, tp = _shared_proposals(models)
    _restart_both(jm, tm)
    e0 = tm.energy()
    je = jm.binary_fusion_sweep(jp, chunk=len(jp))
    te = tm.binary_fusion_sweep(tp, chunk=4)  # chunking must not matter
    np.testing.assert_allclose(te, je, rtol=1e-9)
    assert all(b <= a + 1e-9 for a, b in zip([e0] + te, te))
    np.testing.assert_array_equal(tm.assignment.numpy(),
                                  np.asarray(jm.assignment))
    np.testing.assert_allclose(tm.energy(), jm.energy(), rtol=1e-9)

    _restart_both(jm, tm)
    jE, jlb, jit = jm.simultaneous_fusion(jp)
    tE, tlb, tit = tm.simultaneous_fusion(tp)
    assert tit == jit
    np.testing.assert_allclose([tE, tlb], [jE, jlb], rtol=1e-9)
    assert tlb <= tE
    np.testing.assert_array_equal(tm.assignment.numpy(),
                                  np.asarray(jm.assignment))
    # the stored energy is the energy of the stored assignment
    tm.assignment = tm.assignment
    np.testing.assert_allclose(tm.energy(), tE, rtol=1e-9)


def test_simultaneous_fusion_banded_schedule(models):
    """schedule="banded", 8 x 8 blocks (40 x 56 = 5 x 7 blocks): the port's
    model against the JAX model, from a shared assignment and proposals."""
    jm, tm, _, _ = models
    jp, tp = _shared_proposals(models)
    _restart_both(jm, tm)
    jm.schedule = tm.schedule = "banded"
    jm.band = tm.band = 8
    try:
        jE, jlb, jit = jm.simultaneous_fusion(jp)
        tE, tlb, tit = tm.simultaneous_fusion(tp)
        assert tit == jit
        np.testing.assert_allclose([tE, tlb], [jE, jlb], rtol=1e-9)
        assert tlb <= tE
        np.testing.assert_array_equal(tm.assignment.numpy(),
                                      np.asarray(jm.assignment))
        tm.assignment = tm.assignment
        np.testing.assert_allclose(tm.energy(), tE, rtol=1e-9)
        # chunked driving warm-starts the banded state: same trajectory
        tm.restart()
        tm.assignment = np.asarray(_restart_jax(jm))
        tm.solver_chunk_banded = 8
        chunked = tm.simultaneous_fusion(tp)
        np.testing.assert_allclose(chunked[:2], [tE, tlb], rtol=1e-9)
        assert chunked[2] == tit
    finally:
        jm.schedule = tm.schedule = "checkerboard"
        tm.solver_chunk_banded = 400
    # the constructor takes the schedule too; every schedule is ported
    im0, im1 = testing.textured_pair(1, H, W, shift=3)
    dm = TDispMapNCC([im0, im1], DISPARITIES, **KW, schedule="banded",
                     device="cpu")
    assert dm.schedule == "banded" and dm.band == 128
    assert dm.solver_chunk_banded == 400
    dm = TDispMapNCC([im0, im1], DISPARITIES, **KW, schedule="scanline",
                     device="cpu")
    assert dm.schedule == "scanline" and dm.solver_chunk_scanline == 50
    dm = TDispMapNCC([im0, im1], DISPARITIES, **KW, schedule="wavefront",
                     device="cpu")
    assert dm.schedule == "wavefront" and dm.solver_chunk_wavefront == 150
    with pytest.raises(ValueError):
        TDispMapNCC([im0, im1], DISPARITIES, **KW, schedule="zigzag",
                    device="cpu")


def test_simultaneous_fusion_wavefront_schedule(models):
    """schedule="wavefront": the port's model against the JAX model, from a
    shared assignment and proposals."""
    jm, tm, _, _ = models
    jp, tp = _shared_proposals(models)
    _restart_both(jm, tm)
    jm.schedule = tm.schedule = "wavefront"
    jm.maxiter = tm.maxiter = 8
    try:
        jE, jlb, jit = jm.simultaneous_fusion(jp)
        tE, tlb, tit = tm.simultaneous_fusion(tp)
        assert tit == jit
        np.testing.assert_allclose([tE, tlb], [jE, jlb], rtol=1e-9)
        assert tlb <= tE
        np.testing.assert_array_equal(tm.assignment.numpy(),
                                      np.asarray(jm.assignment))
        tm.assignment = tm.assignment
        np.testing.assert_allclose(tm.energy(), tE, rtol=1e-9)
        # chunked driving warm-starts the messages: same trajectory
        tm.restart()
        tm.assignment = np.asarray(_restart_jax(jm))
        tm.solver_chunk_wavefront = 4
        chunked = tm.simultaneous_fusion(tp)
        np.testing.assert_allclose(chunked[:2], [tE, tlb], rtol=1e-9)
        assert chunked[2] == tit
    finally:
        jm.schedule = tm.schedule = "checkerboard"
        jm.maxiter = tm.maxiter = KW["maxiter"]
        tm.solver_chunk_wavefront = 150


def _restart_jax(jm):
    jm.restart()
    return jm.assignment


def test_single_move_and_chunked_solver(models):
    jm, tm, _, _ = models
    jp, tp = _shared_proposals(models)
    _restart_both(jm, tm)
    for j, t in zip(jp[:3], tp[:3]):
        je, jlb = jm.binary_fusion(j)
        te, tlb = tm.binary_fusion(t)
        np.testing.assert_allclose([te, tlb], [je, jlb], rtol=1e-9)
    np.testing.assert_array_equal(tm.assignment.numpy(),
                                  np.asarray(jm.assignment))
    with pytest.raises(ValueError):
        tm.binary_fusion(tp[0][:, :5])
    # chunked driving warm-starts the messages: same trajectory
    tm.restart()
    whole = tm.simultaneous_fusion(tp)
    tm.restart()
    tm.solver_chunk = 8
    chunked = tm.simultaneous_fusion(tp)
    tm.solver_chunk = 300
    np.testing.assert_allclose(chunked[:2], whole[:2], rtol=1e-9)
    assert chunked[2] == whole[2]


def test_fuse_until_convergence(models):
    jm, tm, _, _ = models
    jp, tp = _shared_proposals(models)
    _restart_both(jm, tm)
    jn = jm.binary_fuse_until_convergence(jp, seed=3, chunk=8)
    tn = tm.binary_fuse_until_convergence(tp, seed=3, chunk=8)
    assert tn == jn
    np.testing.assert_allclose(tm.energy(), jm.energy(), rtol=1e-9)
    np.testing.assert_array_equal(tm.assignment.numpy(),
                                  np.asarray(jm.assignment))


def test_convert_injects_jax_state(models):
    """The JAX volume, assignment and weights carried across as numpy: the
    fusion moves are compared apart from volume building."""
    jm, _, _, _ = models
    jp, tp = _shared_proposals(models)
    jm.restart()
    jm.binary_fusion_sweep(jp[:4], chunk=4)
    im = [np.asarray(i) for i in jm.images]
    tm = convert.dispmap_ncc_from_numpy(
        im, DISPARITIES, KW["kernel"], KW["unary_weight"], KW["tol"],
        ncc=np.asarray(jm.ncc), assignment=np.asarray(jm.assignment),
        smooth_weights=np.asarray(jm.smooth_weights), device="cpu",
        maxiter=KW["maxiter"], check_every=KW["check_every"])
    assert torch.equal(tm.ncc, torch.as_tensor(np.asarray(jm.ncc)))
    np.testing.assert_allclose(tm.energy(), jm.energy(), rtol=1e-12)
    je = jm.binary_fusion_sweep(jp[4:], chunk=8)
    te = tm.binary_fusion_sweep(tp[4:], chunk=8)
    np.testing.assert_allclose(te, je, rtol=1e-9)
    np.testing.assert_array_equal(tm.assignment.numpy(),
                                  np.asarray(jm.assignment))


def test_convert_problem_from_numpy():
    from stereo_tpu.solvers import trws as j_trws
    from stereo_tpu_torch.solvers import trws as t_trws

    prob = testing.trws_problem(2, 3, 6, 7)
    kw = dict(kernel=1, tol=1.0, maxiter=2, max_relgap=0.0)
    first = j_trws.solve(*[jnp.asarray(a) for a in prob], **kw,
                         use_pallas=False)
    *tensors, msgs = convert.problem_from_numpy(
        *prob, messages=np.asarray(first.messages), device="cpu")
    assert all(t.dtype == torch.float64 for t in tensors)
    got = t_trws.solve(*tensors, **kw, messages=msgs)
    want = j_trws.solve(*[jnp.asarray(a) for a in prob], **kw,
                        messages=first.messages, use_pallas=False)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(float(got.energy), float(want.energy),
                               rtol=1e-10)
    with pytest.raises(ValueError):
        convert.problem_from_numpy(prob[0], prob[1][:2], prob[2], prob[3],
                                   device="cpu")
