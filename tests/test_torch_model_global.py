"""The slice as a whole: stereo_tpu.models.global_stereo.DispMapGlobalStereo
and the port's on tests/test_model_global.py's 30 x 44 pair, on the CPU in
float64, with the JAX model's start field and segmentation carried across by
convert.dispmap_global_from_numpy: weights equal, initial energy within
1e-10 relative, three fronto-parallel binary fusions and
binary_fuse_until_convergence with energies within 1e-10 and equal labels,
simultaneous fusion at K = 15 on the checkerboard and banded schedules
(energy and bound within 1e-10, labels equal), and the truncated-quadratic
smoothness end to end.  The port's own segmentation of the pair is held
against the JAX package's too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_tpu import geometry as j_geometry
from stereo_tpu.config import CVPR08Options as JOptions
from stereo_tpu.models.global_stereo import DispMapGlobalStereo as JModel
from stereo_tpu_torch import convert
from stereo_tpu_torch import geometry as t_geometry
from stereo_tpu_torch.config import CVPR08Options as TOptions
from stereo_tpu_torch.models.global_stereo import DispMapGlobalStereo as TModel
from test_model_global import make_pair

torch.set_num_threads(1)

KW = dict(maxiter=16, check_every=4)
RTOL = 1e-10


def _carried(jm, images, P, options, **kw):
    return convert.dispmap_global_from_numpy(
        images, P, (0, 6), 1, options, device="cpu",
        start_disparity=np.asarray(jm.start_disparity),
        segments=jm.segments, **KW, **kw)


@pytest.fixture(scope="module")
def models():
    images, P = make_pair()
    jm = JModel(images, P, (0, 6), 1, JOptions(), seed=3, **KW)
    tm = _carried(jm, images, P, TOptions())
    return jm, tm, images, P


def _proposals(H, W, n=14, seed=5):
    """Fronto-parallel and slanted planes across the disparity range."""
    rng = np.random.default_rng(seed)
    props = []
    for i in range(n):
        d = 6.0 * i / (n - 1)
        a, b = rng.normal(0, 0.02, 2) if i % 2 else (0.0, 0.0)
        p = np.zeros((4, H, W))
        p[0], p[1], p[2] = a, b, 1.0
        p[3] = -(d - a * W / 2 - b * H / 2)
        props.append(p)
    return props


def _same_state(jm, tm):
    np.testing.assert_allclose(tm.energy(), jm.energy(), rtol=RTOL)
    np.testing.assert_array_equal(tm.assignment.numpy(),
                                  np.asarray(jm.assignment))


def test_setup_matches(models):
    jm, tm, _, _ = models
    assert tm.dtype == torch.float64 and tm.device.type == "cpu"
    np.testing.assert_array_equal(tm.disps, jm.disps)
    assert (tm.d_min, tm.d_step, tm.normalize) == (jm.d_min, jm.d_step,
                                                   jm.normalize)
    assert tm.tol == jm.tol and tm.improve == jm.improve
    np.testing.assert_array_equal(tm.smooth_weights.numpy(),
                                  np.asarray(jm.smooth_weights))
    np.testing.assert_array_equal(tm.start_disparity.numpy(),
                                  np.asarray(jm.start_disparity))
    jm.restart()
    tm.restart()
    _same_state(jm, tm)


def test_own_segmentation_matches(models):
    """Without the carried state: the port's own mean-shift segmentation of
    the pair (float32 LUV within a few ulp of the JAX package's) gives the
    JAX package's labels, hence its weights and energy."""
    jm, _, images, P = models
    own = TModel(images, P, (0, 6), 1, TOptions(), seed=3, device="cpu",
                 **KW)
    share = (own.segments == jm.segments).mean()
    print(f"own segmentation: {share:.4f} of labels equal to the JAX "
          f"package's ({len(np.unique(own.segments))} segments)")
    assert share == 1.0
    np.testing.assert_allclose(own.energy(), jm.energy(), rtol=RTOL)


def test_unary_map_matches(models):
    jm, tm, _, _ = models
    H, W = tm.sz
    p = _proposals(H, W)[3]
    np.testing.assert_allclose(
        tm.unary_map(torch.as_tensor(p)).numpy(),
        np.asarray(jm.unary_map(jnp.asarray(p))), rtol=0, atol=1e-12)


def test_fronto_parallel_fusions(models):
    jm, tm, _, _ = models
    jm.restart()
    tm.restart()
    H, W = tm.sz
    for d in (0.0, 3.0, 6.0):
        ej, lbj = jm.binary_fusion(j_geometry.fronto_parallel(H, W, d,
                                                              jm.dtype))
        et, lbt = tm.binary_fusion(t_geometry.fronto_parallel(
            H, W, d, tm.dtype, device="cpu"))
        np.testing.assert_allclose(et, ej, rtol=RTOL)
        np.testing.assert_allclose(lbt, lbj, rtol=RTOL)
        _same_state(jm, tm)


def test_fuse_until_convergence(models):
    jm, tm, _, _ = models
    jm.restart()
    tm.restart()
    props = _proposals(*tm.sz)
    nj = jm.binary_fuse_until_convergence([jnp.asarray(p) for p in props],
                                          seed=0)
    nt = tm.binary_fuse_until_convergence(props, seed=0)
    assert nt == nj
    _same_state(jm, tm)


@pytest.mark.parametrize("schedule", ["checkerboard", "banded"])
def test_simultaneous_fusion_k15(models, schedule):
    jm, tm, _, _ = models
    props = _proposals(*tm.sz)
    for m in (jm, tm):
        m.restart()
        m.schedule, m.band = schedule, 8
    ej, lbj, itj = jm.simultaneous_fusion([jnp.asarray(p) for p in props])
    et, lbt, itt = tm.simultaneous_fusion(props)
    assert len(props) + 1 == 15 and itt == itj
    np.testing.assert_allclose(et, ej, rtol=RTOL)
    np.testing.assert_allclose(lbt, lbj, rtol=RTOL)
    assert lbt <= et
    _same_state(jm, tm)


def test_truncated_quadratic_end_to_end():
    """smoothness_kernel=2: weights / tol, tol squared (:410-413), the same
    weights and energy as the JAX package; three fronto-parallel fusions
    never raise the energy, and the JAX package's energy of the port's
    fused labelling is the port's."""
    images, P = make_pair()
    jm = JModel(images, P, (0, 6), 1, JOptions(smoothness_kernel=2), seed=1,
                **KW)
    tm = _carried(jm, images, P, TOptions(smoothness_kernel=2))
    assert tm.tol == pytest.approx(TOptions().disp_thresh ** 2) == jm.tol
    np.testing.assert_array_equal(tm.smooth_weights.numpy(),
                                  np.asarray(jm.smooth_weights))
    _same_state(jm, tm)
    H, W = tm.sz
    e0 = tm.energy()
    for d in (0.0, 3.0, 6.0):
        e, _ = tm.binary_fusion(t_geometry.fronto_parallel(
            H, W, d, tm.dtype, device="cpu"))
        assert e <= e0
        e0 = e
    assert e0 < jm.energy()
    jm.assignment = jnp.asarray(tm.assignment.numpy())
    np.testing.assert_allclose(tm.energy(), jm.energy(), rtol=RTOL)


def test_smooth_weights_carried(models):
    """convert takes the weights themselves as well as the segmentation."""
    jm, _, images, P = models
    tm = convert.dispmap_global_from_numpy(
        images, P, (0, 6), 1, TOptions(), device="cpu",
        start_disparity=np.asarray(jm.start_disparity),
        smooth_weights=np.asarray(jm.smooth_weights), **KW)
    jm.restart()
    _same_state(jm, tm)
    with pytest.raises(ValueError, match="not both"):
        convert.dispmap_global_from_numpy(
            images, P, (0, 6), 1, device="cpu", segments=jm.segments,
            smooth_weights=np.asarray(jm.smooth_weights))


def test_reference_image_checked():
    images, P = make_pair()
    P = P.copy()
    P[0, 0, 0] = 2.0
    with pytest.raises(ValueError, match="reference"):
        TModel(images, P, (0, 6), 1, device="cpu")


def test_default_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    images, P = make_pair()
    with pytest.raises(RuntimeError, match="cuda"):
        TModel(images, P, (0, 6), 1)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.dispmap_global_from_numpy(images, P, (0, 6), 1)
