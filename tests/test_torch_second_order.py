"""The slice as a whole: stereo_tpu_torch.models.second_order against
stereo_tpu.models.second_order on the CPU.

The JAX model's state — images, P, segmentation, start field — is carried
across by ``convert.second_order_from_numpy``, so both packages fuse from
the same state.  Both run their device terms (images, unary, curvature,
projections) in float32, the JAX model by its own casts, and their fusion
tables and QPBO in float64 on the host.  Tolerances:
- ``second_diff_map`` / ``curvature_map``: equal;
- carried triple weights: equal;
- energies: 1e-5 relative (float32 sums in two orders, and the photo
  costs' exp / log an ulp apart between the two CPU libraries);
- fields after each fusion, the per-move numbers and the update maps:
  equal;
- ``segpln_scalar_proposals``' conversion (own disparity, clip) on the same
  plane fields: 1e-12 relative (the JAX package jits own_disparity, whose
  compiler may contract a multiply-add)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_tpu.config import CVPR08Options as JOptions
from stereo_tpu.models import second_order as j_so
from stereo_tpu.proposals import segpln as j_segpln
from stereo_tpu_torch import convert
from stereo_tpu_torch.config import CVPR08Options as TOptions
from stereo_tpu_torch.models import second_order as t_so

torch.set_num_threads(1)

RTOL = 1e-5
SCHEDULE = ("sweep_ftb", "smooth", "fronto", "random")


def _pair(H=12, W=16, shift=2, seed=0):
    rng = np.random.default_rng(seed)
    im0 = np.clip(rng.uniform(0, 255, (H, W, 3)) * 0.5
                  + np.linspace(0, 255, W)[None, :, None] * 0.5, 0, 255)
    im1 = np.roll(im0, -shift, axis=1)
    P = np.zeros((2, 3, 4))
    P[:, :, :3] = np.eye(3)
    P[1, 0, 3] = -1.0
    return [im0, im1], P


def _models(seed=1, **opt):
    images, P = _pair()
    jm = j_so.SecondOrderStereo(images, P, (0, 4), 1, JOptions(**opt),
                                seed=seed)
    tm = convert.second_order_from_numpy(
        images, P, (0, 4), 1, TOptions(**opt), segments=jm.seg,
        start=jm._start, device="cpu")
    return jm, tm


@pytest.mark.parametrize("offset", [(0, 1), (1, 0), (1, 1), (-1, 1)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_second_diff_map_matches_jax(offset, dtype):
    d = np.random.default_rng(0).uniform(0, 9, (7, 9)).astype(dtype)
    want = np.asarray(j_so.second_diff_map(jnp.asarray(d), *offset))
    got = t_so.second_diff_map(torch.as_tensor(d), *offset).numpy()
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, want)
    for axis in (0, 1):
        np.testing.assert_array_equal(
            t_so.curvature_map(torch.as_tensor(d), axis).numpy(),
            np.asarray(j_so.curvature_map(jnp.asarray(d), axis)))


@pytest.mark.parametrize("visibility,connect,kernel", [
    (True, 4, 1), (True, 8, 1), (False, 4, 1), (False, 8, 1), (False, 4, 2)])
def test_optimize_matches_jax(visibility, connect, kernel):
    jm, tm = _models(visibility=visibility, connect=connect,
                     smoothness_kernel=kernel)
    assert tm.device.type == "cpu" and tm.disp.dtype == torch.float32
    for g, w in zip(tm.triple_weights, jm.triple_weights):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tm.disp.numpy(), np.asarray(jm.disp))
    np.testing.assert_allclose(tm.energy(), jm.energy(), rtol=RTOL)
    np.testing.assert_array_equal(
        tm.smooth_map(tm.disp).numpy(),
        np.asarray(jm.smooth_map(jm.disp)))
    j_info, t_info = {}, {}
    want = jm.optimize(schedule=SCHEDULE, max_iters=4, seed=0, info=j_info)
    got = tm.optimize(schedule=SCHEDULE, max_iters=4, seed=0, info=t_info)
    assert len(got) == len(want) == 5
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_array_equal(tm.disp.numpy(), np.asarray(jm.disp))
    assert t_info["error"] is None and j_info["error"] is None
    np.testing.assert_array_equal(t_info["numbers"], j_info["numbers"])
    np.testing.assert_array_equal(t_info["map"], j_info["map"])
    assert t_info["timings"].shape == (4, 2)
    assert got[-1] < got[0]


def test_convert_carries_weights_and_field():
    """The JAX model's triple weights and current field carried as they
    are (no segmentation): the same curvature map and energy."""
    jm, _ = _models(visibility=False, connect=8)
    jm.optimize(schedule=SCHEDULE, max_iters=2, seed=1)
    images, P = _pair()
    tm = convert.second_order_from_numpy(
        images, P, (0, 4), 1, TOptions(visibility=False, connect=8),
        triple_weights=jm.triple_weights, start=jm._start,
        disp=np.asarray(jm.disp), device="cpu")
    np.testing.assert_array_equal(tm.disp.numpy(), np.asarray(jm.disp))
    np.testing.assert_array_equal(tm._start, jm._start)
    np.testing.assert_array_equal(tm.smooth_map(tm.disp).numpy(),
                                  np.asarray(jm.smooth_map(jm.disp)))
    np.testing.assert_allclose(tm.energy(), jm.energy(), rtol=RTOL)
    with pytest.raises(ValueError, match="not both"):
        convert.second_order_from_numpy(
            images, P, (0, 4), 1, TOptions(), segments=jm.seg,
            triple_weights=jm.triple_weights, device="cpu")


def test_optimize_swallows_a_later_failure_into_info():
    """As in the JAX package: a failure on the first fusion raises; a later
    one ends the loop and is recorded in info['error']; a failing
    save_progress sink is ignored."""
    _, tm = _models(visibility=False)

    def boom(it):
        if it == 2:
            raise ValueError("boom")
        return "fronto"

    info = {}
    seen = []

    def sink(it, d):
        seen.append((it, d.shape))
        raise OSError("disk full")

    es = tm.optimize(schedule=[boom], max_iters=5, info=info,
                     save_progress=sink)
    assert len(es) == 3 and isinstance(info["error"], ValueError)
    assert seen == [(0, (12, 16)), (1, (12, 16))]
    with pytest.raises(ValueError, match="boom"):
        tm.optimize(schedule=[lambda it: boom(2)], max_iters=2)


def test_ojw_stereo_matches_jax(monkeypatch):
    """proposal_method (1, 4): SameUni, then Smooth from a restart; the JAX
    model's segmentation is handed to the port's constructor."""
    images, P = _pair()
    opt = dict(proposal_method=(1, 4), max_iters=3, average_over=2,
               converge=0.0, visibility=False)
    jm, jinfo = j_so.ojw_stereo(images, P, (0, 4), 1, JOptions(**opt),
                                seed=2)
    monkeypatch.setattr(t_so.segmentation, "mean_shift",
                        lambda *a, **k: jm.seg)
    tm, tinfo = t_so.ojw_stereo(images, P, (0, 4), 1, TOptions(**opt),
                                seed=2, device="cpu")
    assert list(tinfo["stages"]) == list(jinfo["stages"]) == [
        "sameuni", "smooth"]
    for name, want in jinfo["stages"].items():
        got = tinfo["stages"][name]
        assert got["error"] is None
        np.testing.assert_allclose(got["energy"], want["energy"], rtol=RTOL)
        np.testing.assert_array_equal(got["D"], want["D"])
        np.testing.assert_array_equal(got["numbers"], want["numbers"])
    np.testing.assert_array_equal(tm.disp.numpy(), np.asarray(jm.disp))


def test_segpln_scalar_proposals_conversion(monkeypatch):
    """The same plane fields handed to both packages in place of a SegPln
    run: own-pixel disparities, clipped to the model's range."""
    jm, tm = _models(visibility=False)
    H, W = tm.sz
    rng = np.random.default_rng(7)
    planes = []
    for i in range(5):
        p = np.zeros((4, H, W))
        p[0], p[1] = rng.normal(0, 0.2, (2, H, W))
        p[2] = rng.uniform(0.5, 2.0, (H, W))
        p[3] = -rng.uniform(-2, 7, (H, W))  # beyond [0, 4] both ways
        planes.append(p)
    calls = []

    def fake(images, Ps, disparities, col_thresh, **kw):
        calls.append((np.asarray(disparities), float(col_thresh),
                      kw["window"], kw["seed"]))
        return [p.copy() for p in planes]

    monkeypatch.setattr(j_segpln, "segpln", fake)
    monkeypatch.setattr(t_so.segpln_mod, "segpln", fake)
    want = j_so.segpln_scalar_proposals(jm, seed=3)
    got = t_so.segpln_scalar_proposals(tm, seed=3)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == np.float64 and g.min() >= 0 and g.max() <= 4
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)
    (jd, jc, jw, js), (td, tc, tw, ts) = calls
    np.testing.assert_array_equal(td, jd)
    assert (tc, tw, ts) == (jc, jw, js) == (30.0, 2, 3)
