"""The Woodford unary, the RSSD volume, the filters and samplers they use,
and the SegPln proposals of the port against the JAX package's, on the CPU
in float64: unary and volume within 1e-12, filters and samplers equal,
WTA disparity, plane fits and the SegPln stream (two mults) equal on equal
inputs; the stream does not depend on the worker count."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_tpu.ops import filters as j_filters
from stereo_tpu.ops import interp as j_interp
from stereo_tpu.ops import photo as j_photo
from stereo_tpu.proposals import segpln as j_segpln
from stereo_tpu_torch.ops import filters as t_filters
from stereo_tpu_torch.ops import interp as t_interp
from stereo_tpu_torch.ops import photo as t_photo
from stereo_tpu_torch.proposals import segpln as t_segpln
from test_model_global import make_pair

torch.set_num_threads(1)

DISPS = np.arange(6, -1, -1).astype(np.float64)  # descending, as the model
COL_THRESH, WINDOW = 30.0, 2


@pytest.fixture(scope="module")
def pair():
    images, P = make_pair()
    return images, P


def _planes(seed, H, W):
    rng = np.random.default_rng(seed)
    p = np.zeros((4, H, W))
    p[0] = rng.normal(0, 0.05, (H, W))
    p[1] = rng.normal(0, 0.05, (H, W))
    p[2] = 1.0
    p[3] = -rng.uniform(0, 6, (H, W))
    return p


def test_unary_cost_matches(pair):
    images, P = pair
    H, W, _ = images[0].shape
    planes = _planes(0, H, W)
    kw = dict(d_min=0.0, d_step=6.0)
    want = np.asarray(j_photo.unary_cost(
        jnp.asarray(planes), jnp.asarray(images[0]), jnp.asarray(images[1]),
        jnp.asarray(P[1]), COL_THRESH, **kw))
    got = t_photo.unary_cost(
        torch.as_tensor(planes), torch.as_tensor(images[0]),
        torch.as_tensor(images[1]), torch.as_tensor(P[1]), COL_THRESH, **kw)
    assert got.dtype == torch.float64 and got.shape == (H, W)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    # d_min != 0: the reference's normalization quirk
    kw = dict(d_min=1.5, d_step=4.5)
    want = np.asarray(j_photo.unary_cost(
        jnp.asarray(planes), jnp.asarray(images[0]), jnp.asarray(images[1]),
        jnp.asarray(P[1]), COL_THRESH, **kw))
    got = t_photo.unary_cost(
        torch.as_tensor(planes), torch.as_tensor(images[0]),
        torch.as_tensor(images[1]), torch.as_tensor(P[1]), COL_THRESH, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def volumes(pair):
    images, P = pair
    want = np.asarray(j_photo.rssd_volume(
        [jnp.asarray(im) for im in images], [jnp.asarray(p) for p in P],
        DISPS, COL_THRESH, WINDOW))
    got = t_photo.rssd_volume(
        [torch.as_tensor(im) for im in images],
        [torch.as_tensor(p) for p in P], DISPS, COL_THRESH, WINDOW)
    return want, got


def test_rssd_volume_matches(pair, volumes):
    images, _ = pair
    H, W, _ = images[0].shape
    want, got = volumes
    assert tuple(got.shape) == (len(DISPS), H - 2 * WINDOW, W - 2 * WINDOW)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_rssd_volume_chunks_of_levels(pair, monkeypatch):
    """The volume does not depend on how many levels are built at once."""
    images, P = pair
    args = ([torch.as_tensor(im) for im in images],
            [torch.as_tensor(p) for p in P], DISPS, COL_THRESH, WINDOW)
    whole = t_photo.rssd_volume(*args)
    monkeypatch.setattr(t_photo, "LEVELS_PER_CHUNK", 3)
    assert torch.equal(t_photo.rssd_volume(*args), whole)


def test_wta_disparity_equal(volumes):
    want, got = volumes
    a = j_segpln.wta_disparity(want, DISPS, WINDOW)
    b = t_segpln.wta_disparity(want, DISPS, WINDOW)
    np.testing.assert_array_equal(a, b)
    # from the port's own volume
    np.testing.assert_array_equal(
        t_segpln.wta_disparity(got.numpy(), DISPS, WINDOW), a)


def test_fit_segment_planes_equal(volumes):
    want, _ = volumes
    disp = j_segpln.wta_disparity(want, DISPS, WINDOW)
    H, W = disp.shape
    labels = 1 + (np.arange(H)[:, None] // 10) * 5 + np.arange(W)[None] // 9
    for seed in (0, 7):
        a = j_segpln.fit_segment_planes(disp, labels,
                                        rng=np.random.default_rng(seed))
        b = t_segpln.fit_segment_planes(disp, labels,
                                        rng=np.random.default_rng(seed))
        np.testing.assert_array_equal(a, b)


def test_segpln_equal_two_mults(pair):
    """The whole stream with two mean-shift segmentations (mults 1 and 2)."""
    images, P = pair
    mults = np.array([1, 2])
    want = j_segpln.segpln(images, list(P), DISPS, COL_THRESH, WINDOW,
                           seed=3, mults=mults, workers=1)
    got = t_segpln.segpln(images, list(P), DISPS, COL_THRESH, WINDOW, seed=3,
                          mults=mults, workers=1, device="cpu")
    assert len(got) == len(want) == 2
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, np.asarray(a))


def test_segpln_independent_of_workers(pair):
    images, P = pair
    mults = np.array([1, 2, 3, 12])  # three mean-shift, one graph-based
    kw = dict(seed=5, mults=mults, device="cpu")
    one = t_segpln.segpln(images, list(P), DISPS, COL_THRESH, WINDOW,
                          workers=1, **kw)
    four = t_segpln.segpln(images, list(P), DISPS, COL_THRESH, WINDOW,
                           workers=4, **kw)
    for a, b in zip(one, four):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("axis", [0, -2, -1])
def test_separable_average_1d_equal(axis):
    x = np.random.default_rng(0).normal(size=(3, 20, 25))
    want = np.asarray(j_filters.separable_average_1d(jnp.asarray(x), 2, axis))
    got = t_filters.separable_average_1d(torch.as_tensor(x), 2, axis)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("radius", [1, 2])
def test_valid_average_2d_equal(radius):
    x = np.random.default_rng(1).normal(size=(3, 20, 25))
    want = np.asarray(j_filters.valid_average_2d(jnp.asarray(x), radius))
    got = t_filters.valid_average_2d(torch.as_tensor(x), radius)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["interp2", "interp2_cubic",
                                  "interp2_nearest"])
def test_samplers_equal(name):
    rng = np.random.default_rng(0)
    im = rng.uniform(0, 255, (12, 15, 3))
    x = rng.uniform(-1, 17, (7, 9))
    y = rng.uniform(-1, 14, (7, 9))
    # on the edges of the windows, and halves (round half to even)
    x[0, :4] = [1.5, 2.5, 15.0, 2.0]
    y[0, :4] = [0.5, 3.5, 12.5, 11.0]
    for img in (im, im[..., 0]):
        want = np.asarray(getattr(j_interp, name)(
            jnp.asarray(img), jnp.asarray(x), jnp.asarray(y), oobv=-1000.0))
        got = getattr(t_interp, name)(
            torch.as_tensor(img), torch.as_tensor(x), torch.as_tensor(y),
            oobv=-1000.0)
        np.testing.assert_array_equal(got.numpy(), want)
