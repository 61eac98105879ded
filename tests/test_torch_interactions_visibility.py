"""stereo_tpu_torch.ops.interactions and .models.visibility against the JAX
package's, on the CPU.

- ``find_interactions``: partner, occluder and valid masks equal on sorted
  points with ties in x, y and z, and the compacted pair lists equal in
  order.
- ``view_interactions`` on a fronto-parallel pair — u equal down each
  column, far more ties than the 48-offset window — given the same u, v, z:
  the pair arrays equal, order included (the stable sort); and the port's
  own projection gives the JAX package's u, v, z bit for bit (float32).
- ``build_visibility_terms``: in float64 the tables within 1e-10 (relative)
  and the edges, samples and interactions equal; in float32 the edges and
  interactions equal and the tables within 2e-6 (the photo costs' exp / log
  differ between the two CPU libraries by an ulp).
- ``calc_vis_energy``: equal on the same terms; within 1e-10 on each
  package's own float64 terms."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_tpu.models import visibility as j_vis
from stereo_tpu.ops import interactions as j_int
from stereo_tpu_torch.models import visibility as t_vis
from stereo_tpu_torch.ops import interactions as t_int

torch.set_num_threads(1)

OCCL = 0.01 + float(np.log(2.0))


def _scene(H=8, W=12, shift=2, seed=0):
    rng = np.random.default_rng(seed)
    im0 = np.clip(rng.uniform(0, 255, (H, W, 3)) * 0.5
                  + np.linspace(0, 255, W)[None, :, None] * 0.5, 0, 255)
    im1 = np.roll(im0, -shift, axis=1)
    P = np.zeros((2, 3, 4))
    P[:, :, :3] = np.eye(3)
    P[1, 0, 3] = -1.0
    return [im0, im1], P


@pytest.mark.parametrize("max_offsets", [4, 32])
@pytest.mark.parametrize("seed", [0, 1])
def test_find_interactions_matches_jax_with_ties(seed, max_offsets):
    rng = np.random.default_rng(seed)
    N = 160
    X = np.sort(rng.integers(0, 40, N) * 0.25)  # many equal x
    Y = rng.integers(0, 6, N) * 0.5
    Z = rng.integers(1, 4, N).astype(np.float64)  # equal depths too
    want = [np.asarray(a) for a in j_int.find_interactions(
        jnp.asarray(X), jnp.asarray(Y), jnp.asarray(Z),
        max_offsets=max_offsets)]
    got = [a.numpy() for a in t_int.find_interactions(
        torch.as_tensor(X), torch.as_tensor(Y), torch.as_tensor(Z),
        max_offsets=max_offsets)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].dtype == np.int32
    np.testing.assert_array_equal(t_int.interactions_to_pairs(*got),
                                  j_int.interactions_to_pairs(*want))


def _fronto(H, W, d1, d2):
    return np.full((H, W), d1, np.float32), np.full((H, W), d2, np.float32)


@pytest.mark.parametrize("case", ["fronto", "fronto_equal", "random",
                                  "perspective"])
def test_view_interactions_match_jax(case):
    images, P = _scene()
    H, W = images[0].shape[:2]
    if case == "perspective":  # T3 != 1: u = T1 * (1 / T3) is not T1 / T3
        P[1, 2] = [3e-3, -2e-3, 1.0, 7e-2]
    if case in ("random", "perspective"):
        rng = np.random.default_rng(4)
        D1, D2 = (rng.uniform(0, 4, (H, W)).astype(np.float32)
                  for _ in range(2))
    else:
        D1, D2 = _fronto(H, W, 2.0, 2.0 if case == "fronto_equal" else 3.0)
    R = images[0].astype(np.float32)
    im = images[1].astype(np.float32)
    ju, jv, jz, jpc = j_vis.project_candidates(
        jnp.asarray(D1), jnp.asarray(D2), jnp.asarray(P[1], jnp.float32),
        jnp.asarray(im), jnp.asarray(R), 30.0)
    tu, tv, tz, tpc = t_vis.project_candidates(
        torch.as_tensor(D1), torch.as_tensor(D2),
        torch.as_tensor(P[1], dtype=torch.float32), torch.as_tensor(im),
        torch.as_tensor(R), 30.0)
    for t, j in ((tu, ju), (tv, jv), (tz, jz)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_allclose(tpc.numpy(), np.asarray(jpc), rtol=1e-6,
                               atol=1e-7)
    u, v, z = (np.array(a) for a in (ju, jv, jz))
    if case in ("fronto", "fronto_equal"):  # each column's 2H points tie in u
        assert all(len(np.unique(u[s])) == W for s in range(2))
    want = j_vis.view_interactions(jnp.asarray(u), jnp.asarray(v),
                                   jnp.asarray(z))
    got = t_vis.view_interactions(torch.as_tensor(u), torch.as_tensor(v),
                                  torch.as_tensor(z))
    # one pixel's two surfaces never pair: D1 == D2 leaves no pair
    assert (len(want) == 0) == (case == "fronto_equal")
    np.testing.assert_array_equal(got, want)


def _terms(pkg, D1, D2, images, P, dtype):
    if pkg == "jax":
        return j_vis.build_visibility_terms(
            jnp.asarray(D1, dtype), jnp.asarray(D2, dtype),
            [jnp.asarray(im, dtype) for im in images[1:]], P[1:],
            jnp.asarray(images[0], dtype), 30.0, OCCL)
    tdt = {jnp.float32: torch.float32, jnp.float64: torch.float64}[dtype]
    return t_vis.build_visibility_terms(
        torch.as_tensor(D1, dtype=tdt), torch.as_tensor(D2, dtype=tdt),
        [torch.as_tensor(im, dtype=tdt) for im in images[1:]], P[1:],
        torch.as_tensor(images[0], dtype=tdt), 30.0, OCCL)


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
@pytest.mark.parametrize("seed", [0, 1])
def test_build_visibility_terms_matches_jax(seed, dtype):
    images, P = _scene(seed=seed)
    H, W = images[0].shape[:2]
    rng = np.random.default_rng(seed + 10)
    D1 = rng.uniform(0, 4, (H, W))
    D2 = np.where(rng.random((H, W)) < 0.5, 3.0, rng.uniform(0, 4, (H, W)))
    want = _terms("jax", D1, D2, images, P, dtype)
    got = _terms("torch", D1, D2, images, P, dtype)
    rtol = 1e-10 if dtype == jnp.float64 else 2e-6
    assert got["tp"] == want["tp"] and got["occl_cost"] == want["occl_cost"]
    for k in ("interactions", "occluded"):
        for g, w in zip(got[k], want[k]):
            np.testing.assert_array_equal(g, w)
    for g, w in zip(got["samples"], want["samples"]):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got["edges"][:2], want["edges"][:2]):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got["edges"][2:], want["edges"][2:]):
        np.testing.assert_allclose(g, w, rtol=rtol)
    for k in ("unary0", "unary1", "aux0", "aux1", "photo_aux"):
        np.testing.assert_allclose(got[k], want[k], rtol=rtol)
    for g, w in zip(got["photo_cost"], want["photo_cost"]):
        np.testing.assert_allclose(g, w, rtol=rtol)
    assert len(want["edges"][0]) > H * W // 4  # occlusion edges exist


def test_calc_vis_energy_matches_jax():
    images, P = _scene(seed=2)
    H, W = images[0].shape[:2]
    rng = np.random.default_rng(12)
    D1, D2 = (rng.uniform(0, 4, (H, W)) for _ in range(2))
    want_terms = _terms("jax", D1, D2, images, P, jnp.float64)
    got_terms = _terms("torch", D1, D2, images, P, jnp.float64)
    for _ in range(10):
        y = rng.integers(0, 2, H * W).astype(np.int32)
        e_w, vis_w = j_vis.calc_vis_energy(want_terms, y)
        e_same, vis_same = t_vis.calc_vis_energy(want_terms, y)
        assert e_same == e_w
        for g, w in zip(vis_same, vis_w):
            np.testing.assert_array_equal(g, w)
        e_g, vis_g = t_vis.calc_vis_energy(got_terms, y)
        np.testing.assert_allclose(e_g, e_w, rtol=1e-10)
        for g, w in zip(vis_g, vis_w):
            np.testing.assert_array_equal(g, w)
