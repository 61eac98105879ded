"""stereo_tpu_torch.render against stereo_tpu.render, on the CPU.

- genview / stereo_views / interp_views: equal (numpy and scipy in both).
- truncquad_edges and truncquad_modes: equal to the JAX functions run op by
  op (``jax.disable_jit``): each op rounds once, as the port's do.  Against
  the jitted JAX functions everything but the energies is equal and the
  energies and edge costs agree to 1e-14 relative in float64 (1e-6 in
  float32): XLA's CPU compiler
  contracts the fused channel sum into multiply-adds, which round once
  where the port's (and the card's) separate ops round twice.  The modes'
  libraries are small integers with repeated vectors, so seeds converge to
  tied energies and the dedupe, the depth-mode test and the stable top-k
  decide on exact ties.
- render_edgemodes (10 x 12, 5 levels): image and depth equal, energy and
  bound within 1e-9 relative; the lambda = 0 branch too.
- render_occl (8 x 10, two planes): depths, image and visibility equal,
  energies within 1e-9 relative, unlabelled counts equal."""

import sys

import jax
import numpy as np
import pytest
import torch

import stereo_tpu.render.genview  # noqa: F401  (the module, not the
import stereo_tpu_torch.render.genview  # noqa: F401  re-exported function)
from stereo_tpu.render import edgemodes as j_em
from stereo_tpu.render import edges as j_edges
from stereo_tpu.render import modes as j_modes
from stereo_tpu.render import occlrender as j_occl
from stereo_tpu_torch.render import edgemodes as t_em
from stereo_tpu_torch.render import edges as t_edges
from stereo_tpu_torch.render import modes as t_modes
from stereo_tpu_torch.render import occlrender as t_occl
from test_render_genview import _random_P

torch.set_num_threads(1)

T = torch.as_tensor
j_gv = sys.modules["stereo_tpu.render.genview"]
t_gv = sys.modules["stereo_tpu_torch.render.genview"]


def test_genview_matches_jax():
    rng = np.random.default_rng(2)
    Pi = np.stack([_random_P(rng) for _ in range(3)])
    pts = rng.normal(size=(6, 3)) + [0, 0, 5]
    for args, kw in (
            (("input", Pi, [1, 2], None), {}),
            (("stereo", Pi, [0], -1.0), dict(disps=np.array([1.0, 4.0]))),
            (("stereo", Pi, [2], 0.5), dict(points=pts)),
            (("steady", Pi, [0, 2], [0.0, 0.3, 1.0]), {})):
        np.testing.assert_array_equal(t_gv.genview(*args, **kw),
                                      j_gv.genview(*args, **kw))
    for view in (-1.0, 0.25, "l", "m", "r"):
        np.testing.assert_array_equal(t_gv.stereo_views(Pi, 0.4, view),
                                      j_gv.stereo_views(Pi, 0.4, view))
    np.testing.assert_array_equal(
        t_gv.interp_views(Pi[0], Pi[1], np.linspace(0, 1, 5)),
        j_gv.interp_views(Pi[0], Pi[1], np.linspace(0, 1, 5)))
    with pytest.raises(ValueError):
        t_gv.genview("stereo", Pi, [0], 1.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_truncquad_edges_matches_jax(seed):
    rng = np.random.default_rng(seed)
    lib1, lib2 = rng.uniform(0, 5, (2, 4, 3, 10))
    m1 = rng.uniform(0, 5, (4, 5, 3))
    m2 = rng.uniform(0, 5, (4, 6, 3))
    args = (lib1, lib2, m1, m2, 20.0, 0.7)
    got = t_edges.truncquad_edges(*map(T, args[:4]), *args[4:]).numpy()
    with jax.disable_jit():
        op_by_op = np.asarray(j_edges.truncquad_edges(*args))
    np.testing.assert_array_equal(got, op_by_op)
    np.testing.assert_allclose(got, np.asarray(j_edges.truncquad_edges(*args)),
                               rtol=1e-14)
    # a threshold beyond float32 (the renderer's 1e100) rounds to +inf
    f32 = [a.astype(np.float32) for a in args[:4]]
    got = t_edges.truncquad_edges(*map(T, f32), 1e100, 2.0).numpy()
    with jax.disable_jit():
        op_by_op = np.asarray(j_edges.truncquad_edges(*f32, 1e100, 2.0))
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_array_equal(got, op_by_op)
    np.testing.assert_allclose(
        got, np.asarray(j_edges.truncquad_edges(*f32, 1e100, 2.0)),
        rtol=1e-6)


def _library(seed, batch=(3, 2), C=3, L=5, M=6):
    """Small-integer colours with repeated vectors and depths: seeds that
    converge to one cluster tie exactly.  The first pixel's colours are
    spread wide, so it has fewer modes than max_modes (+inf pads)."""
    rng = np.random.default_rng(seed)
    I = np.round(rng.uniform(0, 10, (*batch, C, L, M)))
    I[..., L - 1, :] = I[..., 0, :]
    I[..., :, M - 1] = I[..., :, M - 3]
    I[0, 0] = np.round(rng.uniform(0, 60, (C, L, M)))
    return I


@pytest.mark.parametrize("search_width", [None, 2])
@pytest.mark.parametrize("use_variance", [0, 1, 2])
def test_truncquad_modes_matches_jax(use_variance, search_width):
    I = _library(use_variance + (search_width or 0))
    kw = dict(use_variance=use_variance, search_width=search_width,
              max_modes=8)
    got = {k: v.numpy() for k, v in
           t_modes.truncquad_modes(T(I), 6.0, **kw).items()}
    with jax.disable_jit():
        op_by_op = {k: np.asarray(v) for k, v in
                    j_modes.truncquad_modes(I, 6.0, **kw).items()}
    jitted = {k: np.asarray(v) for k, v in
              j_modes.truncquad_modes(I, 6.0, **kw).items()}
    assert got["depth"].dtype == np.int32
    for k in ("modes", "depth", "energy", "inliers", "count"):
        np.testing.assert_array_equal(got[k], op_by_op[k], err_msg=k)
    for k in ("modes", "depth", "inliers", "count"):
        np.testing.assert_array_equal(got[k], jitted[k], err_msg=k)
    np.testing.assert_allclose(got["energy"], jitted["energy"], rtol=1e-14)
    # the cases carry ties, pads and more modes than max_modes
    e = got["energy"]
    assert np.isinf(e).any() and (got["count"] > 8).any()
    fin = e[np.isfinite(e)]
    assert len(np.unique(fin)) < len(fin)


def _edge_scene(H=10, W=12, disp=2.0, seed=0):
    rng = np.random.default_rng(seed)
    im0 = rng.uniform(0, 255, (H, W + 8, 3))
    im1 = im0[:, int(disp):, :][:, :W]
    P = np.zeros((2, 3, 4))
    P[:, :, :3] = np.eye(3)
    P[1, 0, 3] = -1.0
    return [im0[:, :W], im1], P


@pytest.mark.parametrize("lam", [0.0, 5.0])
def test_render_edgemodes_matches_jax(lam):
    images, P = _edge_scene()
    disps = np.arange(0.0, 5.0)
    kw = dict(lam=lam, thresh=10.0, max_modes=4, maxiter=40)
    want = j_em.render_edgemodes(images, P, disps, (10, 12), **kw)
    got = t_em.render_edgemodes(images, P, disps, (10, 12), device="cpu",
                                **kw)
    np.testing.assert_array_equal(got.image.numpy(), np.asarray(want.image))
    np.testing.assert_array_equal(got.depth.numpy(), np.asarray(want.depth))
    np.testing.assert_allclose(got.energy, want.energy, rtol=1e-9)
    if lam:
        np.testing.assert_allclose(got.lower_bound, want.lower_bound,
                                   rtol=1e-9)
        assert got.lower_bound <= got.energy * (1 + 1e-9)
    else:
        assert got.lower_bound is None and want.lower_bound is None


def _two_planes(H=8, W=10, C=3):
    """A near square (d = 3) over a far background (d = 1), seen from two
    inputs at +-1 px a disparity unit."""
    rng = np.random.default_rng(7)
    bg = rng.uniform(40, 215, size=(H, 2 * W, C)).astype(np.float32)
    sq = rng.uniform(0, 255, size=(4, 4, C)).astype(np.float32)

    def make_view(shift):
        im = bg[:, 6 - shift:6 - shift + W].copy()
        x0 = 3 + 3 * shift
        im[2:6, x0:x0 + 4] = sq
        return im

    P = np.zeros((2, 3, 4))
    for i, s in enumerate((-1.0, 1.0)):
        P[i, :, :3] = np.eye(3)
        P[i, 0, 3] = s
    return [make_view(-1), make_view(1)], P, (H, W)


@pytest.mark.parametrize("visibility,tex_weight", [(True, 0.0),
                                                   (False, 0.5)])
def test_render_occl_matches_jax(visibility, tex_weight):
    views, P, sz = _two_planes()
    disps = np.array([3.0, 2.0, 1.0])
    kw = dict(col_thresh=20.0, lambda_=0.01, num_loops=2,
              visibility=visibility, tex_weight=tex_weight)
    want = j_occl.render_occl(views, P, disps, sz,
                              j_occl.OcclRenderOptions(**kw))
    got = t_occl.render_occl(views, P, disps, sz,
                             t_occl.OcclRenderOptions(**kw), device="cpu")
    np.testing.assert_array_equal(got.depth, want.depth)
    np.testing.assert_array_equal(got.image, want.image)
    np.testing.assert_array_equal(got.visibility, want.visibility)
    np.testing.assert_allclose(got.energies, want.energies, rtol=1e-9)
    assert got.unlabelled == want.unlabelled
    assert len(set(np.unique(got.depth))) > 1
