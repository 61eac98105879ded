"""stereo_tpu_torch.utils.checkpoint and .viz (and utils.io.write_png) against
stereo_tpu.utils.checkpoint and .viz, on the CPU.

Checkpoint: round trip and GC, the async writer and its error surfacing,
key strings equal to the JAX package's for the same nest, each package
loading the other's file, and a checkerboard TRW-S resume (6 sweeps
straight against 3 + checkpoint + load + 3) equal to the straight run bit
for bit and within 1e-10 (relative) of the JAX package's run in float64.
Viz: ``surface_mesh`` arrays equal to the JAX package's; the PNG encoder's
round trip through the port's decoder; ``save_dispmap``'s grey levels
(imagesc + gray(256): 256 equal bins from min to max) and its energy text
chunk."""

import collections
import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles
from stereo_tpu import geometry as j_geometry
from stereo_tpu.solvers import trws as j_trws
from stereo_tpu.utils import checkpoint as j_ckpt
from stereo_tpu.utils import viz as j_viz
from stereo_tpu_torch import geometry as t_geometry
from stereo_tpu_torch.solvers import trws as t_trws
from stereo_tpu_torch.utils import checkpoint as t_ckpt
from stereo_tpu_torch.utils import io as t_io
from stereo_tpu_torch.utils import viz as t_viz

torch.set_num_threads(1)

NT = collections.namedtuple("NT", "x y")


def _png_text(path) -> dict:
    """The tEXt chunks of a PNG as {keyword: value}."""
    with open(path, "rb") as f:
        data = f.read()
    pos, out = 8, {}
    while pos < len(data):
        n, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        if ctype == b"tEXt":
            key, _, value = data[pos + 8:pos + 8 + n].partition(b"\0")
            out[key.decode("latin-1")] = value.decode("latin-1")
        pos += 12 + n
    return out


def _nest(lib, seed=0):
    """The same nest with leaves made by ``lib`` (jnp / torch / numpy)."""
    rng = np.random.default_rng(seed)
    a, b, c, d = (rng.normal(size=s) for s in ((3,), (2, 2), (4,), (1, 3)))
    return {"b": {"c": lib(b), "a": [lib(a), (lib(c), None)]},
            "a": NT(lib(d), 7), "n": None, "k": [], "z": np.int32(5)}


def test_roundtrip_and_gc(tmp_path):
    ck = t_ckpt.Checkpointer(str(tmp_path), keep=2, async_save=False)
    for step in range(5):
        ck.save(step, {"a": torch.arange(3) + step,
                       "b": {"c": np.ones((2, 2)) * step}})
    assert ck.steps() == [3, 4]
    step, flat = ck.load()
    assert step == 4
    np.testing.assert_array_equal(flat["['a']"], np.arange(3) + 4)
    np.testing.assert_array_equal(flat["['b']/['c']"], np.ones((2, 2)) * 4)
    assert ck.load(3)[1]["['a']"].tolist() == [3, 4, 5]
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    with pytest.raises(FileNotFoundError):
        t_ckpt.Checkpointer(str(tmp_path), name="other",
                            async_save=False).load()


def test_async_save_and_error_surfacing(tmp_path):
    ck = t_ckpt.Checkpointer(str(tmp_path / "c"), async_save=True)
    for step in range(4):
        ck.save(step, {"x": torch.arange(10) * step})
    ck.wait()
    assert ck.steps() == [1, 2, 3]
    assert ck.load()[1]["['x']"].tolist() == list(range(0, 30, 3))
    # a failed background write surfaces on the caller's thread, once, and
    # the writer keeps draining later saves
    os.rename(ck.directory, str(tmp_path / "gone"))
    ck.save(9, {"x": np.zeros(2)})
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        ck.wait()
    os.rename(str(tmp_path / "gone"), ck.directory)
    ck.save(10, {"x": np.ones(2)})
    ck.wait()
    assert ck.steps()[-1] == 10


def test_key_strings_match_jax():
    got = t_ckpt._flatten(_nest(torch.as_tensor))
    want = j_ckpt._flatten(_nest(jnp.asarray))
    assert list(got) == list(want)
    assert "['a']/.x" in got and "['b']/['a']/[1]/[0]" in got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_each_package_loads_the_others_file(tmp_path):
    j = j_ckpt.Checkpointer(str(tmp_path), name="s", async_save=False)
    j.save(1, _nest(jnp.asarray, seed=1))
    t = t_ckpt.Checkpointer(str(tmp_path), name="s", async_save=False)
    step, flat = t.load()
    want = j_ckpt._flatten(_nest(np.asarray, seed=1))
    assert step == 1 and sorted(flat) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k])
    t.save(2, _nest(torch.as_tensor, seed=2))
    step, flat = j.load()
    want = j_ckpt._flatten(_nest(np.asarray, seed=2))
    assert step == 2 and sorted(flat) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k])


@pytest.mark.parametrize("compact", [False, True])
def test_trws_resume_identical_trajectory(tmp_path, compact):
    """6 sweeps straight vs 3 + checkpoint (async) + load + 3: labels,
    energy and bound equal bit for bit; the straight run within 1e-10 of
    the JAX package's (float64)."""
    rng = np.random.default_rng(0)
    theta, D0, Q, alphas = oracles.grid_trws_inputs(rng, 7, 8, 3)
    args = [torch.as_tensor(x) for x in (theta, D0, Q, alphas)]
    kw = dict(kernel=1, tol=1.0, max_relgap=0.0, compact=compact)

    full = t_trws.solve(*args, maxiter=6, **kw)
    half = t_trws.solve(*args, maxiter=3, **kw)
    ck = t_ckpt.Checkpointer(str(tmp_path), async_save=True)
    ck.save(3, {"messages": half.messages})
    ck.wait()
    _, flat = ck.load()
    resumed = t_trws.solve(*args, maxiter=3, **kw,
                           messages=torch.as_tensor(flat["['messages']"]))
    assert float(resumed.energy) == float(full.energy)
    assert float(resumed.lower_bound) == float(full.lower_bound)
    assert torch.equal(resumed.labels, full.labels)
    assert torch.equal(resumed.messages, full.messages)

    want = j_trws.solve(*(jnp.asarray(x) for x in (theta, D0, Q, alphas)),
                        maxiter=6, kernel=1, tol=1.0, max_relgap=0.0)
    np.testing.assert_array_equal(full.labels.numpy(),
                                  np.asarray(want.labels))
    np.testing.assert_allclose(float(full.energy), float(want.energy),
                               rtol=1e-10)
    np.testing.assert_allclose(float(full.lower_bound),
                               float(want.lower_bound), rtol=1e-10)


def test_surface_mesh_matches_jax():
    H, W = 9, 11
    rng = np.random.default_rng(3)
    disp = rng.uniform(0, 5, (H, W))
    disp[:, 6:] += 40.0  # a step the cut must find
    planes = np.array(j_geometry.plane_field_from_disparity(
        jnp.asarray(disp)))
    planes[0] = rng.normal(0, 0.1, (H, W))  # slanted planes
    gray = rng.uniform(0, 1, (H, W))
    for tol, roi in ((10.0, None), (1000.0, None),
                     (5.0, (slice(1, 8), slice(2, 10)))):
        want = j_viz.surface_mesh(planes, gray, tol=tol, roi=roi)
        got = t_viz.surface_mesh(torch.as_tensor(planes), gray, tol=tol,
                                 roi=roi)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    # the port's plane field of a disparity map is the JAX package's
    np.testing.assert_array_equal(
        t_geometry.plane_field_from_disparity(torch.as_tensor(disp)).numpy(),
        np.asarray(j_geometry.plane_field_from_disparity(jnp.asarray(disp))))


@pytest.mark.parametrize("shape", [(7, 9), (6, 5, 3), (1, 1), (3, 300)])
def test_png_roundtrip(tmp_path, shape):
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    path = t_io.write_png(str(tmp_path / "a.png"), img,
                          text={"Title": "x y", "k": 1.5})
    np.testing.assert_array_equal(t_io.read_png(path), img)
    assert _png_text(path) == {"Title": "x y", "k": "1.5"}
    with pytest.raises(ValueError, match="uint8"):
        t_io.write_png(str(tmp_path / "b.png"), img.astype(np.float32))


def test_save_dispmap_grey_levels(tmp_path):
    d = np.array([[0.0, 1.0, 2.0, 4.0], [np.nan, 3.999, 0.015625, 4.0]])
    path = t_viz.save_dispmap(str(tmp_path / "d.png"), torch.as_tensor(d),
                              energy=123.4)
    grey = t_io.read_png(path)
    # (d - 0) / 4 in 256 bins; the maximum in the last bin; NaN -> 0
    np.testing.assert_array_equal(grey, [[0, 64, 128, 255],
                                         [0, 255, 1, 255]])
    assert _png_text(path) == {"Title": "Solution energy: 123.4"}
    flat = t_io.read_png(t_viz.save_dispmap(str(tmp_path / "c.png"),
                                            np.full((3, 4), 2.0)))
    assert flat.shape == (3, 4) and not flat.any()
    with pytest.raises(ValueError, match="greyscale"):
        t_viz.save_dispmap(str(tmp_path / "e.png"), d, cmap="jet")


def test_save_surfaces(tmp_path, monkeypatch):
    """With matplotlib the surface view is written; without it the call
    raises (matplotlib is imported when called, never at import)."""
    pytest.importorskip("matplotlib")
    H, W = 8, 9
    disp = np.random.default_rng(0).uniform(0, 5, (H, W))
    planes = t_geometry.plane_field_from_disparity(torch.as_tensor(disp))
    img = np.random.default_rng(1).uniform(0, 255, (H, W, 3))
    p = t_viz.save_surfaces(str(tmp_path / "s.png"), planes, img,
                            energy=1.0)
    with open(p, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    import sys
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        t_viz.save_surfaces(str(tmp_path / "t.png"), planes, img)
