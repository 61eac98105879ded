"""The port's segmentation against the JAX package's, on the CPU: the LUV
conversion (float32, in ulps), the mean-shift filter (float64, per pixel,
against the JAX filter and the serial EDISON transcription in
tests/oracle_meanshift.py, on the crops of tests/test_segmentation_parity.py),
and the port's own copy of the native merge and graph-based segmentation
(labels equal to stereo_tpu.native's), including the JAX package's
build_ram gap, copied for parity.  A missing compiler or a failed build of the native copy raises."""

import ctypes

import numpy as np
import pytest
import torch

from oracle_meanshift import _build_ram, filter_oracle, segment_oracle
from stereo_tpu import native as j_native
from stereo_tpu.proposals import segmentation as j_seg
from stereo_tpu_torch import native as t_native
from stereo_tpu_torch.proposals import segmentation as t_seg
from test_segmentation_parity import _baby2_crop, _teddy_crop, rgb_to_luv_ref

torch.set_num_threads(1)


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def test_rgb_to_luv_float32_ulps():
    """Float32 LUV within a few ulp of the JAX function's: L within 2 ulp;
    u and v within 3, since u = 13 L (u' - u'_n) carries L's ulps through
    two more roundings; almost every value bit-identical."""
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, size=(128, 128, 3)).astype(np.float32)
    rgb[0, :4] = [[255, 255, 255], [0, 0, 0], [128, 128, 128], [255, 0, 0]]
    crops = [_teddy_crop(), _baby2_crop()]
    for im in [rgb] + crops:
        want = np.asarray(j_seg.rgb_to_luv(im))
        got = t_seg.rgb_to_luv(im)
        assert got.dtype == torch.float32
        ulp = _ulps(got.numpy(), want)
        print(f"LUV {im.shape}: max ulp (L, u, v) "
              f"{ulp.reshape(-1, 3).max(0).tolist()}, bit-identical "
              f"{(ulp == 0).mean():.5f}")
        assert ulp[..., 0].max() <= 2
        assert ulp[..., 1:].max() <= 3
        assert (ulp == 0).mean() >= 0.995


@pytest.mark.parametrize("crop,h_s,h_r", [("teddy", 3, 5.0),
                                          ("baby2", 4, 6.5)])
def test_mean_shift_filter_matches_jax_and_oracle(crop, h_s, h_r):
    """Given the same float64 LUV: the JAX parity test's own bar against
    the serial transcription (>= 96% of pixels within 1e-6, median below
    1e-6), and every pixel bit-identical to the JAX filter."""
    im = _teddy_crop(20, 28, 140, 200) if crop == "teddy" else _baby2_crop()
    luv = rgb_to_luv_ref(im)  # float64
    ours = t_seg.mean_shift_filter(torch.as_tensor(luv), h_s, h_r).numpy()
    ref = filter_oracle(luv, h_s, h_r)
    err = np.abs(ours.astype(np.float32).astype(np.float64)
                 - np.asarray(ref, np.float64)).max(axis=-1)
    assert (err < 1e-6).mean() >= 0.96, (err.max(), (err >= 1e-6).sum())
    assert np.median(err) < 1e-6
    jax_modes = np.asarray(j_seg.mean_shift_filter(luv, h_s, h_r))
    same = (ours == jax_modes).all(axis=-1)
    print(f"{crop} h_s={h_s}: {int(same.sum())} of {same.size} pixels "
          f"bit-identical to the JAX filter")
    assert same.all()


def _modes(crop, h_r):
    im = _teddy_crop(28, 36, 120, 180) if crop == "teddy" else _baby2_crop()
    luv = t_seg.rgb_to_luv(np.asarray(im, np.float32))
    return np.ascontiguousarray(
        t_seg.mean_shift_filter(luv, 4, float(h_r)).numpy(), np.float32)


def _connect(L, modes, h_r, min_region):
    H, W, _ = modes.shape
    out = np.zeros((H, W), np.uint32)
    n = L.connect_modes(
        modes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), H, W,
        ctypes.c_float(float(h_r)), int(min_region),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return n, out


@pytest.mark.parametrize("crop,h_r,min_region", [
    ("teddy", 5.0, 0), ("teddy", 5.0, 12), ("baby2", 6.5, 8),
    ("baby2", 3.0, 40)])
def test_native_copy_connect_modes_equals_jax_native(crop, h_r, min_region):
    modes = _modes(crop, h_r)
    n_t, got = _connect(t_native.lib(), modes, h_r, min_region)
    n_j, want = _connect(j_native.lib(), modes, h_r, min_region)
    assert n_t == n_j
    np.testing.assert_array_equal(got, want)
    ref_labels, _, ref_counts = segment_oracle(modes, h_r, min_region)
    np.testing.assert_array_equal(got.astype(np.int64), ref_labels + 1)
    assert n_t == len(ref_counts)


@pytest.mark.parametrize("sigma,k,min_size", [(0.0, 100.0, 10),
                                              (0.5, 50.0, 30),
                                              (0.8, 300.0, 0)])
def test_native_copy_felzenszwalb_equals_jax_native(sigma, k, min_size):
    im = _teddy_crop(40, 56, 120, 180)
    got = t_seg.felzenszwalb(im, sigma, k, min_size)
    want = j_seg.felzenszwalb(im, sigma, k, min_size)
    assert got.dtype == np.uint32 and got.min() >= 1
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("min_region", [0, 5])
def test_build_ram_gap_pinned(min_region):
    """The JAX package's build_ram never records the last row's and the
    last column's adjacencies, and the port copies that gap for parity
    (native/segment.cpp build_ram; the MATLAB reference's EDISON BuildRAM
    adds them in two extra passes, ADVICE.md): a
    one-pixel region in the bottom-right corner, close in range to its
    neighbours (so a full adjacency graph would fuse or prune it), stays a
    region of its own, in the port's copy as in the JAX package's library
    and the transcription."""
    H, W, h_r = 3, 3, 5.0
    modes = np.zeros((H, W, 3), np.float32)
    modes[H - 1, W - 1] = 2.0  # not Connect-ed (|d| >= 1), InWindow (0.48)
    n_t, got = _connect(t_native.lib(), modes, h_r, min_region)
    n_j, want = _connect(j_native.lib(), modes, h_r, min_region)
    np.testing.assert_array_equal(got, want)
    assert n_t == n_j == 2
    assert got[H - 1, W - 1] != got[0, 0]
    labels = got.astype(np.int64).ravel() - 1
    adj = _build_ram(labels, H, W, 2)
    assert adj[labels[-1]] == []


def test_native_build_raises_without_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(t_native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(t_native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="compiler"):
        t_native.build()


def test_native_build_raises_on_failed_build(monkeypatch, tmp_path):
    bad = tmp_path / "segment.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(t_native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(t_native, "SOURCE", str(bad))
    with pytest.raises(RuntimeError, match="failed"):
        t_native.build()
    assert not any(p.name.endswith(".so")
                   for p in (tmp_path / "build").iterdir())


def test_native_library_named_by_source_and_flags(monkeypatch):
    path = t_native.library_path()
    assert path.startswith(t_native.BUILD_DIR)
    monkeypatch.setattr(t_native, "FLAGS", t_native.FLAGS + ("-g",))
    assert t_native.library_path() != path


def test_mean_shift_wrappers_on_cpu():
    """mean_shift / felzenszwalb take numpy arrays or tensors; the
    mean-shift filter runs on the device asked for."""
    im = _teddy_crop(20, 28, 140, 200)
    a = t_seg.mean_shift(im, 4, 5.0, 5, device="cpu")
    b = t_seg.mean_shift(torch.as_tensor(im), 4, 5.0, 5, device="cpu")
    np.testing.assert_array_equal(a, b)
    assert a.dtype == np.uint32 and a.min() == 1
