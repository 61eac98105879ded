"""SegPln proposal generation: segmentation-driven piecewise-planar proposals
(port of stereo_tpu/proposals/segpln.py).

The dispmap_globalstereo.segpln equivalent (dispmap_globalstereo.m:60-201,
itself a modification of imrender/ojw/ojw_segpln.m that keeps plane normals):

1. windowed robust-SSD correlation volume over all disparities (device);
2. winner-takes-all disparity with a 0.07 confidence floor (numpy, on the
   host copy of the volume, so ties go to the first index as in the JAX
   package);
3. 14 segmentations of the reference image (7 mean-shift, 7 graph-based,
   segment_params [1 1.5 10 100] x mults [1:7 3 5 8 12 24 50 100]);
4. per segment, LO-RANSAC plane fit in (x/d, y/d, 1/d) space with inlier
   threshold 0.1, then least-squares refit -> plane (N1, N2, 1, N3) whose
   disparity is d(x, y) = -(N1 x + N2 y + N3).

Stages 2 and 4 are the JAX package's numpy code, copied; the mean-shift
filter of stage 3 runs on the device, its merge and the graph-based
segmentation in the port's native library.
"""

from __future__ import annotations

import concurrent.futures
import os
import threading

import numpy as np
import torch

from stereo_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from stereo_tpu_torch.ops import photo
from stereo_tpu_torch.proposals import segmentation

SEGMENT_PARAMS = np.array([1.0, 1.5, 10.0, 100.0])
MULTS = np.array([1, 2, 3, 4, 5, 6, 7, 3, 5, 8, 12, 24, 50, 100])
N_MEAN_SHIFT = 7  # first 7 mults use mean shift, rest Felzenszwalb (:125-133)


def wta_disparity(corr_norm, disparities, window: int, confidence: float = 0.07):
    """WTA disparity from the normalized correlation volume, confidence-floored
    and padded back to full size (dispmap_globalstereo.m:112-115).

    corr_norm: [D, H-2w, W-2w]; returns np [H, W].
    """
    disparities = np.asarray(disparities, dtype=np.float64)
    v = np.asarray(corr_norm)
    best = v.max(axis=0)
    idx = v.argmax(axis=0)
    disp = disparities[idx]
    disp[best < confidence] = 0.0
    # padarray(..., 'symmetric'): reflect including the edge sample
    return np.pad(disp, window, mode="symmetric")


def ransac_plane(pts: np.ndarray, threshold: float, max_samples: int = 500,
                 rng=None) -> np.ndarray:
    """Inlier mask for a plane through homogeneous points (rplane equivalent).

    pts: [n, 3]; plane N solves pts @ N = -1; inliers |pts @ N + 1| < th.
    """
    rng = rng or np.random.default_rng(0)
    n = pts.shape[0]
    best_inl = np.zeros(n, dtype=bool)
    if n < 3:
        return best_inl
    S = min(max_samples, 4 * n)
    tri = rng.integers(0, n, size=(S, 3))
    # reject degenerate triples lazily via lstsq fallback
    A = pts[tri]  # [S, 3, 3]
    rhs = -np.ones((S, 3))
    with np.errstate(all="ignore"):
        try:
            Ns = np.linalg.solve(A, rhs[..., None])[..., 0]  # [S, 3]
        except np.linalg.LinAlgError:
            Ns = np.stack(
                [np.linalg.lstsq(A[i], rhs[i], rcond=None)[0] for i in range(S)]
            )
    Ns = np.where(np.isfinite(Ns), Ns, 0.0)
    # chunked inlier count to bound memory
    counts = np.zeros(S, dtype=np.int64)
    best_count, best_s = -1, 0
    for s0 in range(0, S, 64):
        d = np.abs(pts @ Ns[s0:s0 + 64].T + 1.0)  # [n, chunk]
        c = (d < threshold).sum(axis=0)
        counts[s0:s0 + 64] = c
    best_s = int(np.argmax(counts))
    if counts[best_s] <= 3:
        return best_inl
    # local optimization: refit on inliers, recompute (rplane :439-451)
    v = np.abs(pts @ Ns[best_s] + 1.0) < threshold
    for lo_iter in range(2):
        if v.sum() < 3:
            break
        N = np.linalg.lstsq(pts[v], -np.ones(int(v.sum())), rcond=None)[0]
        v_new = np.abs(pts @ N + 1.0) < threshold
        if lo_iter > 0 and v_new.sum() <= v.sum():
            break
        v = v_new
    return v


def fit_segment_planes(disp: np.ndarray, seg_labels: np.ndarray,
                       threshold: float = 0.1, rng=None) -> np.ndarray:
    """One piecewise-planar proposal [4, H, W] from a WTA disparity map and a
    segmentation (dispmap_globalstereo.m:154-192).  Segments without a valid
    fit keep the zero-disparity plane (0, 0, 1, 0)."""
    rng = rng or np.random.default_rng(0)
    H, W = disp.shape
    X, Y = np.meshgrid(np.arange(1, W + 1, dtype=np.float64),
                       np.arange(1, H + 1, dtype=np.float64))
    with np.errstate(all="ignore"):
        invd = 1.0 / disp
    prop = np.zeros((4, H, W))
    prop[2] = 1.0

    flat_labels = seg_labels.ravel()
    order = np.argsort(flat_labels, kind="stable")
    sorted_labels = flat_labels[order]
    boundaries = np.flatnonzero(np.diff(sorted_labels)) + 1
    groups = np.split(order, boundaries)

    x_flat, y_flat, invd_flat = X.ravel(), Y.ravel(), invd.ravel()
    for members in groups:
        wc = np.stack(
            [invd_flat[members] * x_flat[members],
             invd_flat[members] * y_flat[members],
             invd_flat[members]], axis=1,
        )
        ok = np.isfinite(wc).all(axis=1) & (wc[:, 2] != 0)
        pts = wc[ok]
        if pts.shape[0] > 3:
            inl = ransac_plane(pts, threshold, rng=rng)
            pts = pts[inl] if inl.sum() > 0 else pts
        if pts.shape[0] > 2:
            N, *_ = np.linalg.lstsq(pts, -np.ones(pts.shape[0]), rcond=None)
            if np.isfinite(N).all():
                ys, xs = np.unravel_index(members, (H, W))
                prop[0, ys, xs] = N[0]
                prop[1, ys, xs] = N[1]
                prop[3, ys, xs] = N[2]
    # NaN/Inf scrub (dispmap_globalstereo.m:197-200)
    prop[~np.isfinite(prop)] = 1e-100
    return prop


def segpln(
    images,  # list of [H, W, C] arrays or tensors, images[0] = reference
    Ps,  # list of [3, 4] camera matrices
    disparities,  # descending disparity grid
    col_thresh: float,
    window: int = 2,
    seed: int = 0,
    mults=MULTS,
    workers: int | None = None,
    *,
    device=DEFAULT_DEVICE,
) -> list[np.ndarray]:
    """The full 14-proposal SegPln stream. Returns a list of [4, H, W] arrays.

    The volume is built on ``device`` in the first image's dtype and its WTA
    taken on the host.  The 14 (segmentation -> RANSAC fit) chains are
    independent host work and run on a thread pool: the segmentations start
    at once (the mean-shift filters on ``device``), and each fit begins as
    soon as the WTA disparity lands.  Determinism: each
    proposal b draws from its own rng seeded (seed, b), so the results do not
    depend on the worker count or the completion order.
    """
    dev = resolve_device(device)
    if workers is None:
        workers = max(1, min(8, (os.cpu_count() or 2) - 1))
    ims = [torch.as_tensor(im, device=dev) for im in images]
    dtype = ims[0].dtype
    ims = [im.to(dtype) for im in ims]
    im_ref = ims[0].cpu().numpy()

    disp_box: list[np.ndarray] = []
    disp_ready = threading.Event()

    def seg_and_fit(b: int, mult: float) -> np.ndarray:
        sp = SEGMENT_PARAMS * mult
        if b < N_MEAN_SHIFT:
            labels = segmentation.mean_shift(im_ref, int(sp[0]), float(sp[1]),
                                             int(sp[2]), device=dev)
        else:
            labels = segmentation.felzenszwalb(im_ref, 0.0, float(sp[3]),
                                               int(sp[2]))
        disp_ready.wait()
        rng_b = np.random.default_rng(np.random.SeedSequence((seed, b)))
        return fit_segment_planes(disp_box[0], labels, rng=rng_b)

    def wta():
        corr = photo.rssd_volume(
            ims, [torch.as_tensor(P, dtype=dtype, device=dev) for P in Ps],
            disparities, col_thresh, window)
        return wta_disparity(corr.cpu().numpy(), disparities, window)

    mults = np.asarray(mults)
    if workers <= 1:
        disp_box.append(wta())
        disp_ready.set()
        return [seg_and_fit(b, m) for b, m in enumerate(mults)]
    with concurrent.futures.ThreadPoolExecutor(workers) as ex:
        futs = [ex.submit(seg_and_fit, b, m) for b, m in enumerate(mults)]
        try:
            disp_box.append(wta())
        finally:
            # a failed volume must not leave the workers waiting
            disp_ready.set()
        return [f.result() for f in futs]
