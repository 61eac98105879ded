"""Woodford CVPR'08 photometric unary: projective warp + robust kernel
(port of stereo_tpu/ops/photo.py).

Project each pixel through the second camera at its plane's disparity,
bilinearly sample the second image, and score the colour difference with

    ephoto(F) = log(2) - log(exp(-||F||^2 / (col_thresh * C)) + 1)

which is 0 for a perfect match and saturates at log 2
(dispmap_globalstereo.m:355-375, 405).  Also the windowed RSSD correlation
volume of segpln (dispmap_globalstereo.m:84-108).

P convention: the raw 3x4 camera matrices; image 1 must be the reference
view.  Divisions by a constant divide by a tensor on the data's device: a
CUDA division by a Python number is a multiplication by its reciprocal.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from stereo_tpu_torch import geometry
from stereo_tpu_torch.ops.filters import valid_average_2d
from stereo_tpu_torch.ops.interp import interp2

# disparity levels of the correlation volume built at once
# (jax.lax.map(..., batch_size=16) in the JAX package)
LEVELS_PER_CHUNK = 16


def ephoto(F, col_thresh: float, colors: int):
    """Robust photoconsistency kernel (dispmap_globalstereo.m:405).

    F: [..., C] colour difference; returns [...]."""
    ss = (F * F).sum(dim=-1) * (-1.0 / (col_thresh * colors))
    return math.log(2.0) - torch.log(torch.exp(ss) + 1.0)


def project(P, xs, ys, disp):
    """Homogeneous projection [x y 1 d] @ P^T -> (u, v) image coordinates.

    P: [3, 4] camera matrix of the target view (a tensor); xs/ys/disp:
    broadcastable to [..., H, W]."""
    T1 = P[0, 0] * xs + P[0, 1] * ys + P[0, 2] + P[0, 3] * disp
    T2 = P[1, 0] * xs + P[1, 1] * ys + P[1, 2] + P[1, 3] * disp
    T3 = P[2, 0] * xs + P[2, 1] * ys + P[2, 2] + P[2, 3] * disp
    n = 1.0 / T3
    return T1 * n, T2 * n


def unary_cost(planes, im_ref, im_other, P_other, col_thresh: float, *,
               d_min: float, d_step: float, oobv: float = -1000.0):
    """Per-pixel Woodford unary [H, W] of a plane-label field [4, H, W].

    Reproduces the reference's normalization quirk: the raw disparity is
    mapped to d_step * ((raw - d_min)/d_step + d_min) before projection
    (dispmap_globalstereo.m:356 composed with :336-345) — the identity when
    d_min == 0, which holds for all bundled datasets."""
    H, W, C = im_ref.shape
    xs, ys = geometry.grid_points(H, W, dtype=planes.dtype,
                                  device=planes.device)
    raw = geometry.plane_disparity(planes, xs, ys)
    disp = d_step * ((raw - d_min) / raw.new_full((), d_step) + d_min)
    u, v = project(P_other, xs, ys, disp)
    M = interp2(im_other, u, v, oobv=oobv)
    return ephoto(M - im_ref, col_thresh, C)


def rssd_volume(images, Ps, disparities, col_thresh: float, window: int, *,
                oobv: float = -1000.0):
    """Windowed robust-SSD correlation volume, normalized to scores in
    [~0, 1]: [D, H-2w, W-2w] (segpln, dispmap_globalstereo.m:84-108).

    images: [H, W, C] tensors on one device, images[0] the reference; Ps:
    [3, 4] tensors; disparities: the descending grid.  Each image's volume
    is built ``LEVELS_PER_CHUNK`` levels at a time and added to the sum in
    image order; score = (X - corr) / X with X the worst-case ephoto times
    the number of images."""
    im_ref = images[0]
    H, W, C = im_ref.shape
    dtype, dev = im_ref.dtype, im_ref.device
    dvec = torch.as_tensor(np.asarray(disparities, dtype=np.float64),
                           dtype=dtype, device=dev)
    xs, ys = geometry.grid_points(H, W, dtype=dtype, device=dev)
    D = dvec.shape[0]
    corr = torch.zeros((D, H - 2 * window, W - 2 * window), dtype=dtype,
                       device=dev)
    for im, P in zip(images, Ps):
        vol = torch.empty_like(corr)
        for c0 in range(0, D, LEVELS_PER_CHUNK):
            d = dvec[c0:c0 + LEVELS_PER_CHUNK, None, None]
            u, v = project(P, xs, ys, d * torch.ones((H, W), dtype=dtype,
                                                     device=dev))
            Y = interp2(im, u, v, oobv=oobv)  # [n, H, W, C]
            E = ephoto(Y - im_ref, col_thresh, C)
            vol[c0:c0 + LEVELS_PER_CHUNK] = valid_average_2d(E, window)
        corr = corr + vol
    X = ephoto(torch.full((1, 1, C), oobv, dtype=dtype, device=dev)
               - im_ref[:1, :1], col_thresh, C)
    X = X[0, 0] * len(images)
    return (X - corr) / X
