"""Image segmentation for smoothness weights and SegPln proposals (port of
stereo_tpu/proposals/segmentation.py).

Two backends, the reference's pair (dispmap_globalstereo.m:121-134):

- ``felzenszwalb``: graph-based segmentation, entirely in the port's native
  C++ copy (``stereo_tpu_torch/native``), the vgg_segment_gb equivalent.
- ``mean_shift``: EDISON-style mean-shift segmentation (vgg_segment_ms):
  the *filtering* stage, which moves every pixel's (x, y, L, u, v) feature
  to its mode under uniform kernels, runs on the device as plain PyTorch;
  the merge stage (mode connection, transitive region fusion, small-region
  pruning) is host-side union-find in the native library.

The filter's strict window tests are decided by the last bit (see
``mean_shift_filter``), so its arithmetic is written to round as the JAX
package's does: constant divisions on the host in numpy, squares as
``d * d``, the window sums accumulated one offset after another in the JAX
package's offset order, and no fused multiply-add (each elementwise
operation is its own kernel).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from stereo_tpu_torch import native
from stereo_tpu_torch.device import DEFAULT_DEVICE, resolve_device


# --------------------------------------------------------------------- LUV

# EDISON's exact conversion constants (seg_ms/msImageProcessor.h:61-73):
# whitepoint (Xn, Yn, Zn) = (0.9505, 1, 1.0887) with u'/v' hardcoded to
# higher precision than the whitepoint derivation.
_RGB2XYZ = np.array(
    [
        [0.4125, 0.3576, 0.1804],
        [0.2125, 0.7154, 0.0721],
        [0.0193, 0.1192, 0.9502],
    ],
    dtype=np.float64,
)
_YN = 1.0
_UN = 0.19784977571475
_VN = 0.46834507665248


def _on_host(a):
    """(numpy array, device) of a tensor or an array (the CPU for an
    array)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy(), a.device
    return np.asarray(a), torch.device("cpu")


def rgb_to_luv(im) -> torch.Tensor:
    """[H, W, 3] RGB in [0, 255] -> CIE LUV, in the input's dtype and on its
    device (a numpy array gives a CPU tensor).

    Matches EDISON's RGBtoLUV (seg_ms/msImageProcessor.cpp:835-875): XYZ from
    0..255 RGB, L* from y/(255*Yn) with the 903.3 linear branch below
    Lt = 0.008856, u*/v* against the hardcoded u'/v' whitepoint.

    Computed on the host with numpy, so the result is the same bits on every
    device.  Each row of the 3 x 3 colour product is a chain of
    multiply-adds, each rounded once to the input's type from a float64 sum
    of the exact float32 product, as the JAX package's dot rounds on the
    CPU; no matrix-product path (TF32) touches it.  The cube root is the JAX
    package's: XLA computes ``cbrt(y)`` as ``|y| ** t`` with the third t
    rounded to the input's type; here that power is taken in float64 and
    rounded once (PyTorch has no ``cbrt``, and numpy's float32 ``cbrt``
    rounds otherwise)."""
    x, device = _on_host(im)
    dt = x.dtype.type
    rgb = x / dt(255.0)
    M = _RGB2XYZ.astype(x.dtype)

    def row(d):
        t = rgb[..., 0] * M[d, 0]
        for c in (1, 2):
            t = (rgb[..., c].astype(np.float64) * M[d, c] + t).astype(dt)
        return t

    X, Y, Z = row(0), row(1), row(2)
    y_ratio = Y / dt(_YN)
    cbrt = np.power(np.abs(y_ratio).astype(np.float64),
                    np.float64(dt(1.0 / 3.0))).astype(dt)
    L = np.where(y_ratio > dt(0.008856), dt(116.0) * cbrt - dt(16.0),
                 dt(903.3) * y_ratio)
    denom = X + dt(15.0) * Y + dt(3.0) * Z
    denom = np.where(denom == 0, dt(1.0), denom)
    u_p = dt(4.0) * X / denom
    v_p = dt(9.0) * Y / denom
    u = dt(13.0) * L * (u_p - dt(_UN))
    v = dt(13.0) * L * (v_p - dt(_VN))
    return torch.as_tensor(np.stack([L, u, v], axis=-1).astype(dt),
                           device=device)


# ---------------------------------------------------------- mean-shift filter

_MS_EPSILON = 0.01  # EDISON's mode-convergence threshold (ms.h:106)
_MS_LIMIT = 100     # EDISON's per-pixel iteration cap (ms.h:111)
# window offsets whose gathers and window tests run in one batch; their sums
# are still accumulated one offset after another
_OFFSETS_PER_BATCH = 32


def window_offsets(h_s: int) -> list[tuple[int, int]]:
    """The (dy, dx) lattice offsets that can pass the spatial test around
    the rounded current position, in the JAX package's order.

    |pixel - round(pos)| <= |pixel - pos| + |pos - round(pos)|, and the
    per-coordinate rounding error of 0.5 is sqrt(1/2) in Euclidean norm, so
    radius h_s + sqrt(1/2) bounds the offsets that can ever pass dsp < 1."""
    sS = float(h_s)
    slack = float(np.sqrt(0.5)) + 1e-9
    R = int(np.ceil(sS + slack))
    return [(dy, dx) for dy in range(-R, R + 1) for dx in range(-R, R + 1)
            if dy * dy + dx * dx <= (sS + slack) ** 2]


def mean_shift_filter(luv, h_s: int, h_r: float,
                      max_iters: int = _MS_LIMIT) -> torch.Tensor:
    """Filter each pixel's joint feature (x, y, L, u, v) to its mode —
    EDISON's exact non-optimized lattice filter (NewNonOptimizedFilter,
    seg_ms/msImageProcessor.cpp:4305-4630), run for all pixels in lockstep
    with per-pixel freezing instead of EDISON's serial per-pixel loop:

    - joint space scaled by (h_s, h_r); uniform kernel = spatial distance^2
      < 1 AND range distance^2 < 1, both strict, tested separately;
    - the L-channel difference counts 4x when the current (scaled) L exceeds
      80/h_r (the ``hiLTr`` half-bandwidth quirk, :4484-4487);
    - convergence when the mean-shift vector's magnitude^2 drops below
      EPSILON = 0.01 — in *scaled* units for the first test, *unscaled*
      units thereafter (:4609-4613) — or after LIMIT = 100 steps; the final
      vector is applied once more after the loop exits (:4619-4620).

    luv: [H, W, 3] tensor (its device and dtype are the filter's) or numpy
    array (a CPU tensor).  Returns the modes [H, W, 3].

    The strict window tests are knife-edge at integer h_s: the first step
    evaluates lattice points at spatial distance exactly h_s, where
    ``dsp < 1`` is decided by the last bit of ``(x+h_s)/h_s - x/h_s``.  So
    the lattice tables ``arange / h_s`` and ``luv / h_r`` are IEEE divisions
    in numpy on the host (a CUDA division by a Python number multiplies by
    the reciprocal), and the device only gathers from the exact tables.
    The host loop reads one flag a step (``max(mv) >= EPSILON``)."""
    luv, device = _on_host(luv)
    dt = luv.dtype.type
    H, W, _ = luv.shape
    sS, sR = float(h_s), float(h_r)
    offs = window_offsets(h_s)
    R = max(max(abs(dy), abs(dx)) for dy, dx in offs)
    Hp, Wp = H + 2 * R, W + 2 * R

    # the gather table over the lattice padded by R: (y/h_s, x/h_s, L/h_r,
    # u/h_r, v/h_r, in-bounds); a window sum adds in-window rows of it, so
    # its last column counts the points
    sval = np.asarray(luv / dt(sR), luv.dtype)
    table = np.zeros((Hp, Wp, 6), luv.dtype)
    table[R:R + H, R:R + W, 0] = (np.arange(H) / dt(sS)).astype(dt)[:, None]
    table[R:R + H, R:R + W, 1] = (np.arange(W) / dt(sS)).astype(dt)[None, :]
    table[R:R + H, R:R + W, 2:5] = sval
    table[R:R + H, R:R + W, 5] = 1
    table = torch.as_tensor(table.reshape(Hp * Wp, 6), device=device)
    step_of = torch.as_tensor([dy * Wp + dx for dy, dx in offs],
                              device=device)
    # the position at step 0: (y/h_s, x/h_s, L/h_r, u/h_r, v/h_r)
    yk = table.view(Hp, Wp, 6)[R:R + H, R:R + W, :5].clone()
    hiLTr = 80.0 / sR

    def ms_vector(yk):
        """EDISON's LatticeMSVector: mean of in-window points minus yk."""
        cy = torch.clamp(torch.round(yk[..., 0] * sS).long(), 0, H - 1)
        cx = torch.clamp(torch.round(yk[..., 1] * sS).long(), 0, W - 1)
        base = (cy + R) * Wp + (cx + R)
        quad = torch.where(yk[..., 2] > hiLTr, 4.0, 1.0).to(yk.dtype)
        acc = torch.zeros((H, W, 6), dtype=yk.dtype, device=yk.device)
        for o0 in range(0, len(offs), _OFFSETS_PER_BATCH):
            steps = step_of[o0:o0 + _OFFSETS_PER_BATCH]
            idx = base[None] + steps[:, None, None]  # [G, H, W]
            g = table.index_select(0, idx.reshape(-1)).view(*idx.shape, 6)
            d = g[..., :5] - yk
            sq = d * d
            dsp = sq[..., 0] + sq[..., 1]
            dr = quad * d[..., 2] * d[..., 2] + sq[..., 3] + sq[..., 4]
            w = (g[..., 5] > 0) & (dsp < 1.0) & (dr < 1.0)
            wg = w.to(g.dtype)[..., None] * g
            for i in range(wg.shape[0]):
                acc = acc + wg[i]
        n = acc[..., 5:]
        has = n > 0
        return torch.where(has, acc[..., :5] / torch.clamp_min(n, 1.0) - yk,
                           0.0)

    def magnitude(mh, scale_s, scale_r):
        sq = mh * mh
        return ((sq[..., 0] + sq[..., 1]) * scale_s
                + (sq[..., 2] + sq[..., 3] + sq[..., 4]) * scale_r)

    mh = ms_vector(yk)
    # the first magnitude test is in scaled units (:4520-4523)
    sq = mh * mh
    mv = sq[..., 0] + sq[..., 1] + (sq[..., 2] + sq[..., 3] + sq[..., 4])
    it = 1
    while it < max_iters and bool((mv >= _MS_EPSILON).any()):
        active = mv >= _MS_EPSILON
        a5 = active[..., None]
        yk = torch.where(a5, yk + mh, yk)
        mh = torch.where(a5, ms_vector(yk), mh)
        # later tests use unscaled magnitudes (:4609-4613)
        mv = torch.where(active, magnitude(mh, sS * sS, sR * sR), mv)
        it += 1
    # the final shift is applied on every exit path (:4619-4620)
    return (yk[..., 2:] + mh[..., 2:]) * sR


# ------------------------------------------------------------ public wrappers


def mean_shift(im_rgb, h_s: int, h_r: float, min_region: int,
               max_iters: int = _MS_LIMIT, *,
               device=DEFAULT_DEVICE) -> np.ndarray:
    """EDISON-style segmentation -> uint32 labels [H, W], 1-based.

    The vgg_segment_ms(A, h_s, h_r, min_sz) equivalent: float32 LUV, the
    filter on ``device``, the merge in the native library."""
    dev = resolve_device(device)
    luv = rgb_to_luv(_on_host(im_rgb)[0].astype(np.float32)).to(dev)
    modes = np.ascontiguousarray(
        mean_shift_filter(luv, int(h_s), float(h_r), max_iters).cpu().numpy(),
        np.float32)
    H, W, _ = modes.shape
    labels = np.zeros((H, W), dtype=np.uint32)
    native.lib().connect_modes(
        modes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        H, W, ctypes.c_float(float(h_r)), int(min_region),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return labels


def felzenszwalb(im_rgb, sigma: float, k: float, min_size: int) -> np.ndarray:
    """Graph-based segmentation -> uint32 labels [H, W], 1-based, on the
    host.  The vgg_segment_gb(A, sigma, k, min_sz, 1) equivalent."""
    im = np.ascontiguousarray(_on_host(im_rgb)[0], dtype=np.float32)
    H, W = im.shape[:2]
    labels = np.zeros((H, W), dtype=np.uint32)
    native.lib().felzenszwalb(
        im.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        H, W, ctypes.c_float(float(sigma)), ctypes.c_float(float(k)),
        int(min_size),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return labels
