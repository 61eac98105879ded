"""Output-view projection matrices (ojw_genview.m, P2stereoP.m, P_interp.m;
port of stereo_tpu/render/genview.py).

Pure numpy (and scipy for ``interp_views``): these run once per render, on
3x4 matrices — no device work.
"""

from __future__ import annotations

import numpy as np


def stereo_views(P: np.ndarray, z_min: float, view: float = -1.0) -> np.ndarray:
    """Horizontally shifted viewpoints for stereo display (P2stereoP.m).

    P: [..., 3, 4] projection matrices; z_min: minimum scene depth;
    view: -1 = optimal left, +1 = optimal right, values in between shift
    proportionally ('l'/'m'/'r' accepted as in the reference)."""
    P = np.array(P, dtype=np.float64, copy=True)
    if isinstance(view, str):
        view = float(np.sign(ord(view[0]) - ord("m")))
    # shift the camera centre, then the image plane (P2stereoP.m:30-31)
    P[..., 0, 3] += view * 70.0 * z_min
    P[..., 0, :] -= P[..., 2, :] * (view * 50.0)
    return P


def _kr_from_p(P: np.ndarray):
    """RQ decomposition of P[:, :3] plus camera centre (KR_from_P)."""
    t = -np.linalg.solve(P[:, :3], P[:, 3])
    st = lambda M: M[::-1, ::-1].T
    R, K = np.linalg.qr(st(P[:, :3]))
    return st(K), st(R), t


def interp_views(first: np.ndarray, last: np.ndarray,
                 frames) -> np.ndarray:
    """Linear interpolation between two projection matrices (P_interp.m).

    frames: array of positions along the path (0 = first, 1 = last).
    Returns [N, 3, 4]."""
    from scipy.linalg import fractional_matrix_power

    k0, r0, t0 = _kr_from_p(np.asarray(first, np.float64))
    k1, r1, t1 = _kr_from_p(np.asarray(last, np.float64))

    # absorb pure sign differences of K into R (P_interp.m:28-35)
    a = np.diag(k0) / np.diag(k1)
    b = np.sign(a)
    if np.all(np.abs(a - b) < 1e-8) and np.any(b == -1):
        s = np.diag(np.sign(b + 0.5))
        k0 = k0 @ s
        r0 = s @ r0

    t_step = t1 - t0
    r_step = r0.T @ r1
    k_step = k1 - k0

    frames = np.atleast_1d(np.asarray(frames, np.float64))
    out = np.empty((len(frames), 3, 4))
    for i, f in enumerate(frames):
        P = np.eye(3, 4)
        P[:, 3] = -t0 - t_step * f
        P = r0 @ np.real(fractional_matrix_power(r_step, f)) @ P
        out[i] = (k0 + k_step * f) @ P
    return out


def genview(kind: str, Pi: np.ndarray, ind, offset,
            disps=None, points=None) -> np.ndarray:
    """Generate output projection matrices (ojw_genview.m).

    kind: 'input' | 'stereo' | 'steady'.  Pi: [N, 3, 4] input matrices.
    For 'stereo', scene depth comes from `disps` (z_min = 1/max(disps)) or
    SfM `points` ([M, 3], z_min = 0.8 * min projected depth)."""
    Pi = np.asarray(Pi, np.float64)
    ind = np.atleast_1d(ind)
    if kind == "input":
        return Pi[ind]
    if kind == "stereo":
        Pout = Pi[ind]
        if disps is not None:
            z_min = 1.0 / float(np.max(disps))
        elif points is not None:
            pts = np.concatenate(
                [np.asarray(points, np.float64),
                 np.ones((len(points), 1))], axis=1)
            z = Pout[0, 2] @ pts.T
            z_min = float(z.min()) * 0.8  # extend range 20% at front
        else:
            raise ValueError("'stereo' needs disps or points for Zmin")
        return stereo_views(Pout, z_min, offset)
    if kind == "steady":
        return interp_views(Pi[ind[0]], Pi[ind[1]], offset)
    raise ValueError(f"unknown view kind {kind!r}")
