"""Plain reference of the NCC stereo model (example_ncc.m's settings): the
cost volume, the winner-take-all start, the RANSAC plane proposals, the
unary and the energy of a plane field.

Written from the model's definition, in float64 by default, with plain
PyTorch and NumPy: it imports nothing of the program and takes nothing the
program made.  The conventions are the reference MATLAB code's:

- NCC over a 5 x 5 patch, its statistics summed over RGB, zero padding at the
  borders; the second image shifted left by d (integer disparities), columns
  x < d + 1 (1-based) set to 0, non-finite values set to 0;
- the WTA disparity refined by the parabola through the best level and its
  two neighbours (the first maximum on ties; none at the ends of the range);
- the NCC at a continuous disparity: the parabola through the three levels
  around the nearest one (ties to the larger), the raw level at the ends,
  -1e6 outside the range; the unary is w * (1 - NCC);
- the smoothness is planes.py's, weight 1 on every edge, disparities in
  pixels (kernel 1);
- a RANSAC proposal is the plane fitted, by 20 passes of reweighted least
  squares (weights sqrt(|residual|)), to the WTA points within ``radius`` of
  a grid node.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import planes as geo

LARGEVAL = 1e6


def box_sum(x: torch.Tensor, r: int) -> torch.Tensor:
    """Sum of x [..., H, W] over the (2r+1)^2 window, zero padding, by an
    integral image."""
    H, W = x.shape[-2:]
    k = 2 * r + 1
    p = F.pad(x, (r + 1, r, r + 1, r))
    s = p.cumsum(-1).cumsum(-2)
    return (s[..., k:, k:] - s[..., :H, k:] - s[..., k:, :W]
            + s[..., :H, :W])


def ncc_volume(im0: torch.Tensor, im1: torch.Tensor, disparities,
               patch_radius: int = 2) -> torch.Tensor:
    """[D, H, W] NCC of im0 against im1 shifted by each (integer) disparity;
    im0, im1 [H, W, 3] in the dtype to compute in."""
    disp = np.asarray(disparities, dtype=np.float64)
    if np.any(disp != np.round(disp)) or np.any(disp < 0):
        raise ValueError("the reference volume takes non-negative integer "
                         "disparities")
    H, W, C = im0.shape
    n = float((2 * patch_radius + 1) ** 2 * C)
    s1r = box_sum(im0.sum(-1), patch_radius)
    var_r = box_sum((im0 * im0).sum(-1), patch_radius) - s1r * s1r / n
    out = torch.zeros((len(disp), H, W), dtype=im0.dtype, device=im0.device)
    for level, d in enumerate(disp.astype(np.int64)):
        if d >= W:
            continue
        t = torch.zeros_like(im1)
        t[:, d:] = im1[:, :W - d]
        s1t = box_sum(t.sum(-1), patch_radius)
        var_t = box_sum((t * t).sum(-1), patch_radius) - s1t * s1t / n
        cross = box_sum((im0 * t).sum(-1), patch_radius) - s1r * s1t / n
        v = cross / torch.sqrt(var_r * var_t)
        v = torch.where(torch.isfinite(v), v, torch.zeros_like(v))
        out[level, :, d:] = v[:, d:]
    return out


def _parabola_at(y1, y2, y3, d1, d2, d3, x):
    """Value at x of the parabola through (d1, y1), (d2, y2), (d3, y3)."""
    return (y1 * (x - d2) * (x - d3) / ((d1 - d2) * (d1 - d3))
            + y2 * (x - d1) * (x - d3) / ((d2 - d1) * (d2 - d3))
            + y3 * (x - d1) * (x - d2) / ((d3 - d1) * (d3 - d2)))


def wta_disparity(vol: torch.Tensor, disparities) -> torch.Tensor:
    """[H, W] winner-take-all disparity with parabola refinement."""
    D = vol.shape[0]
    d = torch.as_tensor(np.asarray(disparities, np.float64), dtype=vol.dtype,
                        device=vol.device)
    t = torch.argmax(vol, dim=0)
    inner = (t > 0) & (t < D - 1)
    tm, tp = (t - 1).clamp(0, D - 1), (t + 1).clamp(0, D - 1)
    y1, y2, y3 = (torch.gather(vol, 0, i[None])[0] for i in (tm, t, tp))
    d1, d2, d3 = d[tm], d[t], d[tp]
    # vertex of the parabola through the three points
    num = (d2 - d1) ** 2 * (y2 - y3) - (d2 - d3) ** 2 * (y2 - y1)
    den = (d2 - d1) * (y2 - y3) - (d2 - d3) * (y2 - y1)
    ok = inner & (den != 0)
    vertex = d2 - 0.5 * num / torch.where(ok, den, torch.ones_like(den))
    return torch.where(ok, vertex, d2)


def sample_ncc(vol: torch.Tensor, disparities, disp: torch.Tensor):
    """NCC at continuous disparities ``disp`` [..., H, W]."""
    D = vol.shape[0]
    d = torch.as_tensor(np.asarray(disparities, np.float64), dtype=disp.dtype,
                        device=disp.device)
    up = torch.searchsorted(d, disp.contiguous()).clamp(0, D - 1)
    lo = (up - 1).clamp(0, D - 1)
    j = torch.where((disp - d[up]).abs() <= (disp - d[lo]).abs(), up, lo)
    jm, jp = (j - 1).clamp(0, D - 1), (j + 1).clamp(0, D - 1)
    lead = disp.shape[:-2]
    v = vol.to(disp.dtype).expand(*lead, *vol.shape) if lead else vol.to(
        disp.dtype)
    axis = len(lead)
    y1, y2, y3 = (torch.gather(v, axis, i.unsqueeze(axis)).squeeze(axis)
                  for i in (jm, j, jp))
    inner = (j > 0) & (j < D - 1)
    one = torch.ones_like(disp)
    val = _parabola_at(y1, y2, y3, torch.where(inner, d[jm], one - 1),
                       d[j], torch.where(inner, d[jp], one + 1), disp)
    val = torch.where(inner, val, y2)
    good = (disp >= d[0]) & (disp <= d[-1])
    return torch.where(good, val, torch.full_like(val, -LARGEVAL))


def unary(vol, disparities, weight: float, planes):
    """w * (1 - NCC at each pixel's own disparity): [..., H, W]."""
    return weight * (1.0 - sample_ncc(vol, disparities,
                                      geo.own_disparity(planes)))


def energy(vol, disparities, weight: float, tol: float, planes) -> float:
    """Total energy of a plane field [4, H, W]: the unary and the
    smoothness of weight 1 on every edge."""
    planes = planes.to(vol.dtype)
    return float(unary(vol, disparities, weight, planes).sum()
                 + geo.smoothness(planes, tol,
                                  geo.edge_mask(*planes.shape[-2:], planes)))


def fit_plane(xs: np.ndarray, ys: np.ndarray, ds: np.ndarray,
              passes: int = 20) -> np.ndarray:
    """(a, b, c, d) with c = 1 fitted to the points (x, y, d) by reweighted
    least squares: each pass takes the normal of the smallest singular value
    of the weighted, centred points, then sets the weights to
    sqrt(|residual|) (the reference's own reweighting)."""
    pts = np.stack([xs, ys, ds], axis=1).astype(np.float64)
    c = pts.mean(axis=0)
    cen = pts - c
    w = np.ones(len(pts))
    for _ in range(passes):
        m = w[:, None] * cen
        _, vecs = np.linalg.eigh(m.T @ m)
        v = vecs[:, 0]
        w = np.sqrt(np.abs(cen @ v))
    p = np.append(v, -v @ c)
    return p / p[2]


def proposals(wta: np.ndarray, grid_step: int, max_disp: int,
              radius: float, ladder_step: int, origin: int = 10):
    """example_ncc's proposal planes, as (a, b, c, d) vectors, and each
    one's fit node (None for the ladder): a plane fit at each node (x, y) of
    a ``grid_step`` grid from (origin, origin) (x outer, y inner, 1-based),
    then fronto-parallel planes at 0, ladder_step, ..., max_disp."""
    H, W = wta.shape
    ys, xs = np.mgrid[1:H + 1, 1:W + 1].astype(np.float64)
    planes, nodes = [], []
    for x in range(origin, W + 1, grid_step):
        for y in range(origin, H + 1, grid_step):
            m = np.sqrt((xs - x) ** 2 + (ys - y) ** 2) < radius
            planes.append(fit_plane(xs[m], ys[m], wta[m]))
            nodes.append((x, y))
    for d in range(0, max_disp + 1, ladder_step):
        planes.append(np.array([0.0, 0.0, 1.0, -float(d)]))
        nodes.append(None)
    return planes, nodes
