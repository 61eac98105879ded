"""Visualization: disparity maps and triangulated 3D surface views (port of
stereo_tpu/utils/viz.py).

Equivalents of display_current_dispmap (dispmap_super.m:203-209) and
display_surfaces (dispmap_globalstereo.m:221-332): the surface view
triangulates the pixel grid (two triangles per cell), cuts triangles whose
corner planes disagree by more than a tolerance (the reference's cutedges
logic), and renders the remaining mesh shaded by image intensity.

``save_dispmap`` writes the PNG itself (``utils.io.write_png``): an 8-bit
greyscale image scaled min to max as imagesc with gray(256) scales it, the
energy in a ``tEXt`` chunk ("Title"), no colour bar.  ``save_surfaces``
draws with matplotlib, imported when it is called: it raises where
matplotlib is not installed.
"""

from __future__ import annotations

import numpy as np
import torch

from stereo_tpu_torch.utils.io import write_png


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _grey_levels(disp) -> np.ndarray:
    """[H, W] uint8 grey levels of a disparity map: (d - min) / (max - min)
    in 256 equal bins (imagesc + gray(256)); a constant map is all 0, and a
    non-finite value is 0 and stays out of the min and the max."""
    d = _host(disp).astype(np.float64)
    ok = np.isfinite(d)
    if not ok.any():
        return np.zeros(d.shape, np.uint8)
    lo, hi = d[ok].min(), d[ok].max()
    t = (d - lo) / (hi - lo) if hi > lo else np.zeros_like(d)
    level = np.clip(np.floor(t * 256.0), 0, 255)
    return np.where(ok, level, 0).astype(np.uint8)


def save_dispmap(path: str, disp, energy: float | None = None, cmap="gray"):
    """PNG of a disparity map (imagesc + gray(256) equivalent)."""
    if cmap != "gray":
        raise ValueError(f"save_dispmap writes greyscale only, not {cmap!r}")
    text = ({"Title": f"Solution energy: {energy:g}"}
            if energy is not None else None)
    return write_png(path, _grey_levels(disp), text)


def surface_mesh(assignment, image_gray, tol: float = 1000.0, roi=None):
    """Triangulated surface with plane-disagreement edge cuts.

    assignment: [4, H, W] plane field; image_gray: [H, W] intensities.
    roi: optional (ys slice, xs slice).
    Returns (vertices [N, 3] (x, y, disp), triangles [M, 3], tri_shade [M]).
    """
    planes = _host(assignment)
    gray = _host(image_gray)
    if roi is not None:
        ys, xs = roi
        planes = planes[:, ys, xs]
        gray = gray[ys, xs]
    _, H, W = planes.shape

    xs1, ys1 = np.meshgrid(np.arange(1, W + 1, dtype=np.float64),
                           np.arange(1, H + 1, dtype=np.float64))
    disp = -(planes[0] * xs1 + planes[1] * ys1 + planes[3]) / planes[2]

    def plane_at(corner_idx, point_idx):
        """Disparity of corner's plane evaluated at point's coordinates."""
        py, px = point_idx
        cy, cx = corner_idx
        return -(planes[0, cy, cx] * xs1[py, px] + planes[1, cy, cx] * ys1[py, px]
                 + planes[3, cy, cx]) / planes[2, cy, cx]

    nodes = np.arange(H * W).reshape(H, W)
    tris, shades = [], []
    ys0, xs0 = np.mgrid[0:H - 1, 0:W - 1]
    ys0, xs0 = ys0.ravel(), xs0.ravel()

    def cut(c1, c2):
        """True where the two corners' planes disagree at each other's point
        beyond tol (dispmap_globalstereo.m:266-271)."""
        d1 = disp[c1]
        d1p = plane_at(c2, c1)
        d2 = disp[c2]
        d2p = plane_at(c1, c2)
        return ((d1 - d1p) > tol) | ((d2 - d2p) > tol)

    for corner_set in (
        ((ys0, xs0), (ys0, xs0 + 1), (ys0 + 1, xs0)),  # upper-left triangles
        ((ys0, xs0 + 1), (ys0 + 1, xs0 + 1), (ys0 + 1, xs0)),  # lower-right
    ):
        c1, c2, c3 = corner_set
        cutedges = cut(c1, c2) | cut(c2, c3) | cut(c1, c3)
        keep = ~cutedges
        tris.append(
            np.stack([nodes[c1][keep], nodes[c2][keep], nodes[c3][keep]], 1)
        )
        shades.append(gray[c1][keep])

    verts = np.stack([xs1.ravel(), ys1.ravel(), disp.ravel()], axis=1)
    return verts, np.concatenate(tris, 0), np.concatenate(shades, 0)


def save_surfaces(path: str, assignment, image, tol: float = 1000.0,
                  roi=None, energy: float | None = None, view=(270, 0)):
    """Render the triangulated surface view to a PNG (display_surfaces).
    Needs matplotlib."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    im = _host(image)
    gray = im.mean(axis=-1) / 255.0 if im.ndim == 3 else im
    verts, tris, shade = surface_mesh(assignment, gray, tol, roi)

    fig = plt.figure(figsize=(8, 7))
    ax = fig.add_subplot(projection="3d")
    polys = verts[tris]
    coll = Poly3DCollection(polys, linewidths=0)
    colors = np.clip(shade, 0, 1)
    coll.set_facecolor(np.stack([colors, colors, colors, np.ones_like(colors)], 1))
    ax.add_collection3d(coll)
    ax.set_xlim(verts[:, 0].min(), verts[:, 0].max())
    ax.set_ylim(verts[:, 1].min(), verts[:, 1].max())
    ax.set_zlim(verts[:, 2].min(), verts[:, 2].max())
    ax.view_init(elev=view[0], azim=view[1])
    if energy is not None:
        ax.set_title(f"Energy {energy:g}")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
