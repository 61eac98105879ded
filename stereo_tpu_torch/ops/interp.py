"""Image sampling, the vgg_interp2 equivalent (port of
stereo_tpu/ops/interp.py): bilinear, cubic and nearest.

1-based coordinates; for the bilinear sampler a point is in bounds iff
1 <= x <= W and 1 <= y <= H (boundary inclusive: the floor index is clamped
to W-1/H-1 so x == W degenerates to exact edge interpolation); out-of-bounds
points get the scalar ``oobv``.
"""

from __future__ import annotations

import torch


def interp2(im, x, y, oobv=float("nan")):
    """Sample ``im`` at 1-based continuous coordinates.

    im: [H, W] or [H, W, C]; x, y: any (equal) shape S.
    Returns S or S + (C,) matching im's trailing channels."""
    squeeze = im.ndim == 2
    if squeeze:
        im = im[..., None]
    H, W, C = im.shape
    compute_dtype = torch.promote_types(im.dtype, x.dtype)
    imf = im.to(compute_dtype)

    valid = (x >= 1) & (x <= W) & (y >= 1) & (y <= H)

    x0 = torch.clamp(torch.floor(x), 1, max(W - 1, 1))
    y0 = torch.clamp(torch.floor(y), 1, max(H - 1, 1))
    u = (x - x0).to(compute_dtype)[..., None]
    v = (y - y0).to(compute_dtype)[..., None]
    # 0-based, clamped for safety on invalid points (discarded via `valid`)
    xi = torch.clamp(x0.long() - 1, 0, W - 2 if W > 1 else 0)
    yi = torch.clamp(y0.long() - 1, 0, H - 2 if H > 1 else 0)

    a = imf[yi, xi]
    b = imf[yi, xi + 1]
    c = imf[yi + 1, xi]
    d = imf[yi + 1, xi + 1]
    top = a + (b - a) * u
    bot = c + (d - c) * u
    out = top + (bot - top) * v

    oob = torch.as_tensor(oobv, dtype=compute_dtype, device=im.device)
    out = torch.where(valid[..., None], out, oob)
    if squeeze:
        out = out[..., 0]
    return out


def interp2_cubic(im, x, y, oobv=float("nan")):
    """Cubic-hermite sampling with the mex's exact weight polynomial and
    in-bounds window [2, W-1) x [2, H-1) (vgg_interp2.cxx:325-368)."""
    squeeze = im.ndim == 2
    if squeeze:
        im = im[..., None]
    H, W, C = im.shape
    compute_dtype = torch.promote_types(im.dtype, x.dtype)
    imf = im.to(compute_dtype)

    valid = (x >= 2) & (x < W - 1) & (y >= 2) & (y < H - 1)
    x0 = torch.clamp(torch.floor(x), 2, max(W - 2, 2)).long()
    y0 = torch.clamp(torch.floor(y), 2, max(H - 2, 2)).long()
    u = (x - x0).to(compute_dtype)[..., None]
    v = (y - y0).to(compute_dtype)[..., None]

    def col_interp(cs, t):
        c0, c1, c2, c3 = cs
        a = (c3 + c1) - (c2 + c0)
        return (t * t * t * a + t * t * ((c0 - c1) - a) + t * (c2 - c0)
                + c1)

    rows = []
    for m in range(4):
        xi = torch.clamp(x0 - 2 + m, 0, W - 1)
        cs = [imf[torch.clamp(y0 - 2 + n, 0, H - 1), xi] for n in range(4)]
        rows.append(col_interp(cs, v))
    out = col_interp(rows, u)
    oob = torch.as_tensor(oobv, dtype=compute_dtype, device=im.device)
    out = torch.where(valid[..., None], out, oob)
    if squeeze:
        out = out[..., 0]
    return out


def interp2_nearest(im, x, y, oobv=float("nan")):
    """Nearest-neighbor sampling; in-bounds window [0.5, W+0.5) as the mex
    (vgg_interp2.cxx:218-243).  Halves round to even, as jnp.round does."""
    squeeze = im.ndim == 2
    if squeeze:
        im = im[..., None]
    H, W, C = im.shape
    valid = (x >= 0.5) & (x < W + 0.5) & (y >= 0.5) & (y < H + 0.5)
    xi = torch.clamp(torch.round(x).long() - 1, 0, W - 1)
    yi = torch.clamp(torch.round(y).long() - 1, 0, H - 1)
    out = im[yi, xi]
    oob = torch.as_tensor(oobv, dtype=im.dtype, device=im.device)
    out = torch.where(valid[..., None], out, oob)
    if squeeze:
        out = out[..., 0]
    return out
