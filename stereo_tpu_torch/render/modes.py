"""Truncated-quadratic colour modes (truncquad_modes.cxx) — a dense tensor
program (port of stereo_tpu/render/modes.py).

The reference (imrender/ojw/truncquad_modes.cxx) finds, per pixel, the colour
modes of a library of L sampled colours at each of M depths: every pair of
library vectors closer than 4·thresh seeds a mean-shift iteration under the
truncated quadratic kernel; converged clusters with >=2 inliers are deduped
by converged energy and kept only if no nearby depth (within search_width)
gives the centre a lower energy.

Dense form: all L(L-1)/2 pair seeds at all M depths iterate mean-shift in
parallel (a masked fixed-point iteration, one host check a round), dedupe
and the depth-mode test are dense comparisons, and the variable-length
output becomes a fixed-capacity top-`max_modes` selection per pixel
(energy-ascending, +inf padded, a stable sort so equal energies keep their
seed order).  Convergence (``e == e_prev``) and the dedupe are exact float
equalities, so every sum over channels and library vectors runs in index
order, as the JAX package's does.

use_variance follows the m-file convention (truncquad_modes.m): 0 = sum cost
over all vectors (default); 1 = inlier cost / n_inliers; 2 = inlier cost /
(n_inliers - 1).
"""

from __future__ import annotations

import numpy as np
import torch


def _seq_sum(x, dim: int):
    """Sum over ``dim`` left to right: ((x0 + x1) + x2) + ..."""
    out = x.select(dim, 0)
    for i in range(1, x.shape[dim]):
        out = out + x.select(dim, i)
    return out


def _cluster_energy(I, centre, thresh):
    """I: [..., C, L]; centre: [..., C].  Returns (energy, dist2 [..., L])."""
    diff = I - centre[..., :, None]
    d2 = _seq_sum(diff * diff, -2)  # [..., L]
    e = _seq_sum(torch.clamp(d2, max=thresh), -1)
    return e, d2


def truncquad_modes(I, thresh, use_variance: int = 0,
                    search_width: int | None = None, max_modes: int = 8,
                    max_iters: int = 64):
    """Colour modes of I: [..., C, L, M] (C channels, L library vectors, M
    depths; leading axes batch over pixels), a tensor.

    Returns a dict of dense per-pixel mode tables, energy-ascending:
      modes   [..., max_modes, C]   cluster centres,
      depth   [..., max_modes]      int32 depth index (0-based; -1 = pad),
      energy  [..., max_modes]      converged cost / L (reference
                                    normalizer), +inf at pads,
      inliers [..., max_modes, L]   bool inlier sets,
      count   [...]                 number of valid modes (may exceed
                                    max_modes; excess lowest-priority modes
                                    are dropped).
    """
    *batch, C, L, M = I.shape
    dtype, dev = I.dtype, I.device
    uv = int(use_variance) - 1  # internal convention of the C code
    sw = M if search_width is None else int(search_width)
    p1, p2 = (torch.as_tensor(a, device=dev)
              for a in np.triu_indices(L, k=1))
    P = p1.shape[0]
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)

    # ----------------------------------------------------- seeds [.., M, P]
    Im = torch.movedim(I, -1, -3)  # [..., M, C, L]
    a = Im.index_select(-1, p1)  # [..., M, C, P]
    b = Im.index_select(-1, p2)
    ab = a - b
    pair_ok = _seq_sum(ab * ab, -2) <= 4.0 * thresh  # [..., M, P]
    centre = torch.movedim((a + b) * 0.5, -1, -2)  # [..., M, P, C]

    lib = Im[..., None, :, :]  # [..., M, 1, C, L]

    # ------------------------------------- masked mean-shift to fixed point
    # do { e_up = e; e = update_energy(...) } while (e_up != e): each round
    # evaluates the energy/inliers at the current centre and moves the
    # centre to the inlier mean; converged seeds freeze under the mask.
    e_curr = torch.full(centre.shape[:-1], -1.0, dtype=dtype, device=dev)
    done = torch.zeros(centre.shape[:-1], dtype=torch.bool, device=dev)
    inliers = torch.zeros(centre.shape[:-1] + (L,), dtype=torch.bool,
                          device=dev)
    it = 0
    while it < max_iters and not bool(done.all()):
        e, d2 = _cluster_energy(lib, centre, thresh)  # e [.., M, P]
        inliers = d2 <= thresh  # [..., M, P, L]
        n = inliers.sum(dim=-1)
        total = _seq_sum(torch.where(inliers[..., None, :], lib,
                                     torch.zeros((), dtype=dtype,
                                                 device=dev)), -1)
        mean = total / torch.clamp(n, min=1).to(dtype)[..., None]
        done = done | (e == e_curr)
        centre = torch.where(done[..., None], centre, mean)
        e_curr = e
        it += 1
    n_inl = inliers.sum(dim=-1)  # [..., M, P]

    valid_cluster = pair_ok & (n_inl >= 2)

    # ------------------------------ dedupe by converged energy within depth
    # candidate i is a duplicate if an earlier valid cluster at the same
    # depth converged to exactly the same energy (truncquad_modes.cxx:112).
    eq = e_curr[..., :, None] == e_curr[..., None, :]  # [..., M, P, P]
    earlier = torch.tril(torch.ones((P, P), dtype=torch.bool, device=dev),
                         diagonal=-1)
    dup = (eq & earlier & valid_cluster[..., None, :]).any(dim=-1)
    valid = valid_cluster & ~dup

    # --------------------------------------- depth-mode test within +/- sw
    # energy of each centre against every other depth's library
    diff = (Im[..., :, None, None, :, :]
            - centre[..., None, :, :, :, None])  # [..., M(d2), M(d), P, C, L]
    d2_all = _seq_sum(diff * diff, -2)  # [..., M(d2), M(d), P, L]
    if uv < 0:
        e_other = _seq_sum(torch.clamp(d2_all, max=thresh), -1)
        e_ref = e_curr
    else:
        inl_o = d2_all <= thresh
        n_o = inl_o.sum(dim=-1)
        e_o = _seq_sum(torch.where(inl_o, d2_all,
                                   torch.zeros((), dtype=dtype, device=dev)),
                       -1)
        e_other = torch.where(n_o >= 2,
                              e_o / torch.clamp(n_o - uv, min=1).to(dtype),
                              inf)
        e_ref = ((e_curr - thresh * (L - n_inl).to(dtype))
                 / torch.clamp(n_inl - uv, min=1).to(dtype))
    # reference window (truncquad_modes.cxx:124-150): upward d2 in
    # [d+1, d+sw-1] (strict < lim), downward d2 in [d-sw, d-1] (>= lim)
    d_idx = torch.arange(M, device=dev)
    delta = d_idx[:, None] - d_idx[None, :]  # d2 - d
    in_win = ((delta >= 1) & (delta <= sw - 1)) | (
        (delta <= -1) & (delta >= -sw))
    beats = e_other < e_ref[..., None, :, :]  # [..., M(d2), M(d), P]
    beaten = (beats & in_win[:, :, None]).any(dim=-3)  # [..., M, P]
    valid = valid & ~beaten

    # ----------------------------------------- top-max_modes by energy
    e_flat = torch.where(valid, e_curr, inf).reshape(*batch, M * P)
    order = torch.argsort(e_flat, dim=-1, stable=True)[..., :max_modes]

    def gather(x):
        x = x.reshape(*batch, M * P, x.shape[-1])
        idx = order[..., None].expand(*order.shape, x.shape[-1])
        return torch.gather(x, -2, idx)

    modes = gather(centre)  # [..., max_modes, C]
    inl_out = gather(inliers)
    e_out = torch.gather(e_flat, -1, order)
    depth = torch.gather(
        torch.repeat_interleave(d_idx, P).expand(*batch, M * P), -1,
        order).to(torch.int32)
    ok = torch.isfinite(e_out)
    return {
        "modes": torch.where(ok[..., None], modes,
                             torch.zeros((), dtype=dtype, device=dev)),
        "depth": torch.where(ok, depth, torch.full_like(depth, -1)),
        "energy": torch.where(ok, e_out / torch.tensor(float(L), dtype=dtype,
                                                       device=dev), inf),
        "inliers": inl_out & ok[..., None],
        "count": valid.reshape(*batch, -1).sum(dim=-1),
    }
