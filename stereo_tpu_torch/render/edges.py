"""Pairwise dictionary edge costs (truncquad_edges.cxx) — dense min-plus
(port of stereo_tpu/render/edges.py).

The reference computes, for an edge between two pixels with mode sets
(modes1, modes2) and colour libraries (lib1, lib2) indexed by a shared
sample position v (= one (input image, depth) pair):

    cost[a, b] = weight * min(thresh, min_v(d1[v, a] + d2[v, b]))
    d_i[v, x]  = || lib_i[:, v] - modes_i[x] ||^2

Its inner skip tests (truncquad_edges.cxx:136-177: drop v when
min_a d1[v,a] >= thresh; drop (v,b) when d2[v,b] >= thresh - min_a d1[v,a])
are pure pruning — every skipped candidate satisfies d1 + d2 >= thresh, so
the dense min-plus above is exactly equivalent.  The whole image's edges
evaluate as one batched tensor program; the channel sum runs in channel
order.
"""

from __future__ import annotations

import torch


def _dists(lib, modes):
    """lib: [..., C, V]; modes: [..., A, C] -> [..., V, A] squared dists."""
    diff = lib[..., None, :, :] - modes[..., :, None]  # [..., A, C, V]
    sq = diff * diff
    d = sq[..., 0, :]
    for c in range(1, sq.shape[-2]):
        d = d + sq[..., c, :]
    return d.transpose(-1, -2)


def truncquad_edges(lib1, lib2, modes1, modes2, thresh, weight=1.0):
    """Edge cost matrices for batched edges.

    lib1/lib2: [..., C, V]; modes1/modes2: [..., A, C] / [..., B, C].
    Returns [..., A, B] = weight * min(thresh, min_v(d1[v,a] + d2[v,b])).
    """
    d1 = _dists(lib1, modes1)  # [..., V, A]
    d2 = _dists(lib2, modes2)  # [..., V, B]
    s = d1[..., :, None] + d2[..., None, :]  # [..., V, A, B]
    # thresh rounded to the data's type as a cast rounds it (1e100 -> inf)
    t = torch.tensor(float(thresh), dtype=torch.float64).to(s.dtype)
    return weight * torch.minimum(torch.amin(s, dim=-3), t.to(s.device))
