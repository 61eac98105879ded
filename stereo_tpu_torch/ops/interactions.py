"""Occlusion interaction detection — the find_interactions equivalent (port
of stereo_tpu/ops/interactions.py).

The reference's mex (imrender/ojw/find_interactions.cxx:48-72) scans points
sorted by projected x; every pair within ``dist`` in both x and y interacts,
ordered (occluder, occluded) by depth z.  It emits a variable-length pair
list into a bounded buffer (MAX_MEAN_INTERACTIONS per point).

Dense form: for each point a and each forward offset o in 1..max_offsets,
whether (a, a+o) interact and which of the two occludes, as [N, O] masks on
the points' device.  Because x is sorted, all interactions of a lie within a
bounded forward window (the same assumption as the mex's buffer bound).
The compaction to a pair list runs on the host in numpy.
"""

from __future__ import annotations

import numpy as np
import torch


def find_interactions(
    x: torch.Tensor,  # [N] projected x, sorted ascending
    y: torch.Tensor,  # [N]
    z: torch.Tensor,  # [N] depth (smaller = nearer = occluder)
    dist: float = 0.5,
    max_offsets: int = 32,
):
    """Returns (partner [N, O] int32, occluder_first [N, O] bool,
    valid [N, O] bool): for valid (a, o), the pair is (a, partner[a, o]) and
    occluder_first says whether a (not the partner) is the occluder."""
    N = x.shape[0]
    idx = torch.arange(N, device=x.device)
    o = torch.arange(1, max_offsets + 1, device=x.device)
    b = (idx[:, None] + o[None, :]).clamp(0, N - 1)  # [N, O]
    in_range = idx[:, None] + o[None, :] <= N - 1
    ok = (in_range & (x[b] <= x[:, None] + dist)
          & (torch.abs(y[b] - y[:, None]) <= dist))
    first = z[:, None] < z[b]  # a occludes b iff a is nearer
    return b.to(torch.int32), first, ok


def interactions_to_pairs(partner, occluder_first, valid):
    """Host-side compaction to an (occluder, occluded) index list [M, 2]."""
    host = lambda a: (a.cpu().numpy() if isinstance(a, torch.Tensor)
                      else np.asarray(a))
    partner = host(partner)
    first = host(occluder_first)
    valid = host(valid)
    a_idx = np.broadcast_to(
        np.arange(partner.shape[0])[:, None], partner.shape
    )
    a = a_idx[valid]
    b = partner[valid]
    f = first[valid]
    occluder = np.where(f, a, b)
    occluded = np.where(f, b, a)
    return np.stack([occluder, occluded], axis=1)
