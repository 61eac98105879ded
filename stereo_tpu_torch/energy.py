"""Energy of a plane-label field: unary + truncated second-order smoothness
(port of stereo_tpu/energy.py).

The pairwise term is summed over *directed* edges.  For the directed edge
(tail n -> head p) the cost is

    w_e * min(|d_{l_p}(x_p) - d_{l_n}(x_p)|^k, tol),   k in {1, 2}

Dense formulation: for each of the 4 in-edge directions d, the per-pixel cost
field is ``w[d] * trunc(|D0 - Q_d|)`` where D0[p] = own disparity and
Q_d[p] = neighbor's plane at p's point; border pixels are masked via w[d] = 0.

Energy sums accumulate in promote(dtype, float32).  A sum on the card is taken
in another order than on the CPU, so float32 energies of the two agree to
about 1e-6 relative, not bit for bit.
"""

from __future__ import annotations

import torch

from stereo_tpu_torch import geometry
from stereo_tpu_torch.device import DEFAULT_DEVICE, acc_dtype
from stereo_tpu_torch.geometry import NUM_DIRS


def truncated_kernel(diff, kernel: int, tol):
    """min(|diff|, tol) for kernel 1, min(diff^2, tol) for kernel 2."""
    tol = float(tol)  # a host scalar: no upload per call
    if kernel == 1:
        return diff.abs().clamp(max=tol)
    elif kernel == 2:
        return (diff * diff).clamp(max=tol)
    raise ValueError(f"Unknown smoothness kernel {kernel!r}")


def default_weights(H: int, W: int, dtype=torch.float32,
                    device=DEFAULT_DEVICE):
    """All-ones directed edge weights [4, H, W], zero where no neighbor
    exists.  weights[d, y, x] multiplies the in-edge from the DIRS[d]
    neighbor of (y, x)."""
    return torch.stack(
        [geometry.valid_mask(H, W, d, dtype=dtype, device=device)
         for d in range(NUM_DIRS)], dim=0)


def normalized(x, normalize: tuple | None):
    """(x - d_min) / d_step for normalize = (d_min, d_step); x if None.

    The divisor is a 0-dim tensor on x's device: a CUDA division by a Python
    number is a multiplication by its reciprocal, which can differ in the
    last bit from the division the CPU and the JAX package take."""
    if normalize is None:
        return x
    return (x - normalize[0]) / x.new_full((), normalize[1])


def pairwise_energy_map(planes, weights, kernel: int, tol,
                        normalize: tuple | None = None):
    """Per-pixel sum of in-edge smoothness costs. [4,H,W] planes -> [H,W]."""
    D0 = normalized(geometry.own_disparity(planes), normalize)
    total = torch.zeros_like(D0)
    for d in range(NUM_DIRS):
        Qd = normalized(geometry.neighbor_plane_disparity(planes, d, fill=0.0),
                   normalize)
        cost = truncated_kernel(D0 - Qd, kernel, tol)
        # weights[d] is zero on invalid borders, so the fill never counts.
        total = total + weights[d] * cost
    return total


def pairwise_energy(planes, weights, kernel: int, tol,
                    normalize: tuple | None = None):
    """Total smoothness energy (scalar tensor)."""
    m = pairwise_energy_map(planes, weights, kernel, tol, normalize)
    return m.sum(dtype=acc_dtype(m.dtype))


def total_energy(unary, planes, weights, kernel: int, tol,
                 normalize: tuple | None = None):
    """unary: per-pixel unary cost map [H, W] of the current labeling."""
    return unary.sum(dtype=acc_dtype(unary.dtype)) + pairwise_energy(
        planes, weights, kernel, tol, normalize)


def binary_fusion_pairwise_tables(current, proposal, kernel: int, tol,
                                  normalize: tuple | None = None):
    """Per-direction E00/E01/E10/E11 cost maps for a binary fusion move.

    Returns [4, 4, H, W] indexed [d, table, :, :] with table order
    (E00, E01, E10, E11); label 0 = current, 1 = proposal.  For the directed
    edge (tail n -> head p), E_{ab} uses tail label a and head label b."""
    D0_cur = normalized(geometry.own_disparity(current), normalize)
    D0_new = normalized(geometry.own_disparity(proposal), normalize)
    out = []
    for d in range(NUM_DIRS):
        Q_cur = normalized(geometry.neighbor_plane_disparity(current, d, fill=0.0),
                      normalize)
        Q_new = normalized(geometry.neighbor_plane_disparity(proposal, d, fill=0.0),
                      normalize)
        e00 = truncated_kernel(D0_cur - Q_cur, kernel, tol)
        e01 = truncated_kernel(D0_new - Q_cur, kernel, tol)
        e10 = truncated_kernel(D0_cur - Q_new, kernel, tol)
        e11 = truncated_kernel(D0_new - Q_new, kernel, tol)
        out.append(torch.stack([e00, e01, e10, e11], dim=0))
    return torch.stack(out, dim=0)


def fuse_labelling(current, proposal, take):
    """Merge: where take (bool [H, W]) pick proposal's plane, else current."""
    return torch.where(take[None, :, :], proposal, current)
