"""Plain reference of the plane geometry and the smoothness that every
stereo model of the benchmark shares, float64 by default.

The conventions are the reference MATLAB code's:

- a plane (a, b, c, d) has disparity -(a x + b y + d) / c at the 1-based
  pixel (x, y);
- the directed edges of the 4-neighbourhood: E(p, d) runs from the tail
  n = p + DIRS[d] to the head p, and its smoothness term is
  w[d, p] * min(|D(p) - D_n(p)|, tol) (kernel 1), D(p) the head's own
  disparity, D_n(p) the tail's plane evaluated at p, both normalised as
  (x - d_min) / d_step where the model states a ``normalize`` of
  (d_min, d_step);
- edge weights w [4, H, W] are 0 where the tail would lie outside the
  image (``edge_mask``: 1 on every other edge).

Plain PyTorch; it imports nothing of the program.
"""

from __future__ import annotations

import torch

# (dy, dx) of the neighbour each in-edge direction comes from: left, right,
# up, down
DIRS = ((0, -1), (0, 1), (-1, 0), (1, 0))


def grid_xy(H: int, W: int, like: torch.Tensor):
    """1-based pixel coordinates (xs, ys), [H, W] each."""
    ys = torch.arange(1, H + 1, dtype=like.dtype, device=like.device)
    xs = torch.arange(1, W + 1, dtype=like.dtype, device=like.device)
    return xs[None, :].expand(H, W), ys[:, None].expand(H, W)


def plane_disparity(planes: torch.Tensor, xs, ys) -> torch.Tensor:
    """Disparity of planes [..., 4, H, W] at the points (xs, ys)."""
    a, b, c, d = planes.unbind(-3)
    return -(a * xs + b * ys + d) / c


def own_disparity(planes: torch.Tensor) -> torch.Tensor:
    H, W = planes.shape[-2:]
    return plane_disparity(planes, *grid_xy(H, W, planes))


def has_neighbour(H: int, W: int, d: int, device=None) -> torch.Tensor:
    """[H, W] mask of the pixels that have a direction-d neighbour."""
    dy, dx = DIRS[d]
    ok = torch.ones((H, W), dtype=torch.bool, device=device)
    if dy:
        ok[H - 1 if dy > 0 else 0, :] = False
    if dx:
        ok[:, W - 1 if dx > 0 else 0] = False
    return ok


def neighbour_disparity(planes: torch.Tensor, d: int):
    """(disparity at each pixel of its direction-d neighbour's plane, mask of
    the pixels that have that neighbour)."""
    H, W = planes.shape[-2:]
    dy, dx = DIRS[d]
    shifted = torch.roll(planes, shifts=(-dy, -dx), dims=(-2, -1))
    ok = has_neighbour(H, W, d, planes.device)
    safe = torch.where(ok, shifted, torch.ones_like(shifted))
    return plane_disparity(safe, *grid_xy(H, W, planes)), ok


def fronto(disp: torch.Tensor) -> torch.Tensor:
    """Per-pixel fronto-parallel planes (0, 0, 1, -d) of a disparity map."""
    z = torch.zeros_like(disp)
    return torch.stack([z, z, torch.ones_like(disp), -disp], dim=0)


def edge_mask(H: int, W: int, like: torch.Tensor) -> torch.Tensor:
    """[4, H, W]: 1 on every edge whose tail lies in the image, else 0."""
    return torch.stack([has_neighbour(H, W, d, like.device).to(like.dtype)
                        for d in range(len(DIRS))])


def normalized(x: torch.Tensor, normalize) -> torch.Tensor:
    """(x - d_min) / d_step for normalize = (d_min, d_step); x if None."""
    if normalize is None:
        return x
    return (x - normalize[0]) / normalize[1]


def positions(planes: torch.Tensor, normalize=None):
    """(D0 [..., H, W], Q [4, ..., H, W], ok [4, H, W]) of planes
    [..., 4, H, W]: each pixel's own disparity, each direction's neighbour
    plane at the pixel (0 where there is none), normalised, and the mask of
    the pixels that have each neighbour."""
    D0 = normalized(own_disparity(planes), normalize)
    Q, ok = [], []
    for d in range(len(DIRS)):
        q, m = neighbour_disparity(planes, d)
        Q.append(torch.where(m, normalized(q, normalize),
                             torch.zeros_like(q)))
        ok.append(m)
    return D0, torch.stack(Q), torch.stack(ok)


def smoothness(planes: torch.Tensor, tol: float, weights: torch.Tensor,
               normalize=None) -> torch.Tensor:
    """Truncated-linear smoothness of a plane field [4, H, W] summed over the
    directed edges, each weighted by ``weights`` [4, H, W]."""
    D0, Q, ok = positions(planes, normalize)
    total = torch.zeros((), dtype=planes.dtype, device=planes.device)
    for d in range(len(DIRS)):
        cost = weights[d] * (D0 - Q[d]).abs().clamp(max=tol)
        total = total + torch.where(ok[d], cost, torch.zeros_like(cost)).sum()
    return total
