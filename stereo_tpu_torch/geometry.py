"""Plane-label algebra on dense pixel grids (port of stereo_tpu/geometry.py).

A plane field is ``[..., 4, H, W]``; each pixel's label is a 3D plane
``(a, b, c, d)`` with disparity ``-(a*x + b*y + d) / c``.  The 4-neighbourhood
is expressed with static shifts of the grid.

Coordinate convention: 1-based pixel coordinates (x = column index + 1,
y = row index + 1), as in the JAX package, so energies computed on identical
inputs agree.
"""

from __future__ import annotations

import functools

import torch

from stereo_tpu_torch.device import DEFAULT_DEVICE, resolve_device

# Neighbor offsets (dy, dx): a direction ``d`` denotes the in-edge from the
# neighbor at ``(y + dy, x + dx)`` into pixel ``(y, x)``.  Order: left, right,
# up, down.
DIRS: tuple[tuple[int, int], ...] = ((0, -1), (0, 1), (-1, 0), (1, 0))
NUM_DIRS = len(DIRS)
# OPP[d] = index of the opposite direction.
OPP: tuple[int, ...] = (1, 0, 3, 2)


def take_plane(X: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """X[idx[s], s] for every site s: X [K, *S], idx [*S] int -> [*S].

    A plain gather (exact); the JAX package's one-hot sum computes the same
    selection."""
    return torch.gather(X, 0, idx[None].long())[0]


def grid_points(H: int, W: int, dtype=torch.float32, device=DEFAULT_DEVICE,
                x0: int = 0):
    """1-based pixel coordinates ``(xs, ys)``, each of shape [H, W]; ``x0``
    is the global column of column 0 (a column shard of a wider image)."""
    dev = resolve_device(device)
    ys = torch.arange(1, H + 1, dtype=dtype, device=dev)[:, None].expand(H, W)
    xs = torch.arange(1 + x0, W + 1 + x0, dtype=dtype,
                      device=dev)[None, :].expand(H, W)
    return xs, ys


def plane_disparity(planes, xs, ys):
    """Evaluate plane labels at points: ``-(a*x + b*y + d) / c``.

    planes: [..., 4, H, W]; xs, ys: broadcastable to [H, W] -> [..., H, W]."""
    a = planes[..., 0, :, :]
    b = planes[..., 1, :, :]
    c = planes[..., 2, :, :]
    d = planes[..., 3, :, :]
    return -(a * xs + b * ys + d) / c


def own_disparity(planes, x0: int = 0):
    """Disparity of each pixel's own plane at its own point (``x0``: see
    grid_points)."""
    H, W = planes.shape[-2:]
    xs, ys = grid_points(H, W, dtype=planes.dtype, device=planes.device,
                         x0=x0)
    return plane_disparity(planes, xs, ys)


@functools.lru_cache(maxsize=64)
def _ok_mask(H: int, W: int, d: int, device) -> torch.Tensor:
    """[H, W] bool: True where the direction-``d`` neighbor is in bounds.

    Built once per (size, direction, device) and shared: every shift of every
    solver phase asks for it, and rebuilding it costs more launches than the
    shift itself.  Callers must not write to the result."""
    dy, dx = DIRS[d]
    ok = torch.ones((H, W), dtype=torch.bool, device=device)
    if dy == -1:
        ok[0, :] = False
    elif dy == 1:
        ok[H - 1, :] = False
    if dx == -1:
        ok[:, 0] = False
    elif dx == 1:
        ok[:, W - 1] = False
    return ok


def shift_from_neighbor(field, d: int, fill=0.0):
    """Bring each pixel's neighbor value (direction ``d``) to the pixel.

    out[..., y, x] = field[..., y + dy, x + dx] where (dy, dx) = DIRS[d];
    out-of-bounds entries are ``fill``."""
    dy, dx = DIRS[d]
    out = torch.roll(field, shifts=(-dy, -dx), dims=(-2, -1))
    return mask_valid(out, d, fill)


def _scalar_like(field, value):
    """``value`` as the Python scalar of ``field``'s kind, so that
    ``torch.where(mask, field, value)`` keeps ``field``'s dtype and needs no
    host-to-device copy."""
    if field.dtype == torch.bool:
        return bool(value)
    return float(value) if field.dtype.is_floating_point else int(value)


def mask_valid(field, d: int, fill=0.0):
    """Replace entries whose direction-``d`` neighbor is out of bounds."""
    H, W = field.shape[-2:]
    ok = _ok_mask(H, W, d, field.device)
    return torch.where(ok, field, _scalar_like(field, fill))


def valid_mask(H: int, W: int, d: int, dtype=torch.bool,
               device=DEFAULT_DEVICE):
    """[H, W] mask: True (1) where the direction-``d`` neighbor exists."""
    return _ok_mask(H, W, d, resolve_device(device)).to(dtype, copy=True)


def neighbor_plane_disparity(planes, d: int, fill=float("inf"),
                             x0: int = 0):
    """Disparity of the direction-``d`` *neighbor's* plane evaluated at the
    pixel's *own* point.  planes: [..., 4, H, W] -> [..., H, W]; invalid
    borders get ``fill`` (``x0``: see grid_points)."""
    H, W = planes.shape[-2:]
    xs, ys = grid_points(H, W, dtype=planes.dtype, device=planes.device,
                         x0=x0)
    shifted = shift_from_neighbor(planes, d, fill=1.0)  # fill keeps c != 0
    disp = plane_disparity(shifted, xs, ys)
    return mask_valid(disp, d, fill)


def fronto_parallel(H: int, W: int, disparity, dtype=torch.float32,
                    device=DEFAULT_DEVICE):
    """Constant-disparity plane field: (0, 0, 1, -disparity). [4, H, W]."""
    dev = resolve_device(device)
    disparity = torch.as_tensor(disparity, dtype=dtype, device=dev)
    zeros = torch.zeros((H, W), dtype=dtype, device=dev)
    ones = torch.ones((H, W), dtype=dtype, device=dev)
    return torch.stack([zeros, zeros, ones, -disparity * ones], dim=0)


def plane_field_from_disparity(disp):
    """Per-pixel fronto-parallel field from a disparity map [H, W]."""
    zeros = torch.zeros_like(disp)
    ones = torch.ones_like(disp)
    return torch.stack([zeros, zeros, ones, -disp], dim=0)
