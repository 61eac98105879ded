"""Edge-modes new-view renderer (ibr_edgemodes.m — Woodford et al. CVPR'07,
"Efficient New-view Synthesis using Pairwise Dictionary Priors"; port of
stereo_tpu/render/edgemodes.py).

Pipeline (reference: imrender/ojw/ibr_edgemodes.m):
  1. for every output pixel and disparity, project into each input view and
     sample colours (vgg_interp2, oobv = -1000);
  2. per pixel: truncated-quadratic colour modes over the (input x depth)
     library (truncquad_modes) — the label set;
  3. per 4-neighbour edge: pairwise dictionary costs between the two pixels'
     mode sets (truncquad_edges with thresh = 1e100, weight = lambda);
  4. choose one mode per pixel with TRW-S over explicit tables
     (vgg_trw_bp -> solvers/trws_tables), or the per-pixel argmin when
     lambda = 0 (slice_cell_image's no-labelling branch);
  5. assemble the rendered image from the selected modes.

Every stage is one dense tensor program over [H, W] on the images' device
with a fixed per-pixel mode capacity `max_modes` (+BIG unary padding),
which is also what the table solver needs.  connect=4 only, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from stereo_tpu_torch import geometry
from stereo_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from stereo_tpu_torch.ops import interp
from stereo_tpu_torch.render import edges as edges_mod
from stereo_tpu_torch.render import modes as modes_mod
from stereo_tpu_torch.solvers import trws_tables

OOBV = -1000.0
PAD_UNARY = 1e9


def as_images(images, device) -> list[torch.Tensor]:
    """The input views as tensors on ``device``, in their own dtype."""
    dev = resolve_device(device)
    return [im.to(dev) if isinstance(im, torch.Tensor)
            else torch.as_tensor(np.asarray(im), device=dev) for im in images]


def sample_depth_colors(images, P, disps, sz) -> torch.Tensor:
    """Project every output pixel at every disparity into each input view and
    sample colours.  images: list of [Hin, Win, C] tensors on one device;
    P: [N, 3, 4] projections relative to the output view (columns act on
    [x, y, 1, d]); disps: [M].  Returns [N, M, H, W, C] samples (OOBV
    outside)."""
    H, W = sz
    dtype, dev = images[0].dtype, images[0].device
    xs, ys = geometry.grid_points(H, W, dtype=dtype, device=dev)
    base = torch.stack([xs, ys, torch.ones_like(xs)], 0)  # [3, H, W]
    disps = torch.as_tensor(np.asarray(disps), dtype=dtype, device=dev)
    out = []
    for a in range(len(images)):
        Pa = torch.as_tensor(np.asarray(P[a]), dtype=dtype, device=dev)
        T = torch.tensordot(Pa[:, :3], base, dims=1)  # [3, H, W]
        p3 = Pa[:, 3]
        uvw = T[None] + disps[:, None, None, None] * p3[None, :, None, None]
        z = 1.0 / uvw[:, 2]
        u = uvw[:, 0] * z
        v = uvw[:, 1] * z
        out.append(interp.interp2(images[a].to(dtype), u, v,
                                  oobv=OOBV))  # [M, H, W, C]
    return torch.stack(out, 0)


@dataclasses.dataclass
class RenderResult:
    image: torch.Tensor  # [H, W, C]
    depth: torch.Tensor  # [H, W] selected disparity values
    energy: float | None
    lower_bound: float | None


def render_edgemodes(images, P, disps, sz, *, lam: float = 20.0,
                     thresh: float = 30.0, max_modes: int = 8,
                     maxiter: int = 100, max_relgap: float = 1e-4,
                     mode: str = "trws",
                     device=DEFAULT_DEVICE) -> RenderResult:
    """Render the output view (see module docstring) on ``device``.

    thresh is the per-channel colour threshold; the working threshold is
    colors * thresh**2 (ibr_edgemodes.m:33)."""
    H, W = sz
    images = as_images(images, device)
    I = sample_depth_colors(images, P, disps, sz)  # [N, M, H, W, C]
    N, M = I.shape[:2]
    C = I.shape[-1]
    dtype, dev = I.dtype, I.device
    work_thresh = C * float(thresh) ** 2

    lib = I.permute(2, 3, 4, 0, 1)  # [H, W, C, N(L), M]
    md = modes_mod.truncquad_modes(lib, work_thresh, use_variance=0,
                                   search_width=10_000,
                                   max_modes=max_modes)
    unary = torch.where(torch.isfinite(md["energy"]), md["energy"],
                        torch.tensor(PAD_UNARY, dtype=dtype, device=dev))
    unary = torch.movedim(unary, -1, 0).contiguous()  # [K, H, W]
    disps = torch.as_tensor(np.asarray(disps), dtype=dtype, device=dev)
    depth_of_mode = md["depth"]  # [H, W, K]

    if lam > 0:
        # per-pixel libraries flattened over (input, depth) sample pairs
        lib_flat = lib.reshape(H, W, C, N * M)
        tables = []
        for d in range(geometry.NUM_DIRS):
            dy, dx = geometry.DIRS[d]
            shift = lambda a: torch.roll(a, (-dy, -dx), dims=(0, 1))
            t = edges_mod.truncquad_edges(
                shift(lib_flat), lib_flat, shift(md["modes"]), md["modes"],
                1e100, lam)  # [H, W, K_tail, K_head]
            tables.append(t.permute(2, 3, 0, 1))
        tables = torch.stack(tables, 0).contiguous()  # [4, K, K, H, W]
        res = trws_tables.solve_tables(unary, tables, maxiter=maxiter,
                                       max_relgap=max_relgap, mode=mode)
        labels = res.labels.long()
        energy, lower_bound = float(res.energy), float(res.lower_bound)
    else:
        labels = torch.argmin(unary, dim=0)
        energy = float(torch.amin(unary, dim=0).sum())
        lower_bound = None

    sel = labels[..., None]  # [H, W, 1]
    image = torch.gather(
        md["modes"], -2,
        sel[..., None].expand(H, W, 1, C))[..., 0, :]
    depth_idx = torch.gather(depth_of_mode, -1, sel)[..., 0]
    depth = torch.where(depth_idx >= 0,
                        disps[torch.clamp(depth_idx, 0, M - 1).long()],
                        torch.tensor(float("nan"), dtype=dtype, device=dev))
    return RenderResult(image=image, depth=depth, energy=energy,
                        lower_bound=lower_bound)
