"""The NCC model (example_ncc.m): stereo_tpu_torch's ``DispMapNCC`` with its
grid of RANSAC plane proposals and fronto-parallel ladder, and its plain
reference (reference/ncc.py).  The model's contract is in __init__.py.

Its own numbers, each against its limit in portbench/limits/<cell>.json (a
number passes when it is at most its limit):

- ``ncc``: share of the cost volume's entries that differ from the
  reference's by more than NCC_TOL;
- ``start``: share of pixels whose start disparity (the WTA field the jobs
  restart from) differs from the reference's by more than check.DISP_TOL;
- ``proposals``: share of the proposals whose plane lies more than
  PLANE_TOL pixels of disparity from the reference's anywhere on the
  plane's support (the disk it was fitted to; the whole image for the
  fronto-parallel ladder).  A share, not the largest gap: a fit to widely
  scattered WTA points is ill-conditioned, and float32 rounding alone
  moves it by tens of pixels, so one or two such fits pass, and a fault
  in the fits, which moves many, does not.

The control: the reference's cost volume rounded to bfloat16 is handed to
the program in place of its own float32 volume, and every later stage
(start, proposals, solve, energy) runs on it.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import check
from portbench.reference import ncc as ref_ncc
from portbench.reference import planes as geo

NUMBERS = ("ncc", "start", "proposals")
NCC_TOL = 1e-3  # NCC units
PLANE_TOL = 0.5  # pixels of disparity


def disparities(cfg: dict) -> np.ndarray:
    lo, hi = cfg["disparities"]
    return np.arange(lo, hi + 1, dtype=np.float64)


def build(cfg: dict, ims, device, control=None):
    """(DispMapNCC at the WTA start, grid_proposals); ``control`` a cost
    volume used in place of the program's own."""
    from stereo_tpu_torch.models.ncc import DispMapNCC, grid_proposals

    dtype = np.dtype(cfg["dtype"])
    disp = disparities(cfg)
    dm = DispMapNCC(
        [im.astype(dtype) for im in ims], disp, kernel=cfg["kernel"],
        unary_weight=cfg["unary_weight"], tol=cfg["tol"],
        maxiter=cfg["maxiter"], max_relgap=cfg["max_relgap"],
        schedule=cfg["schedule"], device=device, ncc=control)
    p = cfg["proposals"]
    return dm, grid_proposals(dm, p["grid_step"], int(disp[-1]), p["radius"])


def view(dm) -> dict:
    return {"ncc": dm.ncc}


def control(ref) -> torch.Tensor:
    return ref.vol.to(torch.bfloat16).to(torch.float32)


class Reference:
    """The reference's pieces for one configuration, float64 on ``device``:
    the cost volume, the WTA start and the proposal planes."""

    normalize = None

    def __init__(self, cfg: dict, images, device):
        self.cfg = cfg
        self.disp = disparities(cfg)
        self.tol = float(cfg["tol"])
        im0, im1 = (torch.as_tensor(np.asarray(im, np.float64),
                                    dtype=torch.float64, device=device)
                    for im in images)
        self.vol = ref_ncc.ncc_volume(im0, im1, self.disp)
        self.wta = ref_ncc.wta_disparity(self.vol, self.disp)
        self.start = geo.fronto(self.wta)
        p = cfg["proposals"]
        self.radius = p["radius"]
        self.planes, self.nodes = ref_ncc.proposals(
            self.wta.cpu().numpy(), p["grid_step"], int(self.disp[-1]),
            p["radius"], p["ladder_step"], p["origin"])

    def field(self, k: int) -> torch.Tensor:
        """Proposal k as a [4, H, W] field."""
        H, W = self.wta.shape
        return torch.as_tensor(self.planes[k], dtype=self.vol.dtype,
                               device=self.vol.device)[:, None, None].expand(
                                   4, H, W)

    def candidates(self) -> list:
        """The start field, then each proposal."""
        return [self.start] + [self.field(k) for k in range(len(self.planes))]

    def unary(self, planes) -> torch.Tensor:
        return ref_ncc.unary(self.vol, self.disp, self.cfg["unary_weight"],
                             planes)

    def edge_weights(self) -> torch.Tensor:
        return geo.edge_mask(*self.wta.shape, self.vol)

    def energy(self, planes) -> float:
        planes = planes.to(self.vol.dtype)
        return float(self.unary(planes).sum() + geo.smoothness(
            planes, self.tol, self.edge_weights(), self.normalize))

    def label_problem(self, planes: torch.Tensor):
        """(theta, D0, Q, alphas, tol) of the K-label problem whose label k
        is the plane field planes[k] [4, H, W]."""
        planes = planes.to(self.vol.dtype)
        D0, Q, _ = geo.positions(planes, self.normalize)
        return self.unary(planes), D0, Q, self.edge_weights(), self.tol


def plane_gap(p: np.ndarray, q: np.ndarray, node, radius: float, H: int,
              W: int) -> float:
    """Largest disparity difference of two planes over the support of the
    fit (the disk of ``radius`` around ``node``), or over the whole image
    for a plane fitted to nothing (``node`` None).  The difference of two
    planes is linear: its largest size on a disk is its size at the centre
    plus the radius times its gradient's, on the image at a corner."""
    def disp(r, x, y):
        return -(r[0] * x + r[1] * y + r[3]) / r[2]

    if node is not None:
        x, y = node
        grad = np.hypot(p[0] / p[2] - q[0] / q[2], p[1] / p[2] - q[1] / q[2])
        gap = abs(disp(p, x, y) - disp(q, x, y)) + radius * grad
    else:
        gap = max(abs(disp(p, x, y) - disp(q, x, y))
                  for x in (1, W) for y in (1, H))
    return float(gap) if np.isfinite(gap) else float("inf")


def proposal_gaps(ref: Reference, program: dict, order) -> list[float]:
    """Each proposal's plane_gap to the reference's, in the jobs' order."""
    H, W = ref.wta.shape
    props = program["proposals"]
    if len(props) != len(ref.planes):
        raise ValueError(f"the program made {len(props)} proposals, the "
                         f"reference {len(ref.planes)}")
    gaps = []
    for k, field in zip(order, props):
        p = field[:, 0, 0].double().cpu().numpy()
        one_plane = torch.equal(field, field[:, :1, :1].expand_as(field))
        gaps.append(plane_gap(p, ref.planes[k], ref.nodes[k], ref.radius,
                              H, W) if one_plane else float("inf"))
    return gaps


def judge(ref: Reference, program: dict, order) -> dict:
    vol = program["ncc"].to(ref.vol.dtype)
    out = {"ncc": float(((vol - ref.vol).abs() > NCC_TOL).double().mean())}
    d_start = geo.own_disparity(program["start"].to(ref.vol.dtype))
    out["start"] = float(((d_start - ref.wta).abs() > check.DISP_TOL)
                         .double().mean())
    gaps = np.asarray(proposal_gaps(ref, program, order))
    out["proposals"] = float(np.mean(~(gaps <= PLANE_TOL)))
    return out


def readings(ref: Reference, program: dict, order) -> dict:
    return {"proposal_gaps": sorted(proposal_gaps(ref, program, order),
                                    reverse=True)}
