"""The comparison that decides a run's ``correct``: what the timed jobs
produced, judged against the plain reference (portbench/reference/), which
works every piece out again from the images.

Numbers every job kind is judged on (COMMON; each against its own limit in
portbench/limits/<cell>.json; a number passes when it is at most its
limit); the kind's own numbers are in portbench/jobs/<kind>.py:

- ``ncc``: share of the cost volume's entries that differ from the
  reference's by more than NCC_TOL;
- ``start``: share of pixels whose start disparity (the WTA field the jobs
  restart from) differs from the reference's by more than DISP_TOL;
- ``proposals``: share of the proposals whose plane lies more than
  PLANE_TOL pixels of disparity from the reference's anywhere on the
  plane's support (the disk it was fitted to; the whole image for the
  fronto-parallel ladder).  A share, not the largest gap: a fit to widely
  scattered WTA points is ill-conditioned, and float32 rounding alone
  moves it by tens of pixels, so one or two such fits pass, and a fault
  in the fits, which moves many, does not;
- ``labels``: share of pixels whose final plane is none of the reference's
  candidates there (the proposals and the start plane), worst job;
- ``energy``: |E_program - E_reference(program's labelling)| / E_reference,
  worst job, E_program the energy the program reports for its final
  labelling.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import model

NCC_TOL = 1e-3  # NCC units
DISP_TOL = 1e-2  # pixels of disparity
SLOPE_TOL = 1e-4  # pixels of disparity per pixel
PLANE_TOL = 0.5  # pixels of disparity

COMMON = ("ncc", "start", "proposals", "labels", "energy")


class Reference:
    """The reference's pieces for one configuration, float64 on ``device``."""

    def __init__(self, cfg: dict, images, device, dtype=torch.float64):
        self.cfg = cfg
        self.disp = disparities(cfg)
        im0, im1 = (torch.as_tensor(np.asarray(im, np.float64), dtype=dtype,
                                    device=device) for im in images)
        self.vol = model.ncc_volume(im0, im1, self.disp)
        self.wta = model.wta_disparity(self.vol, self.disp)
        p = cfg["proposals"]
        self.radius = p["radius"]
        self.planes, self.nodes = model.proposals(
            self.wta.cpu().numpy(), p["grid_step"], int(self.disp[-1]),
            p["radius"], p["ladder_step"], p["origin"])

    def field(self, k: int) -> torch.Tensor:
        """Proposal k as a [4, H, W] field."""
        H, W = self.wta.shape
        return torch.as_tensor(self.planes[k], dtype=self.vol.dtype,
                               device=self.vol.device)[:, None, None].expand(
                                   4, H, W)

    def energy(self, planes) -> float:
        return model.energy(self.vol, self.disp, self.cfg["unary_weight"],
                            self.cfg["tol"], planes)


def disparities(cfg: dict) -> np.ndarray:
    lo, hi = cfg["disparities"]
    return np.arange(lo, hi + 1, dtype=np.float64)


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


def _unmatched_share(ref: Reference, planes) -> float:
    """Share of pixels whose plane (a, b, c, d) is within the tolerances of
    none of the reference's candidates at that pixel."""
    H, W = ref.wta.shape
    P = planes.to(ref.vol.dtype)
    a, b, d = P[0] / P[2], P[1] / P[2], P[3] / P[2]
    xs, ys = model.grid_xy(H, W, ref.vol)
    disp = -(a * xs + b * ys + d)
    cand = torch.as_tensor(np.stack(ref.planes), dtype=ref.vol.dtype,
                           device=ref.vol.device)
    # the start field's fronto-parallel plane, then each proposal
    hit = (a.abs() <= SLOPE_TOL) & (b.abs() <= SLOPE_TOL) & (
        (disp - ref.wta).abs() <= DISP_TOL)
    for c in cand:
        dc = -(c[0] * xs + c[1] * ys + c[3]) / c[2]
        hit |= (((a - c[0] / c[2]).abs() <= SLOPE_TOL)
                & ((b - c[1] / c[2]).abs() <= SLOPE_TOL)
                & ((disp - dc).abs() <= DISP_TOL))
    return 1.0 - float(hit.double().mean())


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


def judge(ref: Reference, kind, order, program: dict,
          jobs: list) -> tuple[dict, list]:
    """Every number of COMMON and of the job kind ``kind`` (its module) for
    the program's pieces (``program``: its volume "ncc", its "proposals" in
    the jobs' order, the "start" field the jobs restart from, and the kind's
    ``view()``) and the window's ``jobs``.  Returns (numbers: each the worst
    over the jobs that have it, the per-job numbers of each job)."""
    vol = program["ncc"].to(ref.vol.dtype)
    out = {"ncc": float(((vol - ref.vol).abs() > NCC_TOL).double().mean())}
    d_start = model.own_disparity(program["start"].to(ref.vol.dtype))
    out["start"] = float(((d_start - ref.wta).abs() > DISP_TOL)
                         .double().mean())
    gaps = np.asarray(proposal_gaps(ref, program, order))
    out["proposals"] = float(np.mean(~(gaps <= PLANE_TOL)))

    per_job = []
    for job in jobs:
        e_ref = ref.energy(job["planes"])
        per_job.append({"labels": _unmatched_share(ref, job["planes"]),
                        "energy": abs(job["energy"] - e_ref) / e_ref})
    for row, own in zip(per_job, kind.judge(ref, program, jobs, order)):
        row.update(own)
    for name in {n for row in per_job for n in row}:
        out[name] = max(row[name] for row in per_job if name in row)
    return out, per_job


def verdict(numbers: dict, per_job: list, limits: dict, names):
    """(correct, failed jobs, checks): every number of ``names`` at most its
    limit; a job fails when one of its own numbers is over its limit."""
    checks = {}
    for name in names:
        v = numbers.get(name)
        lim = limits.get(name)
        ok = v is not None and lim is not None and np.isfinite(v) and v <= lim
        checks[name] = {"value": v, "limit": lim, "ok": bool(ok)}
    failed = sum(any(not (np.isfinite(v) and v <= limits.get(n, -1.0))
                     for n, v in row.items()) for row in per_job)
    return all(c["ok"] for c in checks.values()), failed, checks
