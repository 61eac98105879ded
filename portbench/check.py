"""The comparison that decides a run's ``correct``: what the timed jobs
produced, judged against the plain reference (portbench/reference/), which
works every piece out again from the images.

Numbers every job is judged on (COMMON; each against its own limit in
portbench/limits/<cell>.json; a number passes when it is at most its
limit); the model's own numbers are in portbench/models/<model>.py, the job
kind's in portbench/jobs/<kind>.py:

- ``labels``: share of pixels whose final plane is none of the reference's
  candidates there (its ``candidates()``: the proposals and the start
  field), worst job;
- ``energy``: |E_program - E_reference(program's labelling)| / E_reference,
  worst job, E_program the energy the program reports for its final
  labelling.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import planes as geo

DISP_TOL = 1e-2  # pixels of disparity
SLOPE_TOL = 1e-4  # pixels of disparity per pixel

COMMON = ("labels", "energy")


def _unmatched_share(ref, planes) -> float:
    """Share of pixels whose plane (a, b, c, d) is within the tolerances of
    none of the reference's candidate fields at that pixel."""
    H, W = ref.start.shape[-2:]
    P = planes.to(ref.start.dtype)
    a, b, d = P[0] / P[2], P[1] / P[2], P[3] / P[2]
    xs, ys = geo.grid_xy(H, W, P)
    disp = -(a * xs + b * ys + d)
    hit = torch.zeros((H, W), dtype=torch.bool, device=P.device)
    for c in ref.candidates():
        dc = -(c[0] * xs + c[1] * ys + c[3]) / c[2]
        hit |= (((a - c[0] / c[2]).abs() <= SLOPE_TOL)
                & ((b - c[1] / c[2]).abs() <= SLOPE_TOL)
                & ((disp - dc).abs() <= DISP_TOL))
    return 1.0 - float(hit.double().mean())


def judge(ref, model, kind, order, program: dict,
          jobs: list) -> tuple[dict, list]:
    """Every number of COMMON, of the model ``model`` and of the job kind
    ``kind`` (their modules) for the program's pieces (``program``: the
    model's ``view()``, its "proposals" in the jobs' order, the "start"
    field the jobs restart from, and the kind's ``view()``) and the
    window's ``jobs``, against the model's Reference ``ref``.  Returns
    (numbers: each the worst over the jobs that have it, the per-job
    numbers of each job)."""
    out = model.judge(ref, program, order)
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
