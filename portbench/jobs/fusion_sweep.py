"""A binary fusion sweep (CVPR 2013): ``dm.binary_fusion_sweep(proposals,
chunk=len(proposals))`` from the start field, one fusion move a proposal in
the seed's order.

Judged, besides check.COMMON, against the reference's own fusion sweep of
the same proposals in the same order from its own start field
(reference/fusion.py):

- ``fusion_trace``: the largest relative gap between the program's energy
  after each of the first TRACE_MOVES moves and the reference's;
- ``fusion_median``: the median over all moves of that gap: the float32
  and float64 sweeps part at knife-edge decisions and the gap after the
  last move alone swings from seed to seed.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import fusion

NUMBERS = ("fusion_trace", "fusion_median")
TRACE_MOVES = 3


class Job:
    def __init__(self, dm, mix):
        self.dm, self.mix = dm, mix

    def set_seed(self, seed: int):
        pass

    def warm_up(self, proposals):
        n = self.mix["warmup"]
        self.dm.binary_fusion_sweep(proposals[:n], chunk=n)

    def run(self, proposals) -> dict:
        tr = self.dm.binary_fusion_sweep(proposals, chunk=len(proposals))
        return dict(trace=tr, moves=len(tr), energy=tr[-1])

    def end_to_end(self, jobs, elapsed: float) -> dict:
        return {"moves_per_s": sum(j["moves"] for j in jobs) / elapsed}

    def view(self) -> dict:
        return {}


def judge(ref, program: dict, jobs: list, order) -> list[dict]:
    fields = torch.stack([ref.field(k) for k in order])
    _, ref_trace = fusion.fusion_sweep(ref.unary, ref.edge_weights(),
                                       ref.tol, ref.start, fields,
                                       ref.normalize)
    rows = []
    for job in jobs:
        tr = job["trace"]
        if len(tr) != len(ref_trace):
            raise ValueError(f"{len(tr)} energies for {len(ref_trace)} "
                             "moves")
        gap = [abs(a - b) / b for a, b in zip(tr, ref_trace)]
        rows.append({"fusion_trace": max(gap[:TRACE_MOVES]),
                     "fusion_median": float(np.median(gap))})
    return rows
