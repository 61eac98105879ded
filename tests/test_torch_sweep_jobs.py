"""The job map of the fused sweeps' phase B (kernels 5 and 6), on the CPU.

A phase-B job is one send for J = 32, 16 or 8 neighbouring lanes, done by
the whole block (csrc/minplus.cuh::send_job); each step takes its width from
its jobs at each width and the resident grid (``minplus.job_width``).  The
kernels' enumerations are mirrored in ``ops/banded_kernel.py::step_jobs``,
``ops/wavefront_kernel.py::step_jobs``, ``minplus.job_at`` and
``minplus.job_threads``; these tests hold the mirrors to what the kernels
must do:

- every live lane of every segment of every step belongs to exactly one job,
  at the width the step chooses on a grid of 132 blocks (one an SM of an
  H100), for teddy's banded (128 x 128 blocks) and raster schedules;
- the threads of a job hold every (lane, target) pair exactly once, at
  every width, K in one pass and in several;
- the width rule: a thin step is cut narrower wherever that adds no
  round, a busy one takes the width whose rounds come out even.

The wait rule of each width is checked against the plain versions' index
maps in tests/test_torch_any_k.py and tests/test_torch_wavefront.py."""

import numpy as np
import pytest

from stereo_tpu_torch.ops import banded_kernel as t_bk
from stereo_tpu_torch.ops import minplus
from stereo_tpu_torch.ops import wavefront_kernel as t_wfk
from stereo_tpu_torch.solvers import banded as t_banded

GRID = 132
TEDDY = (375, 450)


def _banded_steps(K, H, W, band):
    """(jobs at each width, jobs of the chosen width, lane range of each
    segment) of every step of a banded sweep."""
    spec = t_banded.BandedSpec(H, W, band, band)
    nb = spec.nb
    for backward in (False, True):
        for t in range(spec.T):
            hlo, hhi = t_bk.live_lanes(spec, t)
            tlo, thi = t_bk.live_lanes(spec, t - 1 if backward else t + 1)
            xg = t - (spec.Bw - 1) if backward else t
            yg = t - (spec.Bh - 1) if backward else t
            ranges = [(hlo, hhi)] * 2 + [(tlo, thi)] * 2
            ranges += [(xg * nb, xg * nb + nb) if 0 <= xg < spec.Bh
                       else (0, 0)] * 2
            ranges += [(yg * nb, yg * nb + nb) if 0 <= yg < spec.Bw
                       else (0, 0)] * 2
            yield ([t_bk.step_jobs(spec, t, backward, J)
                    for J in minplus.JOB_WIDTHS], ranges)


def _wavefront_steps(K, H, W):
    for backward in (False, True):
        for t in range(H + W - 1):
            hlo, hhi = t_wfk.live_lanes(H, W, t)
            tlo, thi = t_wfk.live_lanes(H, W, t - 1 if backward else t + 1)
            yield ([t_wfk.step_jobs(H, W, t, backward, J)
                    for J in minplus.JOB_WIDTHS],
                   [(hlo, hhi)] * 2 + [(tlo, thi)] * 2)


@pytest.mark.parametrize("K", [15, 79, 97, 202])
@pytest.mark.parametrize("schedule", ["banded", "wavefront"])
def test_jobs_cover_every_live_lane_and_target_once(schedule, K):
    steps = (_banded_steps(K, *TEDDY, 128) if schedule == "banded"
             else _wavefront_steps(K, *TEDDY))
    widths = {}
    for by_width, ranges in steps:
        J = minplus.job_width([sum(n) for n in by_width], GRID, K)
        n_seg = by_width[minplus.JOB_WIDTHS.index(J)]
        widths[J] = widths.get(J, 0) + 1
        covered = [[] for _ in n_seg]
        for job in range(sum(n_seg)):
            seg, tile = minplus.job_at(n_seg, job)
            lo, hi = ranges[seg]
            lanes = lo + tile * J + np.arange(J)
            covered[seg].append(lanes[lanes < hi])
        for seg, (lo, hi) in enumerate(ranges):
            got = np.sort(np.concatenate(covered[seg] or [np.zeros(0, int)]))
            np.testing.assert_array_equal(got, np.arange(lo, hi))
    # and within each job, its threads hold each (lane, target) once
    for J in widths:
        held = np.zeros((J, K), dtype=int)
        for lane, targets in minplus.job_threads(K, J):
            held[lane, targets] += 1
        assert (held == 1).all(), (J, K)
    # at teddy's shape both schedules have thin steps, cut narrower
    assert set(widths) - {32}, widths


@pytest.mark.parametrize("K", [1, 8, 15, 17, 79, 96, 97, 202, 1000])
@pytest.mark.parametrize("J", [32, 16, 8])
def test_job_threads_hold_each_target_once(K, J):
    held = np.zeros((J, K), dtype=int)
    threads = minplus.job_threads(K, J)
    assert len(threads) == minplus.TILE * minplus.target_blocks(K)
    for lane, targets in threads:
        held[lane, targets] += 1
    assert (held == 1).all()


def test_job_width_rule():
    jw = minplus.job_width
    # a thin step is cut narrower wherever its 16-lane jobs fit one round;
    # where they would take two, one round of 32 lanes is sooner
    for K in (15, 79, 202):
        for n32 in range(0, GRID // 2 + 1):
            assert jw([n32, 2 * n32, 4 * n32], GRID, K) < 32
        assert jw([100, 200, 400], GRID, K) == 32
    # teddy's raster steps at K = 79 (48 jobs of 32): 96 jobs of 16 lanes
    # run in one round, 188 of 8 in two
    assert jw([48, 96, 188], GRID, 79) == 16
    # a step of a few lanes: jobs of 8
    assert jw([4, 4, 4], GRID, 79) == 8
    # a busy banded step at K = 79 (196 jobs of 32 on 132 blocks): three
    # even rounds of 16 lanes beat two uneven ones of 32 and six of 8
    assert jw([196, 392, 784], GRID, 79) == 16
    # at K = 15 the walk is short: the fewest rounds win
    assert jw([196, 392, 784], 2 * GRID, 15) == 32
    assert jw([300, 600, 1200], GRID, 15) == 32
    # a tie goes to the narrower width
    assert jw([0, 0, 0], GRID, 15) == 8
    with pytest.raises(ValueError, match="job width"):
        minplus.check_width("sweep_banded", 24)
    minplus.check_width("sweep_banded", 0)
