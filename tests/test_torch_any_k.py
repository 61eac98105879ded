"""Every K the JAX package runs, on the port's plain paths; and the rule by
which the fused banded sweep's phase-B jobs wait for phase A.

CPU, float64, the same numpy inputs for both packages.

- The plain banded and wavefront sweeps at K = 97 and 130 (beyond one pass
  of a CUDA block's 96 targets, where the kernels once refused) against
  stereo_tpu's scan paths: messages atol 1e-10, bound rtol 1e-10, labels
  equal.
- DispMapNCC simultaneous fusion on the banded schedule at K = 97 against
  the JAX model on the same proposals: labels equal, energy rtol 1e-9.
- ``ops/banded_kernel.py::wait_lanes`` (the rule csrc/banded_kernel.cu's
  sends_width waits by) checked by brute force against the plain version's
  own index maps: every gD lane a written send reads, and every lane of
  phase A that reads a message a send overwrites, lies in the job's wait
  set, for every step, pass, segment and tile of six BandedSpecs, at every
  job width (32, 16 and 8 lanes)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_tpu.models.ncc import DispMapNCC as JDispMapNCC
from stereo_tpu.solvers import banded as j_banded
from stereo_tpu.solvers import wavefront as j_wf
from stereo_tpu_torch import testing
from stereo_tpu_torch.models.ncc import DispMapNCC as TDispMapNCC
from stereo_tpu_torch.ops import banded_kernel as t_bk
from stereo_tpu_torch.solvers import banded as t_banded
from stereo_tpu_torch.solvers import wavefront as t_wf

torch.set_num_threads(1)

T = lambda arrs: [torch.as_tensor(a) for a in arrs]
J = lambda arrs: [jnp.asarray(a) for a in arrs]


# ------------------------------------------------------ sweeps at wide K
@pytest.mark.parametrize("schedule,K,H,W", [
    ("banded", 97, 8, 10), ("banded", 130, 7, 9),
    ("wavefront", 97, 7, 9), ("wavefront", 130, 8, 10)])
def test_plain_sweep_at_wide_k_matches_jax(schedule, K, H, W):
    """One sweep from zero messages (3 x 4 blocks on the banded schedule)."""
    prob = testing.trws_problem(K + H, K, H, W)
    kw = dict(kernel=1, tol=1.3, max_relgap=0.0, maxiter=1, check_every=1)
    if schedule == "banded":
        kw.update(Bh=3, Bw=4)
        want = j_banded.solve_banded(*J(prob), **kw, use_pallas=False)
        got = t_banded.solve_banded(*T(prob), **kw)
    else:
        want = j_wf.solve_wavefront(*J(prob), **kw, use_pallas=False)
        got = t_wf.solve_wavefront(*T(prob), **kw)
    np.testing.assert_allclose(got.messages.numpy(),
                               np.asarray(want.messages), rtol=0, atol=1e-10)
    np.testing.assert_allclose(float(got.lower_bound),
                               float(want.lower_bound), rtol=1e-10)
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))


# ----------------------------------------------- the model at K = 97
def test_banded_fusion_at_k97_matches_jax():
    """96 proposals + the current assignment: K = 97 labels, 24 x 32 image,
    8 x 8 blocks (3 x 4 of them), 4 sweeps, one decode."""
    H, W = 24, 32
    kw = dict(kernel=1, unary_weight=40.0, tol=8.0, maxiter=4, check_every=4)
    im0, im1 = testing.textured_pair(2, H, W, shift=3)
    disparities = np.arange(0, 7)
    jm = JDispMapNCC([im0, im1], disparities, **kw)
    tm = TDispMapNCC([im0, im1], disparities, **kw, schedule="banded",
                     device="cpu")
    jm.schedule, jm.band, tm.band = "banded", 8, 8
    rng = np.random.default_rng(97)
    planes = np.zeros((96, 4, H, W))
    planes[:, 0] = rng.uniform(-0.05, 0.05, (96, 1, 1))
    planes[:, 1] = rng.uniform(-0.05, 0.05, (96, 1, 1))
    planes[:, 2] = 1.0
    planes[:, 3] = -rng.uniform(0.0, 6.0, (96, 1, 1))
    jm.restart()
    tm.restart()
    tm.assignment = np.asarray(jm.assignment)
    jE, jlb, jit = jm.simultaneous_fusion([jnp.asarray(p) for p in planes])
    tE, tlb, tit = tm.simultaneous_fusion([torch.as_tensor(p)
                                           for p in planes])
    assert tit == jit == 4
    np.testing.assert_allclose(tE, jE, rtol=1e-9)
    np.testing.assert_allclose(tlb, jlb, rtol=1e-9)
    assert tlb <= tE
    np.testing.assert_array_equal(tm.assignment.numpy(),
                                  np.asarray(jm.assignment))


# -------------------------------------- the wait rule of the fused sweep
# ragged rows and columns, Bh != Bw both ways, more than one tile of lanes
# (in a group of lanes too: nb = 105),
# blocks of two rows or columns
SPECS = [(8, 10, 4, 5), (9, 70, 3, 2), (40, 47, 8, 16), (48, 40, 8, 8),
         (70, 12, 16, 5), (20, 9, 2, 3)]


def _job_targets(spec, t, backward, seg, tile, J):
    """Target lanes of job (seg, tile), J lanes wide, in its segment's lane
    space (the enumeration of csrc/banded_kernel.cu::sends_width): column
    lanes for the interior and x-seam sends, lane2 for the y-seam sends."""
    nb, i = spec.nb, tile * J + np.arange(J)
    if seg < 2:
        lo, hi = t_bk.live_lanes(spec, t)
    elif seg < 4:
        lo, hi = t_bk.live_lanes(spec, t - 1 if backward else t + 1)
    else:
        g = (t - ((spec.Bw if seg < 6 else spec.Bh) - 1) if backward else t)
        lo, hi = g * nb, g * nb + nb
    lanes = lo + i
    return lanes[lanes < hi]


def _zero_state(bp):
    shapes = t_bk.problem_shapes(bp.spec, bp.K)
    z = lambda n: torch.zeros(shapes[n], dtype=torch.float64)
    return z("MA"), z("MB"), [z("SxL"), z("SxR"), z("SyU"), z("SyD")]


def _capture_step(bp, t, backward, monkeypatch):
    """Run one plain step on a zero state with the sends replaced by a
    recorder: gD = lane + 1 at label 0, so each send's source holds at every
    lane the gD lane it reads (+1, 0 = none); every send writes 1, so the
    changed entries are what the step writes.  -> (new state, sources)."""
    spec = bp.spec
    sources = []

    def fake(problems, *args, **kw):
        out = []
        for src, old, *_ in problems:
            sources.append(src)
            shape = torch.broadcast_shapes(src.shape, old.shape)
            out.append((torch.ones(shape, dtype=old.dtype),
                        torch.zeros(shape[:-2] + shape[-1:],
                                    dtype=old.dtype)))
        return out

    monkeypatch.setattr(t_banded, "_sends", fake)
    c = t + 1
    bp.theta.zero_()
    bp.theta[c, 0] = torch.arange(1, spec.L + 1, dtype=bp.theta.dtype)
    bp.gamma.fill_(1.0)
    MA, MB, S = _zero_state(bp)
    if backward:
        new, _ = t_banded._bwd_col(bp, (MA, MB, tuple(S)), t)
    else:
        new = t_banded._fwd_col(bp, (MA, MB, tuple(S)), t)
    monkeypatch.undo()
    # the sends in the order both steps call them: interior heads (d = 0,
    # 1), interior tails (d = 0, 1), x-seam head, y-seam head, x-seam tail,
    # y-seam tail -> segments 0..7, each indexed by its target lanes (the
    # y-seam head reads the column lane of group 0 or Bh - 1 of lane2's b)
    h_int, t_int, h_x, h_y, t_x, t_y = sources
    nb = spec.nb
    yg = t - (spec.Bh - 1) if backward else t
    ybase = (spec.Bh - 1) * nb if backward else 0
    l2 = torch.arange(spec.Lp)
    col = (ybase + l2 - yg * nb).clamp(0, spec.L - 1)
    src = {0: h_int[0, 0], 1: h_int[-1, 0], 2: t_int[0, 0], 3: t_int[1, 0],
           4: h_x[0], 6: h_y[0][col], 5: t_x[0], 7: t_y[0]}
    return new, src


def _written(spec, t, backward, new):
    """Per segment: (name of the array written, lanes written)."""
    c = t + 1
    cn = c - 1 if backward else c + 1
    MA, MB, S = new
    heads, tails = (MB, MA) if backward else (MA, MB)
    sx = dict(zip(("SxL", "SxR", "SyU", "SyD"), S))
    x_h, y_h, x_t, y_t = (("SxR", "SyD", "SxL", "SyU") if backward
                          else ("SxL", "SyU", "SxR", "SyD"))
    lanes = lambda a: set(np.flatnonzero(a[0].numpy() != 0).tolist())
    return {0: ("heads", 0, lanes(heads[c, 0])),
            1: ("heads", 1, lanes(heads[c, 1])),
            2: ("tails", 0, lanes(tails[cn, 0])),
            3: ("tails", 1, lanes(tails[cn, 1])),
            4: (x_h, None, lanes(sx[x_h])), 5: (x_t, None, lanes(sx[x_t])),
            6: (y_h, None, lanes(sx[y_h])), 7: (y_t, None, lanes(sx[y_t]))}


def _readers(pbp, t, backward, what, d):
    """Lanes of step t's phase A (the plain _beliefs, live lanes only) that
    read each lane of the written array: the array holds a one-hot at
    (label k, lane k), so belief (k, l) is non-zero iff lane l reads lane
    k.  -> {lane k: set of reading lanes}."""
    spec, K = pbp.spec, pbp.K
    c = t + 1
    cn = c - 1 if backward else c + 1
    MA, MB, S = _zero_state(pbp)
    eye = torch.eye(K, dtype=torch.float64)
    if what == "heads":
        (MB if backward else MA)[c, d] = eye[:, :spec.L]
    elif what == "tails":
        (MA if backward else MB)[cn, d] = eye[:, :spec.L]
    else:
        i = ("SxL", "SxR", "SyU", "SyD").index(what)
        S[i] = eye[:, :S[i].shape[-1]].contiguous()
    D, _, _ = t_banded._beliefs(pbp, MA, MB, c, t, S,
                                t_banded._seam_views(pbp, S, t))
    lo, hi = t_bk.live_lanes(spec, t)
    hit = D[:, lo:hi].numpy() != 0
    return {k: set((lo + np.flatnonzero(hit[k])).tolist())
            for k in range(K) if hit[k].any()}


@pytest.mark.parametrize("J", [32, 16, 8])
@pytest.mark.parametrize("H,W,Bh,Bw", SPECS)
def test_wait_rule_covers_every_dependency(H, W, Bh, Bw, J, monkeypatch):
    spec = t_banded.BandedSpec(H, W, Bh, Bw)
    problem = lambda K: testing.trws_problem(0, K, H, W)
    # the stepped problem (2 labels) and the probe problem (one label per
    # lane of the widest array, theta = 0), both on the CPU in float64
    bp = t_banded._BandedProblem(*T(problem(2)), spec, 1, 1.0)
    pbp = t_banded._BandedProblem(*T(problem(spec.Lp)), spec, 1, 1.0)
    pbp.theta.zero_()
    checked = 0
    for backward in (False, True):
        for t in range(spec.T):
            new, src = _capture_step(bp, t, backward, monkeypatch)
            written = _written(spec, t, backward, new)
            lo, hi = t_bk.live_lanes(spec, t)
            readers = {}
            for seg, n in enumerate(t_bk.step_jobs(spec, t, backward, J)):
                what, d, lanes = written[seg]
                if (what, d) not in readers:
                    readers[what, d] = _readers(pbp, t, backward, what, d)
                for tile in range(n):
                    wlo, whi = t_bk.wait_lanes(spec, t, backward, seg, tile,
                                               J)
                    for x in _job_targets(spec, t, backward, seg, tile, J):
                        if x not in lanes:
                            continue  # not written: an inactive lane
                        ls = int(src[seg][x]) - 1
                        where = (spec.T, t, backward, seg, tile, x)
                        assert lo <= ls < hi, ("gD lane not live", where)
                        assert wlo <= ls < whi, ("gD lane not waited", where)
                        for r in readers[what, d].get(x, ()):
                            assert wlo <= r < whi, ("reader not waited",
                                                    where, r)
                        checked += 1
                    written[seg][2].difference_update(
                        _job_targets(spec, t, backward, seg, tile, J))
            # every written lane belongs to some job of its segment
            assert all(not w[2] for w in written.values()), written
    assert checked > 0
