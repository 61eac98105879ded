"""tools/measure_race_torch.py and tools/measure_wavefront_torch.py against
the JAX package's tools/measure_race.py, on the CPU in float64.

build_problem on tests/test_model_global.py's 30 x 44 pair with the JAX
model's state carried across (unary, D0, Q and alphas within 1e-10);
run_host (raster, bipartite) and run_device (checkerboard, scanline) on
testing.trws_problem inputs (equal sweeps and iterations, energies and
bounds within 1e-10); the hierarchy race's warm start against the JAX
package's coarsen / trws.solve / upsample_messages (within 1e-10); the
serial TRW-S in the banded order against BandedRun over 50 iterations of a
2 x 3-block problem (bound and energy within 1e-9 at every chunk); each
tool's main end to end on a tiny cached problem, and its default device
refused without a card."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

from stereo_tpu.config import CVPR08Options as JOptions  # noqa: E402
from stereo_tpu.models import global_stereo as j_global  # noqa: E402
from stereo_tpu.solvers import hierarchy as j_h  # noqa: E402
from stereo_tpu.solvers import trws as j_trws  # noqa: E402
from stereo_tpu_torch import convert, testing  # noqa: E402
from stereo_tpu_torch.config import CVPR08Options as TOptions  # noqa: E402
from stereo_tpu_torch.solvers import banded  # noqa: E402
from test_model_global import make_pair  # noqa: E402
from tools import measure_race as j_race  # noqa: E402
from tools import measure_race_torch as race  # noqa: E402
from tools import measure_wavefront_torch as wf_race  # noqa: E402

torch.set_num_threads(1)

RTOL = 1e-10
T = lambda arrs: [torch.as_tensor(a) for a in arrs]
J = lambda arrs: [jnp.asarray(a) for a in arrs]
JAX_KEYS = {"K", "H", "W", "host", "host_curve", "target_e", "checkerboard",
            "scanline", "hierarchy"}
NEW_KEYS = {"banded", "wavefront", "card", "launches", "reach"}


def _planes(H, W, n=4, seed=5):
    """Fronto-parallel and slanted planes across the pair's disparities."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        d = 6.0 * i / (n - 1)
        a, b = rng.normal(0, 0.02, 2) if i % 2 else (0.0, 0.0)
        p = np.zeros((4, H, W))
        p[0], p[1], p[2] = a, b, 1.0
        p[3] = -(d - a * W / 2 - b * H / 2)
        out.append(p)
    return out


def _two_segments(im, *_):
    """A stand-in for the JAX package's mean-shift segmentation (held
    against the port's in test_torch_segmentation.py): left and right
    halves, the weights' segments carried across as the state they are."""
    H, W = im.shape[:2]
    return np.repeat((np.arange(W) >= W // 2)[None], H, 0).astype(np.int32)


def test_build_problem_matches_jax(monkeypatch):
    images, P = make_pair()
    kw = dict(maxiter=16, check_every=4)
    monkeypatch.setattr(j_global.segmentation, "mean_shift", _two_segments)
    jm = j_global.DispMapGlobalStereo(images, P, (0, 6), 1, JOptions(),
                                      seed=3, **kw)
    assert len(np.unique(jm.segments)) == 2
    tm = convert.dispmap_global_from_numpy(
        images, P, (0, 6), 1, TOptions(), device="cpu",
        start_disparity=np.asarray(jm.start_disparity),
        segments=jm.segments, **kw)
    props = _planes(*tm.sz)
    got = race.build_problem(tm, props)
    # one program, not an op-by-op compile of the JAX tool's function
    want = jax.jit(lambda ps: j_race.build_problem(jm, ps))(props)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=RTOL)
    assert got[0].shape[0] == len(props) + 1


@pytest.fixture(scope="module")
def problem():
    """Random inputs for two coarsenings: 12 x 16 -> 6 x 8 -> 3 x 4."""
    return testing.trws_problem(7, 3, 12, 16)


@pytest.fixture(scope="module")
def coarse_problem():
    """Random inputs at the pyramid's middle shape."""
    return testing.trws_problem(8, 3, 6, 8)


@pytest.mark.parametrize("order", ["raster", "bipartite"])
def test_run_host_matches_jax(problem, order):
    got = race.run_host(1, 1.0, *T(problem), 40, 1e-5, order=order)
    want = j_race.run_host(1, 1.0, *problem, 40, 1e-5, order=order)
    assert got["iters"] == want["iters"]
    for k in ("energy", "lb"):
        assert got[k] == pytest.approx(want[k], rel=RTOL)
    for k in ("trace_e", "trace_lb"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL)


@pytest.mark.parametrize("schedule", ["checkerboard", "scanline",
                                      "wavefront", "banded"])
def test_run_device_chains_chunks(coarse_problem, schedule):
    """Chunks warm-started from the last one's messages are one solve (the
    banded schedule's state stays packed across its chunks); a target the
    first chunk reaches stops the race there."""
    kw = dict(band=4, decode_every=3) if schedule == "banded" else {}
    args = (1, 1.0, *T(coarse_problem), schedule, 3)
    got, gm = race.run_device(*args, 6, None, **kw)
    once, om = race.run_device(*args[:-1], 6, 6, None, **kw)
    assert [p["sweeps"] for p in got] == [3, 6]
    assert got[-1]["lb"] == once[-1]["lb"]
    assert torch.equal(gm, om)
    stopped, _ = race.run_device(*args, 30, got[0]["e"], **kw)
    assert len(stopped) == 1 and stopped[0]["e"] == got[0]["e"]


def test_hierarchy_warm_start_matches_jax(problem):
    """The hierarchy race's warm start against the JAX package's coarsen
    (twice), trws.solve and upsample_messages."""
    got = race.hierarchy_warm_start(1, 1.0, *T(problem), coarse_sweeps=4,
                                    check_every=2)
    pyr = [tuple(J(problem))]
    coarsen = jax.jit(j_h.coarsen)  # one program, not an op-by-op compile
    for _ in range(2):
        pyr.append(coarsen(*pyr[-1]))
    messages = None
    for lvl in (2, 1):
        res = j_trws.solve(*pyr[lvl], kernel=1, tol=1.0, maxiter=4,
                           max_relgap=1e-6, check_every=2, messages=messages)
        messages = j_h.upsample_messages(res.messages,
                                         pyr[lvl - 1][0].shape[-2:])
    assert tuple(got.shape) == (4, 3, 12, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(messages), rtol=0,
                               atol=RTOL)


@pytest.mark.parametrize("schedule", ["checkerboard", "scanline"])
def test_run_device_matches_jax(coarse_problem, schedule):
    """One chunk from a warm start (every JAX chunk compiles anew: the
    solvers' loops close over the problem; the chaining of chunks is held
    below).  At the warm start's middle shape, whose set-up the test above
    has traced."""
    msgs = np.random.default_rng(5).uniform(0, 1, (4, 3, 6, 8))
    got, gm = race.run_device(1, 1.0, *T(coarse_problem), schedule, 3, 3,
                              None, torch.as_tensor(msgs), 0.5)
    want, wm = j_race.run_device(1, 1.0, *J(coarse_problem), schedule, 3, 3,
                                 -np.inf, jnp.asarray(msgs), 0.5)
    assert [p["sweeps"] for p in got] == [p["sweeps"] for p in want] == [3]
    assert got[0]["t"] > 0.5
    assert got[0]["e"] == pytest.approx(want[0]["e"], rel=RTOL)
    assert got[0]["lb"] == pytest.approx(want[0]["lb"], rel=RTOL)
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), rtol=0, atol=RTOL)


def test_host_banded_order_tracks_banded_run_over_50_iterations():
    """The serial TRW-S in banded_order and the banded solver are one
    algorithm: their bounds and decoded energies agree at every chunk of a
    long run on a problem of 2 x 3 blocks, not only in the first sweeps."""
    K, H, W, B, chunk, iters = 3, 8, 12, 4, 5, 50
    prob = testing.trws_problem(11, K, H, W)
    host = race.run_host(1, 1.0, *T(prob), iters, -np.inf, order="banded",
                         band=B)
    assert host["iters"] == iters
    run = banded.BandedRun(*T(prob), kernel=1, tol=1.0, Bh=B, Bw=B)
    assert (run.spec.Gy, run.spec.Gx) == (2, 3)
    state = run.init_state()
    for done in range(chunk, iters + 1, chunk):
        state, e, lb, _ = run.run(state, chunk)
        assert float(lb) == pytest.approx(host["trace_lb"][done - 1],
                                          rel=1e-9, abs=1e-9), done
        assert float(e) == pytest.approx(host["trace_e"][done - 1],
                                         rel=1e-9, abs=1e-9), done


def _cache(tmp_path, H=16, W=20):
    path = str(tmp_path / "problem.npz")
    unary, D0, Q, alphas = testing.trws_problem(3, 3, H, W)
    np.savez(path, unary=unary, D0=D0, Q=Q, alphas=alphas, kernel=1,
             tol=1.0)
    return path


RACE_ARGS = ["--max-sweeps", "cb=6", "scan=2", "wf=4", "banded=4", "hier=4",
             "--band", "8", "4", "--host-maxiter", "10", "--host-order",
             "raster,banded"]
CAPS = dict(checkerboard=6, scanline=2, wavefront=4, hierarchy=4)


def _short_warm_start(monkeypatch):
    """The hierarchy race's 600 coarse sweeps cut to 4 (its parity with
    the JAX package is held above)."""
    warm = race.hierarchy_warm_start
    monkeypatch.setattr(race, "hierarchy_warm_start",
                        lambda *a, **kw: warm(*a, coarse_sweeps=4,
                                              check_every=2))


def test_race_main_end_to_end(tmp_path, monkeypatch):
    _short_warm_start(monkeypatch)
    cache = _cache(tmp_path, 8, 12)
    out = str(tmp_path / "race.json")
    rep = race.main(["--device", "cpu", "--cache", cache, "--out", out,
                     *RACE_ARGS])
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(rep))
    assert JAX_KEYS | NEW_KEYS <= set(rep)
    assert (rep["K"], rep["H"], rep["W"], rep["card"]) == (3, 8, 12, None)
    assert {"t_within_0.1pct", "t_within_0.01pct"} <= set(rep["host"])
    assert rep["target_e"] == rep["host"]["energy"] == rep["host_orders"][
        "raster"]["energy"]
    assert set(rep["host_orders"]) == {"raster", "banded"}
    assert set(rep["banded"]) == {"8", "4"}
    curves = {**{k: rep[k] for k in CAPS},
              **{f"banded_{b}": rep["banded"][b] for b in ("8", "4")}}
    for name, curve in curves.items():
        cap = CAPS.get(name, 4)
        last = curve[-1]
        assert last["sweeps"] <= cap
        assert last["sweeps"] == cap or last["e"] <= rep["target_e"], name
        assert all(p["lb"] <= p["e"] + 1e-9 for p in curve), name
        assert name in rep["reach"]
    assert set(rep["launches"]) == {"checkerboard", "scanline", "wavefront",
                                    "banded_8", "banded_4", "hierarchy",
                                    "hierarchy_warm_start"}
    # on the CPU the wrappers run their plain versions: nothing launched
    assert not any(any(c.values()) for c in rep["launches"].values())



def test_race_merges_runs_made_apart(tmp_path):
    """The host in one run, a device schedule racing to its cap in another
    (no target there), merged: the host's energy becomes the target and
    every curve is measured against it."""
    cache = _cache(tmp_path)
    host_out, dev_out = str(tmp_path / "h.json"), str(tmp_path / "d.json")
    host = race.main(["--device", "cpu", "--cache", cache, "--out",
                      host_out, "--skip", "cb,scan,wf,banded,hier",
                      *RACE_ARGS])
    dev = race.main(["--device", "cpu", "--cache", cache, "--out", dev_out,
                     "--skip", "host,scan,wf,banded,hier", *RACE_ARGS])
    assert dev["target_e"] is None and dev["checkerboard"][-1]["sweeps"] == 6
    merged = race.main(["--merge", host_out, dev_out, "--out",
                        str(tmp_path / "m.json")])
    assert merged["target_e"] == host["target_e"] == host["host"]["energy"]
    assert merged["checkerboard"] == dev["checkerboard"]
    assert set(merged["reach"]) == {"checkerboard", "host_raster",
                                    "host_banded"}
    assert merged["reach"]["host_raster"]["target"]["sweeps"] <= host[
        "host"]["iters"]
    # a report of another problem is refused
    other = str(tmp_path / "other.npz")
    unary, D0, Q, alphas = testing.trws_problem(4, 3, 16, 20)
    np.savez(other, unary=unary, D0=D0, Q=Q, alphas=alphas, kernel=1,
             tol=1.0)
    race.main(["--device", "cpu", "--cache", other, "--out", dev_out,
               "--skip", "host,scan,wf,banded,hier", *RACE_ARGS])
    with pytest.raises(SystemExit, match="another problem"):
        race.main(["--merge", host_out, dev_out, "--out",
                   str(tmp_path / "m.json")])


def test_wavefront_main_end_to_end(tmp_path):
    """The wavefront tool: its target from a race report, a one-level warm
    start whose seconds count."""
    cache = _cache(tmp_path)
    report, out = str(tmp_path / "race.json"), str(tmp_path / "wf.json")
    with open(report, "w") as f:
        json.dump({"target_e": -1.0}, f)
    wrep = wf_race.main(["--device", "cpu", "--cache", cache, "--report",
                         report, "--chunk", "2", "--max-sweeps", "4",
                         "--levels", "2", "--coarse-sweeps", "2", "--out",
                         out])
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(wrep))
    assert {"K", "H", "W", "target_e", "wavefront", "card", "launches",
            "reach"} <= set(wrep)
    assert wrep["target_e"] == -1.0 and wrep["card"] is None
    assert [p["sweeps"] for p in wrep["wavefront"]] == [2, 4]
    assert 0 < wrep["warm_seconds"] <= wrep["wavefront"][0]["t"]
    assert all(p["lb"] <= p["e"] + 1e-9 for p in wrep["wavefront"])


def test_tools_refuse_default_device_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cache = _cache(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        race.main(["--cache", cache, "--out", str(tmp_path / "r.json")])
    with pytest.raises(RuntimeError, match="cuda"):
        wf_race.main(["--cache", cache, "--out", str(tmp_path / "w.json")])
