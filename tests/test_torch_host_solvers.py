"""The port's host solvers against the JAX package's, on the same seeded
numpy inputs: stereo_tpu_torch.solvers.qpbo_host (every function) and
solvers.trws_host, each through the port's own copy of the native sources
(stereo_tpu_torch/native/qpbo.cpp, trws.cpp); the port's serial TRW-S
against the port's device solvers in the same orderings; the native build;
and fusion_backend="host" on DispMapNCC and on DispMapGlobalStereo (with
``improve``) against the JAX models' host backend from a shared state.
On inputs with exact ties (positions and costs on a grid of quarters) the
port's serial TRW-S is held against brute force and its device solvers,
not the JAX package's: the JAX copy's lower envelope drops a cone at a
tie, and its bound then exceeds the optimum.

Tolerances: labels equal; energies and bounds of the QPBO and serial TRW-S
calls within 1e-12 (relative; the same C++ arithmetic on the same inputs);
the port's serial TRW-S against its device solvers within 1e-9 (different
summation orders, as tests/test_trws_host.py holds the JAX pair); the host
fusion backend: assignment equal, energy within 1e-10."""

import ctypes
import dataclasses
import itertools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles
from stereo_tpu import native as j_native
from stereo_tpu.config import CVPR08Options as JOptions
from stereo_tpu.models.global_stereo import DispMapGlobalStereo as JGlobal
from stereo_tpu.models.ncc import DispMapNCC as JDispMapNCC
from stereo_tpu.solvers import qpbo_host as j_qpbo
from stereo_tpu.solvers import trws_host as j_host
from stereo_tpu_torch import convert, native as t_native, testing
from stereo_tpu_torch.config import CVPR08Options as TOptions
from stereo_tpu_torch.models.ncc import DispMapNCC as TDispMapNCC
from stereo_tpu_torch.solvers import qpbo_host as t_qpbo
from stereo_tpu_torch.solvers import scanline as t_scan
from stereo_tpu_torch.solvers import trws as t_trws
from stereo_tpu_torch.solvers import trws_host as t_host
from stereo_tpu_torch.solvers import wavefront as t_wavefront
from test_model_global import make_pair

torch.set_num_threads(1)

RTOL = 1e-12


def random_instance(rng, n, m, submodular=False):
    """A random binary energy (tests/test_qpbo.py's recipe)."""
    U0 = rng.normal(0, 2, n)
    U1 = rng.normal(0, 2, n)
    tails = rng.integers(0, n, m)
    heads = (tails + 1 + rng.integers(0, n - 1, m)) % n
    E00, E01, E10, E11 = (rng.normal(0, 1, m) for _ in range(4))
    if submodular:
        fix = np.clip(E00 + E11 - E01 - E10, 0, None) / 2 + 0.01
        E01, E10 = E01 + fix, E10 + fix
    return U0, U1, tails, heads, E00, E01, E10, E11


def random_triples(rng, n, count):
    out = []
    for _ in range(count):
        i, j, k = rng.choice(n, size=3, replace=False)
        out.append((int(i), int(j), int(k), rng.normal(0, 1, (2, 2, 2))))
    return out


def _same(got, want):
    """Equal labels / ints, energies and bounds within RTOL."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(a, float):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-12)
        elif isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                if k != "seconds":
                    np.testing.assert_allclose(a[k], b[k], rtol=RTOL)
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------------------ QPBO
@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("submodular", [False, True])
def test_qpbo_solve_matches_jax(seed, submodular):
    rng = np.random.default_rng(100 + seed)
    inst = random_instance(rng, 30, 70, submodular)
    for kw in (dict(), dict(weak=False), dict(improve=True),
               dict(regions=True)):
        _same(t_qpbo.solve(*inst, **kw), j_qpbo.solve(*inst, **kw))
    lab = rng.integers(0, 2, 30)
    _same([t_qpbo.labeling_energy(lab, *inst)],
          [j_qpbo.labeling_energy(lab, *inst)])


def test_qpbo_solve_refuses_bad_endpoints():
    inst = list(random_instance(np.random.default_rng(0), 5, 6))
    inst[3] = np.array([0, 1, 2, 3, 4, 5])
    with pytest.raises(ValueError, match="range"):
        t_qpbo.solve(*inst)


@pytest.mark.parametrize("seed", range(5))
def test_qpbo_triples_match_jax(seed):
    rng = np.random.default_rng(200 + seed)
    inst = random_instance(rng, 12, 20)
    tr = random_triples(rng, 12, 5)
    _same(t_qpbo.solve_with_triples(*inst, tr, regions=True),
          j_qpbo.solve_with_triples(*inst, tr, regions=True))
    y = rng.integers(0, 2, 12)
    _same([t_qpbo.triples_energy(y, *inst, tr)],
          [j_qpbo.triples_energy(y, *inst, tr)])
    labels, *_ = j_qpbo.solve_with_triples(*inst, tr)
    _same(t_qpbo.improve_with_triples(labels, *inst, tr, seed=seed),
          j_qpbo.improve_with_triples(labels, *inst, tr, seed=seed))
    init = rng.integers(0, 2, 12)
    _same(t_qpbo.improve_with_triples(labels, *inst, tr, init=init),
          j_qpbo.improve_with_triples(labels, *inst, tr, init=init))


def _frustrated(rng, n, m, tries=400):
    """A random instance that QPBO leaves partly unlabelled."""
    for _ in range(tries):
        inst = random_instance(rng, n, m)
        out = j_qpbo.solve(*inst, regions=True)
        if out[3] > 0:
            return inst, out
    raise AssertionError("no frustrated instance found")


@pytest.mark.parametrize("seed", range(5))
def test_qpbo_choose_labels_and_improve_match_jax(seed):
    rng = np.random.default_rng(300 + seed)
    inst, (labels, _, _, _, regions) = _frustrated(rng, 10, 22)
    tr = random_triples(rng, 10, 2)
    for kw in (dict(mode=2), dict(mode=3), dict(mode=2, independent=True),
               dict(mode=2, triples=tr)):
        _same(t_qpbo.choose_labels(labels, regions, *inst, **kw),
              j_qpbo.choose_labels(labels, regions, *inst, **kw))
    _same(t_qpbo.improve(labels, *inst, seed=seed),
          j_qpbo.improve(labels, *inst, seed=seed))
    init = rng.integers(0, 2, 10)
    _same(t_qpbo.improve(labels, *inst, rounds=5, init=init),
          j_qpbo.improve(labels, *inst, rounds=5, init=init))


@pytest.mark.parametrize("seed", range(4))
def test_qpbo_probe_matches_jax(seed):
    rng = np.random.default_rng(400 + seed)
    inst, _ = _frustrated(rng, 9, 18)
    _same(t_qpbo.probe(*inst), j_qpbo.probe(*inst))
    _same(t_qpbo.probe(*inst, weak=False, max_rounds=1),
          j_qpbo.probe(*inst, weak=False, max_rounds=1))


def test_parity_union_find_and_reduction_match_jax():
    rng = np.random.default_rng(7)
    inst = random_instance(rng, 8, 14)
    ufs = (t_qpbo._ParityUF(8), j_qpbo._ParityUF(8))
    for j, i, rel in ((1, 0, 1), (2, 1, 0), (3, 2, 1), (2, 0, 1), (5, 4, 0)):
        assert ufs[0].union(j, i, rel) == ufs[1].union(j, i, rel)
    assert [ufs[0].find(i) for i in range(8)] == [ufs[1].find(i)
                                                  for i in range(8)]
    fixed = np.array([-1, -1, -1, -1, 1, -1, 0, -1])
    E = list(inst[4:])
    got = t_qpbo._reduce_problem(*inst[:4], E, ufs[0], fixed)
    want = j_qpbo._reduce_problem(*inst[:4], E, ufs[1], fixed)
    assert got[0] == want[0]
    for a, b in zip(got[1:6], want[1:6]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_allclose(got[6], want[6], rtol=RTOL)


# ----------------------------------------------------------- serial TRW-S
def _grid(seed, K, H, W, kernel):
    rng = np.random.default_rng(seed)
    return oracles.grid_trws_inputs(rng, H, W, K, kernel=kernel)


@pytest.mark.parametrize("kernel", [1, 2])
def test_grid_to_edges_matches_jax_from_tensors(kernel):
    theta, D0, Q, alphas = _grid(kernel, 4, 5, 6, kernel)
    want = j_host.grid_to_edges(*[jnp.asarray(a) for a in
                                  (theta, D0, Q, alphas)])
    got = t_host.grid_to_edges(*[torch.as_tensor(a)
                                 for a in (theta, D0, Q, alphas)])
    for a, b in zip(got, want):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(t_host.bipartite_order(5, 6),
                                  j_host.bipartite_order(5, 6))
    np.testing.assert_array_equal(t_host.raster_order(5, 6),
                                  j_host.raster_order(5, 6))


@pytest.mark.parametrize("kernel", [1, 2])
@pytest.mark.parametrize("order", ["bipartite", "raster"])
def test_trws_host_matches_jax(kernel, order):
    K, H, W = 5, 6, 7
    prob = _grid(10 + kernel, K, H, W, kernel)
    edges = t_host.grid_to_edges(*prob)
    ordr = getattr(t_host, f"{order}_order")(H, W)
    kw = dict(maxiter=6, max_relgap=0.0, trace=True)
    got = t_host.solve(kernel, *edges, 0.9, ordr, **kw)
    want = j_host.solve(kernel, *edges, 0.9, ordr, **kw)
    _same(got, want)
    assert got[2] <= got[1] + 1e-9
    assert len(got[4]["seconds"]) == got[3] == 6


def test_trws_host_refuses_bad_input():
    edges = t_host.grid_to_edges(*_grid(0, 3, 3, 4, 1))
    with pytest.raises(ValueError, match="permutation"):
        t_host.solve(1, *edges, 1.0, np.zeros(12, np.int32))
    with pytest.raises(ValueError):
        t_host.solve(1, *edges, 1.0, np.arange(11, dtype=np.int32))


@pytest.mark.parametrize("kernel", [1, 2])
def test_trws_host_bipartite_matches_port_checkerboard(kernel):
    """The serial solver in bipartite order is the checkerboard TRW-S."""
    K, H, W = 5, 6, 7
    prob = _grid(20 + kernel, K, H, W, kernel)
    dev = t_trws.solve(*[torch.as_tensor(a) for a in prob], kernel=kernel,
                       tol=0.9, maxiter=7, max_relgap=0.0)
    _, e, lb, _ = t_host.solve(kernel, *t_host.grid_to_edges(*prob), 0.9,
                               t_host.bipartite_order(H, W), maxiter=7,
                               max_relgap=0.0)
    assert e == pytest.approx(float(dev.energy), rel=1e-9)
    assert lb == pytest.approx(float(dev.lower_bound), rel=1e-9)


@pytest.mark.parametrize("kernel", [1, 2])
def test_trws_host_scanline_order_matches_port_scanline(kernel):
    """The serial solver in scanline order (y, parity(x), x) is the
    scanline TRW-S, sweep by sweep."""
    K, H, W = 4, 5, 6
    prob = _grid(30 + kernel, K, H, W, kernel)
    order = np.array(sorted(range(H * W), key=lambda i: (i // W, i % W % 2,
                                                         i % W)), np.int32)
    edges = t_host.grid_to_edges(*prob)
    msgs = None
    for it in range(1, 5):
        res = t_scan.solve_scanline(*[torch.as_tensor(a) for a in prob],
                                    kernel=kernel, tol=1.0, maxiter=1,
                                    max_relgap=0.0, messages=msgs)
        msgs = res.messages
        _, e, lb, _ = t_host.solve(kernel, *edges, 1.0, order, maxiter=it,
                                   max_relgap=0.0)
        assert lb == pytest.approx(float(res.lower_bound), rel=1e-9), it
        assert e == pytest.approx(float(res.energy), rel=1e-9), it


def _quarters(rng, shape, high):
    """Values on a grid of quarters: ties between cones come often."""
    return rng.integers(0, high, shape) / 4.0


def test_trws_host_exact_on_tied_edges():
    """One edge between two nodes is a tree: TRW-S ends at the optimum, its
    bound equal to its energy.  With exact ties between the source cones
    (a cone as low as its left neighbour's everywhere) the JAX package's
    lower envelope kept the higher cone; here both equal brute force, on
    every instance (e.g. positions 0 and 1 -> 0.25 and 1, costs 1.75 and
    0.5: the JAX copy's bound is 3.0 over the optimum 1.5)."""
    rng = np.random.default_rng(1)
    for _ in range(300):
        K = int(rng.integers(2, 6))
        qs, qd = _quarters(rng, K, 6), _quarters(rng, K, 6)
        u = _quarters(rng, (K, 2), 8)
        _, e, lb, _ = t_host.solve(
            1, u, np.array([0], np.int32), np.array([1], np.int32),
            qs[:, None], qd[:, None], np.array([1.0]), 10.0,
            np.array([0, 1], np.int32), maxiter=3, max_relgap=-1.0)
        opt = min(u[a, 0] + u[b, 1] + min(abs(qs[a] - qd[b]), 10.0)
                  for a, b in itertools.product(range(K), range(K)))
        assert e == pytest.approx(opt, abs=1e-12)
        assert lb == pytest.approx(opt, abs=1e-12), (qs, qd, u)


@pytest.mark.parametrize("seed", [0, 1])
def test_trws_host_raster_matches_wavefront_on_tied_grid(seed):
    """On a grid with ties everywhere, the serial solver in raster order is
    the port's raster wavefront sweep for sweep (the device solvers take
    the min over every source, so no envelope can drop one)."""
    K, H, W = 4, 6, 7
    rng = np.random.default_rng(seed)
    prob = (_quarters(rng, (K, H, W), 12), _quarters(rng, (K, H, W), 8),
            _quarters(rng, (4, K, H, W), 8),
            testing.border_weights(H, W) * rng.integers(1, 4, (4, H, W)) / 2)
    edges = t_host.grid_to_edges(*prob)
    msgs = None
    for it in range(1, 21):
        res = t_wavefront.solve_wavefront(
            *[torch.as_tensor(a) for a in prob], kernel=1, tol=1.0,
            maxiter=1, max_relgap=0.0, messages=msgs)
        msgs = res.messages
        if it % 5:
            continue
        _, e, lb, _ = t_host.solve(1, *edges, 1.0, t_host.raster_order(H, W),
                                   maxiter=it, max_relgap=-1.0)
        assert lb == pytest.approx(float(res.lower_bound), rel=1e-9), it
        assert e == pytest.approx(float(res.energy), rel=1e-9), it
        assert lb <= e + 1e-9


# --------------------------------------------------------- native build
@pytest.mark.parametrize("name", ["qpbo", "trws"])
def test_native_libraries_under_build_dir(name):
    path = t_native.library_path(name)
    assert path.startswith(t_native.BUILD_DIR)
    assert os.path.basename(path).startswith(f"lib{name}-")
    assert path != t_native.library_path("segment")
    L = t_native.lib(name)
    assert os.path.exists(path) and L is t_native.lib(name)
    fn = L.qpbo_solve if name == "qpbo" else L.trws_serial
    assert fn.restype is ctypes.c_int and len(fn.argtypes) in (16, 20)
    # the port's copy, not the JAX package's library
    assert L._name != j_native.lib()._name


def test_native_unknown_library_and_missing_compiler(monkeypatch, tmp_path):
    with pytest.raises(ValueError, match="unknown"):
        t_native.library_path("maxflow")
    monkeypatch.setattr(t_native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(t_native.shutil, "which", lambda name: None)
    for name in ("qpbo", "trws"):
        with pytest.raises(RuntimeError, match="compiler"):
            t_native.build(name)
    assert not any(tmp_path.iterdir())


# ------------------------------------------------------ host fusion backend
H, W = 20, 30


def _fronto(d, shape=(H, W)):
    """A fronto-parallel plane field at disparity ``d`` (a number or a
    per-pixel map)."""
    z = np.zeros(shape)
    return np.stack([z, z, z + 1.0, z - d])


def _same_state(jm, tm, rtol=1e-10):
    np.testing.assert_array_equal(tm.assignment.numpy(),
                                  np.asarray(jm.assignment))
    np.testing.assert_allclose(tm.energy(), jm.energy(), rtol=rtol)


@pytest.fixture
def improve_calls(monkeypatch):
    """Counts the host backend's QPBO-I calls (the port's qpbo_host.improve,
    which the model reaches through the module)."""
    calls = []
    real = t_qpbo.improve

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(t_qpbo, "improve", counted)
    return calls


def _moves_match(jm, tm, props):
    """One host move per proposal in both models: energy and bound within
    1e-10, the energy never rises, the same assignment."""
    e_prev = tm.energy()
    for p in props:
        je, jlb = jm.binary_fusion(jnp.asarray(p))
        te, tlb = tm.binary_fusion(torch.as_tensor(p))
        np.testing.assert_allclose([te, tlb], [je, jlb], rtol=1e-10)
        assert te <= e_prev + 1e-9 and tlb <= te + 1e-9
        e_prev = te
        _same_state(jm, tm)


def _converged_match(jm, tm, props, seed):
    """binary_fuse_until_convergence from one seed: the same assignment and
    energy.  The move counts are not compared: the JAX model's stored
    energy of an unchanged assignment can move in its last bit from one
    host move to the next (XLA's float64 sums on the CPU; e.g.
    2106.345458421832 and 2106.3454584218316 for one assignment), which
    clears its visited set and adds moves that change nothing."""
    jm.binary_fuse_until_convergence(props, seed=seed)
    tn = tm.binary_fuse_until_convergence(
        [torch.as_tensor(p) for p in props], seed=seed)
    assert tn > len(props)
    _same_state(jm, tm)


@pytest.mark.parametrize("improve,unary_weight,tol", [(False, 40.0, 8.0),
                                                      (True, 40.0, 8.0),
                                                      (True, 0.5, 3.0)])
def test_ncc_host_backend_matches_jax(improve, unary_weight, tol,
                                      improve_calls):
    """DispMapNCC with fusion_backend="host".  With a weak unary (0.5), a
    random start and random per-pixel proposals leave QPBO nodes
    unlabelled, so QPBO-I runs."""
    im0, im1 = testing.textured_pair(4, H, W, shift=3)
    kw = dict(kernel=1, unary_weight=unary_weight, tol=tol, maxiter=40,
              fusion_backend="host", improve=improve)
    jm = JDispMapNCC([im0, im1], np.arange(0, 7), **kw)
    tm = TDispMapNCC([im0, im1], np.arange(0, 7), **kw, device="cpu")
    assert tm.fusion_backend == "host"
    rng = np.random.default_rng(0)
    random_start = _fronto(rng.uniform(0, 6, (H, W)))
    props = [_fronto(rng.uniform(0, 6, (H, W))) for _ in range(3)]
    props += [_fronto(d) for d in (0, 3, 6)]
    props += [np.asarray(jm.generate_new_plane_RANSAC(x, y, 5.0))
              for x, y in ((8, 8), (22, 12))]
    jm.restart()
    start = np.array(jm.assignment)
    if unary_weight < 1:  # a random start, as frustrated as the proposals
        start = random_start
        jm.assignment = jnp.asarray(start)
    tm.assignment = start
    _moves_match(jm, tm, props)
    if unary_weight < 1:
        assert improve_calls, "no move left a node unlabelled"
    jm.assignment = jnp.asarray(start)
    tm.assignment = start
    _converged_match(jm, tm, props, seed=2)


def test_global_host_backend_with_improve_matches_jax(improve_calls):
    """DispMapGlobalStereo (CVPR08 options, ``improve`` on; the truncation
    widened to 0.3 so that random per-pixel proposals leave QPBO nodes
    unlabelled and QPBO-I runs) on tests/test_model_global.py's pair, the
    JAX model's start field and segmentation carried across."""
    images, P = make_pair()
    jm = JGlobal(images, P, (0, 6), 1, dataclasses.replace(
        JOptions(), disp_thresh=0.3), seed=3, maxiter=30,
                 fusion_backend="host")
    tm = convert.dispmap_global_from_numpy(
        images, P, (0, 6), 1, dataclasses.replace(TOptions(),
                                                  disp_thresh=0.3),
        device="cpu", maxiter=30,
        start_disparity=np.asarray(jm.start_disparity),
        segments=jm.segments, fusion_backend="host")
    assert tm.improve and jm.improve and tm.fusion_backend == "host"
    shape = tm.sz
    rng = np.random.default_rng(0)
    props = [_fronto(rng.uniform(0, 6, shape), shape) for _ in range(4)]
    for i in range(4):
        a, b = rng.normal(0, 0.05, 2)
        p = _fronto(6.0 * i / 3 - a * shape[1] / 2 - b * shape[0] / 2,
                    shape)
        p[0], p[1] = a, b
        props.append(p)
    _same_state(jm, tm)
    _moves_match(jm, tm, props)
    assert improve_calls, "no move left a node unlabelled"
    jm.restart()
    tm.restart()
    _converged_match(jm, tm, props, seed=1)
