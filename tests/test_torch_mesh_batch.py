"""stereo_tpu_torch.parallel.mesh / .batch (column shards of one process's
devices) vs the port's one-device solve and vs the JAX package.  CPU,
float64, the mesh a list of CPU devices.

Tolerances: against the port's trws.solve, labels and messages equal (the
shards run the same per-pixel arithmetic) and energy / bound rel 1e-12 (sums
of per-shard partials reassociate); against the JAX package's trws.solve,
labels equal and scalars rel 1e-10.  The iteration count is fixed with
max_relgap=0.0 where a reassociated scalar meets the stopping rule."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles
from stereo_tpu.solvers import trws as j_trws
from stereo_tpu_torch.parallel import batch as batch_mod
from stereo_tpu_torch.parallel import mesh as mesh_mod
from stereo_tpu_torch.solvers import trws as t_trws

torch.set_num_threads(1)

T = lambda arrs: [torch.as_tensor(a) for a in arrs]  # noqa: E731
J = lambda arrs: [jnp.asarray(a) for a in arrs]  # noqa: E731


def cpu_mesh(batch, x):
    return mesh_mod.make_mesh(batch * x, batch=batch,
                              devices=["cpu"] * (batch * x))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return oracles.grid_trws_inputs(rng, 16, 24, 5)


def _same_as_port(res, ref):
    assert torch.equal(res.labels, ref.labels)
    assert torch.equal(res.messages, ref.messages)
    assert float(res.energy) == pytest.approx(float(ref.energy), rel=1e-12)
    assert float(res.lower_bound) == pytest.approx(float(ref.lower_bound),
                                                   rel=1e-12)
    assert int(res.iterations) == int(ref.iterations)


def _same_as_jax(res, want):
    np.testing.assert_array_equal(res.labels.numpy(), np.asarray(want.labels))
    assert float(res.energy) == pytest.approx(float(want.energy), rel=1e-10)
    assert float(res.lower_bound) == pytest.approx(float(want.lower_bound),
                                                   rel=1e-10)


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("batch,x", [(1, 8), (2, 4)])
def test_sharded_equals_single_device(inputs, batch, x, compact):
    kw = dict(kernel=1, tol=1.0, maxiter=6, max_relgap=0.0, compact=compact)
    ref = t_trws.solve(*T(inputs), **kw)
    res = mesh_mod.sharded_solve(cpu_mesh(batch, x), *T(inputs), **kw)
    _same_as_port(res, ref)
    _same_as_jax(res, j_trws.solve(*J(inputs), **kw, use_pallas=False))


@pytest.mark.parametrize("kernel", [1, 2])
@pytest.mark.parametrize("compact", [False, True])
def test_odd_column_offset(kernel, compact):
    """W = 27 over 3 shards: the middle shard starts at column 9, so its
    local column parity is the global one flipped (odd H too)."""
    prob = T(oracles.grid_trws_inputs(np.random.default_rng(1), 13, 27, 4))
    kw = dict(kernel=kernel, tol=1.0, maxiter=6, max_relgap=0.0,
              compact=compact, check_every=2)
    ref = t_trws.solve(*prob, **kw)
    res = mesh_mod.sharded_solve(cpu_mesh(1, 3), *prob, **kw)
    _same_as_port(res, ref)


def test_warm_start(inputs):
    """Warm-started messages split over the shards (the pool's chunks)."""
    prob = T(inputs)
    warm = t_trws.solve(*prob, kernel=2, tol=1.0, maxiter=3,
                        max_relgap=0.0).messages
    kw = dict(kernel=2, tol=1.0, maxiter=4, max_relgap=0.0, messages=warm,
              check_every=2)
    _same_as_port(mesh_mod.sharded_solve(cpu_mesh(1, 4), *prob, **kw),
                  t_trws.solve(*prob, **kw))


def test_batched_pairs_over_mesh(inputs):
    """Two pairs, stacked in numpy and carried across with
    convert.batched_problem_from_numpy, over a (2, 4) mesh."""
    from stereo_tpu_torch import convert

    th, d0, q, al = inputs
    stack = convert.batched_problem_from_numpy(
        np.stack([th, th * 1.5]), np.stack([d0, d0]), np.stack([q, q]),
        np.stack([al, al * 0.5]), device="cpu")[:4]
    theta, D0, Q, alphas = T(inputs)
    pairs = [(theta, alphas), (theta * 1.5, alphas * 0.5)]
    res = mesh_mod.sharded_solve(cpu_mesh(2, 4), *stack, kernel=1, tol=1.0,
                                 maxiter=5, max_relgap=0.0)
    assert res.energy.shape == (2,)
    for b, (th, al) in enumerate(pairs):
        ref = t_trws.solve(th, D0, Q, al, kernel=1, tol=1.0, maxiter=5,
                           max_relgap=0.0)
        assert torch.equal(res.labels[b], ref.labels)
        assert torch.equal(res.messages[b], ref.messages)
        assert float(res.energy[b]) == pytest.approx(float(ref.energy),
                                                     rel=1e-12)
        assert float(res.lower_bound[b]) == pytest.approx(
            float(ref.lower_bound), rel=1e-12)
        want = j_trws.solve(*J([th.numpy(), D0.numpy(), Q.numpy(),
                                al.numpy()]), kernel=1, tol=1.0, maxiter=5,
                            max_relgap=0.0, use_pallas=False)
        np.testing.assert_array_equal(res.labels[b].numpy(),
                                      np.asarray(want.labels))


def test_mesh_construction():
    m = cpu_mesh(2, 4)
    assert m.shape == {"batch": 2, "x": 4}
    with pytest.raises(ValueError, match="divisible by batch"):
        mesh_mod.make_mesh(6, batch=4, devices=["cpu"] * 6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_mod.make_mesh()
    prob = T(oracles.grid_trws_inputs(np.random.default_rng(2), 6, 10, 3))
    with pytest.raises(ValueError, match="not divisible"):
        mesh_mod.sharded_solve(cpu_mesh(1, 4), *prob, kernel=1, tol=1.0)
    with pytest.raises(ValueError, match="narrower than the halo"):
        mesh_mod.sharded_solve(cpu_mesh(1, 5), *prob, kernel=1, tol=1.0)


def test_columns_split_gather_exchange():
    line = mesh_mod.Line(["cpu"] * 4)
    cols = mesh_mod.Columns(line, 16)
    field = torch.arange(2 * 16, dtype=torch.float64).reshape(2, 16)
    parts = cols.split(field)
    assert [p.shape[-1] for p in parts] == [7, 10, 10, 7]
    assert torch.equal(cols.gather(parts), field)
    for p, i in zip(parts, line.index):
        a = cols.bounds[i][0]
        p.zero_()
        cols.owned(p, i).copy_(field[..., cols.bounds[i][1]:
                                     cols.bounds[i][2]])
    cols.exchange(parts)
    for p, i in zip(parts, line.index):
        a, _, _, b = cols.bounds[i]
        assert torch.equal(p, field[..., a:b])


# ------------------------------------------------------------ pooled pairs
def _models(n, H=16, W=24):
    from stereo_tpu_torch import geometry
    from stereo_tpu_torch.models.ncc import DispMapNCC

    models, props = [], []
    for seed in range(1, n + 1):
        r = np.random.default_rng(seed)
        im1 = r.uniform(0, 255, (H, W, 3))
        im0 = np.roll(im1, 3, axis=1) + r.normal(0, 2, (H, W, 3))
        dm = DispMapNCC([im0, im1], np.arange(0, 7), kernel=1,
                        unary_weight=40.0, tol=8.0, device="cpu")
        models.append(dm)
        props.append([geometry.fronto_parallel(H, W, float(d), dm.dtype,
                                               device="cpu")
                      for d in (0, 3, 6)])
    return models, props


def test_model_level_batched_fusion():
    """Two NCC models fused at once over a (2, 4) mesh match their own
    solves, and the models take the decoded labels."""
    models, props = _models(2)
    unary, D0, Q, alphas, stacks = batch_mod.batched_problem(models, props)
    singles = [t_trws.solve(unary[b], D0[b], Q[b], alphas[b], kernel=1,
                            tol=models[0].tol, maxiter=4, max_relgap=0.0)
               for b in range(2)]
    out = batch_mod.simultaneous_fusion_batched(models, props,
                                                cpu_mesh(2, 4), maxiter=4,
                                                max_relgap=0.0)
    for (e_b, lb_b, it_b), ref, dm, st in zip(out, singles, models, stacks):
        assert it_b == 4
        assert e_b == pytest.approx(float(ref.energy), rel=1e-12)
        assert lb_b == pytest.approx(float(ref.lower_bound), rel=1e-12)
        want = torch.gather(st, 0, ref.labels[None, None].long().expand(
            1, *st.shape[1:]))[0]
        assert torch.equal(dm.assignment, want)
        assert dm.energy() == pytest.approx(float(ref.energy), rel=1e-9)


def test_pool_per_pair_convergence_and_eviction():
    """N = 3 pairs through B = 2 slots: the third pair takes the first
    slot freed (it cannot finish first), each pair stops at its own count,
    and every result matches its own solve to the same stopping rule."""
    models, props = _models(3)
    singles = []
    for dm, pr in zip(models, props):
        u, d0, q, al, _ = batch_mod.model_problem(dm, pr)
        singles.append(t_trws.solve(u, d0, q, al, kernel=1, tol=dm.tol,
                                    maxiter=200, max_relgap=1e-4,
                                    check_every=5))
    order = []
    out = batch_mod.simultaneous_fusion_pool(
        models, props, cpu_mesh(2, 4), maxiter=200, max_relgap=1e-4,
        check_every=5, on_progress=lambda i, r: order.append(i))
    assert sorted(order) == [0, 1, 2] and order[0] != 2
    for res, ref in zip(out, singles):
        assert res["status"] in ("converged", "maxiter")
        assert res["iterations"] == int(ref.iterations)
        assert res["energy"] == pytest.approx(float(ref.energy), rel=1e-10)
        assert res["lower_bound"] == pytest.approx(float(ref.lower_bound),
                                                   rel=1e-10)
    for dm in models:
        assert np.isfinite(dm.energy())


def test_pool_failure_graceful(monkeypatch):
    """A persistently failing chunk ends the pool gracefully: the models keep
    their incumbents, unfinished pairs report 'failed'."""
    models, props = _models(2)
    before = [dm.assignment.clone() for dm in models]
    calls = []

    def boom(*a, **k):
        calls.append(k)
        raise RuntimeError("injected failure")

    monkeypatch.setattr(batch_mod.mesh_mod, "sharded_solve", boom)
    out = batch_mod.simultaneous_fusion_pool(
        models, props, cpu_mesh(2, 4), maxiter=50, max_relgap=1e-4,
        check_every=5, max_retries=1)
    assert len(calls) == 2  # the chunk and its one retry
    assert all(r["status"] == "failed" for r in out)
    for dm, b in zip(models, before):
        assert torch.equal(dm.assignment, b)


def test_pool_retry_recovers(monkeypatch):
    """A chunk that fails once is rerun on the same mesh and the pool
    carries on."""
    models, props = _models(2)
    real = batch_mod.mesh_mod.sharded_solve
    meshes = []

    def flaky(mesh, *a, **k):
        meshes.append(mesh)
        if len(meshes) == 1:
            raise RuntimeError("injected transient failure")
        return real(mesh, *a, **k)

    monkeypatch.setattr(batch_mod.mesh_mod, "sharded_solve", flaky)
    m = cpu_mesh(2, 4)
    out = batch_mod.simultaneous_fusion_pool(
        models, props, m, maxiter=10, max_relgap=1e-4, check_every=5)
    assert all(x is m for x in meshes)
    assert all(r["status"] in ("converged", "maxiter") for r in out)


def test_dryrun_multichip_on_cpu():
    """entry.dryrun_multichip's five checks on a (2, 2) CPU mesh at a small
    size; entry() runs its one solve."""
    from stereo_tpu_torch import entry

    out = entry.dryrun_multichip(4, devices=["cpu"] * 4, K=4, H=16, W=24)
    assert out["mesh"] == {"batch": 2, "x": 2}
    assert len(out["pool"]) == 3 and out["banded"]["stripes"] == 4
    fn, args = entry.entry(device="cpu")
    e, lb, labels = fn(*args)
    assert labels.shape == (96, 128) and float(lb) <= float(e)
