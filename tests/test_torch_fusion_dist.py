"""stereo_tpu_torch.parallel.fusion_dist (fusion moves over column shards)
vs the port's one-device binary fusion and vs the JAX package.  CPU,
float64, the mesh a list of CPU devices.

Tolerances: take masks, component ids and fused planes equal (the shards run
the one-device arithmetic; the verdicts the same sorted scan); energy rel
1e-12 and bound rel 1e-9 against the port (per-shard partials), rel 1e-10
against JAX."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_tpu import energy as j_energy
from stereo_tpu.solvers import binary as j_binary
from stereo_tpu_torch import energy as t_energy
from stereo_tpu_torch.parallel import fusion_dist
from stereo_tpu_torch.parallel import mesh as mesh_mod
from stereo_tpu_torch.solvers import binary as t_binary

torch.set_num_threads(1)


def cpu_mesh(n):
    return mesh_mod.make_mesh(n, devices=["cpu"] * n)


def _planes(rng, H, W):
    p = rng.standard_normal((4, H, W))
    p[2] = np.sign(p[2]) * (np.abs(p[2]) + 0.5)
    return p


def _inputs(H, W, seed):
    rng = np.random.default_rng(seed)
    cur, prop = _planes(rng, H, W), _planes(rng, H, W)
    U0 = rng.uniform(0, 3, (H, W))
    U1 = rng.uniform(0, 3, (H, W))
    return cur, prop, U0, U1


def _check_move(cur, prop, U0, U1, n, kernel, tol=0.9, improve=0, jax=True):
    H, W = U0.shape
    c, p, u0, u1 = (torch.as_tensor(a) for a in (cur, prop, U0, U1))
    w = t_energy.default_weights(H, W, dtype=torch.float64, device="cpu")
    D0, Q = t_binary.fusion_problem(c, p)
    kw = dict(kernel=kernel, tol=tol, maxiter=30, max_relgap=0.0,
              improve=improve)
    ref = t_binary.binary_fuse(u0, u1, D0, Q, w, **kw, accept_method="sort")
    fused, take, e, lb = fusion_dist.sharded_fusion_step(
        cpu_mesh(n), c, p, u0, u1, w, **kw)
    assert torch.equal(take, ref.take)
    assert torch.equal(fused, t_energy.fuse_labelling(c, p, ref.take))
    assert float(e) == pytest.approx(float(ref.energy), rel=1e-12)
    assert float(lb) == pytest.approx(float(ref.lower_bound), rel=1e-9)
    e_keep = t_binary._k2_energy(torch.zeros_like(take), u0, u1,
                                 t_binary._tables(D0, Q, w, kernel, tol))
    assert float(e) <= float(e_keep) + 1e-9
    if jax:
        jc, jp, j0, j1 = (jnp.asarray(a) for a in (cur, prop, U0, U1))
        jD0, jQ = j_binary.fusion_problem(jc, jp)
        want = j_binary.binary_fuse(
            j0, j1, jD0, jQ, j_energy.default_weights(H, W, jnp.float64),
            **kw, accept_method="sort")
        np.testing.assert_array_equal(take.numpy(), np.asarray(want.take))
        assert float(e) == pytest.approx(float(want.energy), rel=1e-10)
    return take


@pytest.mark.parametrize("kernel", [1, 2])
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_fusion_step_bitwise(n, kernel):
    _check_move(*_inputs(12, 24, seed=n + 10 * kernel), n, kernel)


def test_component_spans_every_shard():
    """A proposal far cheaper on rows 3-6 of every column: the accepted
    component crosses every cut, and its verdict is the one-device one."""
    cur, prop, U0, U1 = _inputs(12, 24, seed=3)
    U1[3:7] -= 20.0
    take = _check_move(cur, prop, U0, U1, 4, 1)
    assert bool(take[3:7].all())
    comp = t_binary.connected_components(take)
    assert len(torch.unique(comp[3:7])) == 1


def test_sharded_fusion_step_improve():
    """improve > 0: the ICM and 2x2-block polish of the decoded mask."""
    _check_move(*_inputs(12, 24, seed=8), 4, 1, improve=2, jax=False)


def test_sharded_connected_components_cross_shard():
    """Components that snake across every cut (U-shapes spanning the full
    width, one-pixel bridges at alternating ends) get one id each: the row
    scans carry the min ids across the cuts."""
    H, W = 16, 24
    z = np.zeros((H, W), bool)
    for r in range(0, H, 2):
        z[r, :] = True
    for r in range(1, H - 1, 2):
        z[r, -1 if (r // 2) % 2 == 0 else 0] = True
    z[H - 1, 5:19] = True  # a second run, joined through row H - 2
    zt = torch.as_tensor(z)
    ref = t_binary.connected_components(zt)
    np.testing.assert_array_equal(
        ref.numpy(), np.asarray(j_binary.connected_components(
            jnp.asarray(z))))
    sh = fusion_dist._Shards(mesh_mod.Line(["cpu"] * 8), H, W, torch.float64)
    own = [sh.cols.owned(s, i) for s, i in zip(sh.split(zt), range(8))]
    out = torch.cat(fusion_dist._components(sh, own), 1)
    assert torch.equal(out, ref)
    assert len(torch.unique(ref[zt])) == 1


def test_sharded_fusion_sweep_matches_per_move():
    """A 6-proposal stream through sharded_fusion_sweep equals the per-move
    one-device loop (planes bit for bit, energies rel 1e-12); padded
    (live=False) entries are identities.  (The one-device move against the
    JAX package's: test_sharded_fusion_step_bitwise and
    tests/test_torch_binary.py.)"""
    H, W, tol, kernel = 12, 24, 0.9, 1
    rng = np.random.default_rng(5)
    cur = _planes(rng, H, W)
    props = [_planes(rng, H, W) for _ in range(6)]
    base = rng.uniform(0, 3, (H, W))
    w = t_energy.default_weights(H, W, dtype=torch.float64, device="cpu")
    tb = torch.as_tensor(base)

    def unary_p(p):
        return tb + 0.3 * torch.abs(p[3])

    ref = torch.as_tensor(cur)
    es_ref = []
    for p in props:
        tp = torch.as_tensor(p)
        D0, Q = t_binary.fusion_problem(ref, tp)
        r = t_binary.binary_fuse(unary_p(ref), unary_p(tp), D0, Q, w,
                                 kernel=kernel, tol=tol, maxiter=30,
                                 max_relgap=0.0, accept_method="sort")
        ref = t_energy.fuse_labelling(ref, tp, r.take)
        es_ref.append(float(r.energy))

    stack = torch.as_tensor(np.stack(props + [props[-1]] * 2, 0))
    live = torch.arange(8) < 6
    fused, es, lbs = fusion_dist.sharded_fusion_sweep(
        cpu_mesh(4), torch.as_tensor(cur), stack, w, unary_p, kernel=kernel,
        tol=tol, live=live, maxiter=30, max_relgap=0.0)
    assert torch.equal(fused, ref)
    np.testing.assert_allclose(es[:6].numpy(), es_ref, rtol=1e-12)
    assert all(b <= a + 1e-9 for a, b in zip(es_ref, es_ref[1:]))
