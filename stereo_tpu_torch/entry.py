"""Entry points: a one-device solve check and a multi-device dry run
(port of the repository's __graft_entry__.py).

    python3 -m stereo_tpu_torch.entry            # entry(): one solve
    python3 -m stereo_tpu_torch.entry dryrun 4   # dryrun_multichip(4)

On a host with fewer cards than shards the shards share the cards (four on
one card is ``["cuda:0"] * 4``); ``devices=["cpu"] * n`` runs on the CPU.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from stereo_tpu_torch.device import DEFAULT_DEVICE, resolve_device


def _synthetic_problem(K, H, W, batch=None, seed=0, dtype="float32",
                       device=DEFAULT_DEVICE):
    """The JAX entry's synthetic problem (same draws for the same seed), as
    tensors on ``device``."""
    rng = np.random.default_rng(seed)
    shape = (K, H, W) if batch is None else (batch, K, H, W)
    qshape = (4,) + shape if batch is None else (batch, 4, K, H, W)
    theta = rng.uniform(0, 5, shape).astype(dtype)
    D0 = rng.uniform(0, 10, shape).astype(dtype)
    Q = (np.expand_dims(D0, -4) + rng.normal(0, 0.1, qshape)).astype(dtype)
    alphas = np.zeros((4, H, W), dtype)
    alphas[0, :, 1:] = 9.0
    alphas[1, :, :-1] = 9.0
    alphas[2, 1:, :] = 9.0
    alphas[3, :-1, :] = 9.0
    if batch is not None:
        alphas = np.broadcast_to(alphas, (batch,) + alphas.shape).copy()
    dev = resolve_device(device)
    return tuple(torch.as_tensor(a, device=dev)
                 for a in (theta, D0, Q, alphas))


def entry(device=DEFAULT_DEVICE):
    """(fn, example_args): a simultaneous-fusion step on the flagship model —
    one checkerboard TRW-S solve (energy, lower bound, labels)."""
    from stereo_tpu_torch.solvers import trws

    def fn(theta, D0, Q, alphas):
        res = trws.solve(theta, D0, Q, alphas, kernel=1, tol=0.02,
                         maxiter=3, max_relgap=0.0)
        return res.energy, res.lower_bound, res.labels

    return fn, _synthetic_problem(K=8, H=96, W=128, device=device)


def _default_devices(n: int) -> list:
    """n shards over the visible cards, several a card when there are
    fewer cards than shards."""
    from stereo_tpu_torch.parallel.mesh import visible_devices

    cards = visible_devices()
    return [cards[i % len(cards)] for i in range(n)]


def _stripe_bh(h: int, n: int):
    """A block height giving every one of n stripes whole block-rows: one
    block-row a stripe (Bh = ceil(h / n)) when (n - 1) Bh < h, else Bh = 2;
    None when neither works (e.g. n = 63)."""
    for bh in (max(2, -(-h // n)), 2):
        if (-(-h // bh)) % n == 0:
            return bh
    return None


def _check(ok, what: str):
    if not ok:
        raise AssertionError(what)


def dryrun_multichip(n_devices: int, devices=None, K: int = 15, H: int = 128,
                     W: int = 256) -> dict:
    """Run every distribution path over an n_devices mesh and check **label
    equality against in-process one-device solves** (K = 15 at 128 x 256 by
    default):

      1. checkerboard TRW-S sharded over ('batch', 'x')       [standard]
      2. the same with the compacted sweeps                   [compact]
      3. banded TRW-S over the gy stripes of a ('y',) mesh    [banded]
         + a warm-started chunk (messages round-trip the stripe layout),
         and two pairs over a ('batch', 'y') mesh
      4. a distributed K = 2 binary fusion move over ('x',)   [fusion]
      5. the pooled multi-pair run streaming N > B pairs      [pool]

    ``devices`` defaults to the visible cards, shared when there are fewer
    than n_devices.  Returns (and prints) a summary."""
    from stereo_tpu_torch import energy as energy_mod, geometry
    from stereo_tpu_torch.models.ncc import DispMapNCC
    from stereo_tpu_torch.parallel import batch as batch_mod
    from stereo_tpu_torch.parallel import fusion_dist, mesh as mesh_mod
    from stereo_tpu_torch.solvers import banded, banded_dist, binary, trws

    devices = list(devices if devices is not None
                   else _default_devices(n_devices))[:n_devices]
    _check(len(devices) == n_devices,
           f"need {n_devices} devices, have {len(devices)}")
    dev = torch.device(devices[0])
    batch = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    m = mesh_mod.make_mesh(n_devices, batch=batch, devices=devices)
    # sharded_solve / sharded_fusion_step need W divisible by the mesh's
    # 'x' axis (n_devices // batch resp. n_devices): round up to n_devices
    W = W if W % n_devices == 0 else n_devices * (W // n_devices + 1)
    theta, D0, Q, alphas = _synthetic_problem(
        K, H, W, batch=batch if batch > 1 else None, device=dev)
    one = (lambda a: a[0]) if batch > 1 else (lambda a: a)
    t0, d0, q0, a0 = map(one, (theta, D0, Q, alphas))
    out = {"mesh": m.shape, "K": K, "size": [H, W]}

    # 1-2. sharded checkerboard, full grid and compact: labels vs one device
    for compact in (False, True):
        kw = dict(kernel=1, tol=0.5, maxiter=6, max_relgap=0.0,
                  compact=compact)
        ref = trws.solve(t0, d0, q0, a0, **kw)
        res = mesh_mod.sharded_solve(m, theta, D0, Q, alphas, **kw)
        e = res.energy.double().cpu().numpy()
        lb = res.lower_bound.double().cpu().numpy()
        name = "compact" if compact else "standard"
        _check(np.isfinite(e).all() and np.isfinite(lb).all()
               and (lb <= e + 1e-5 * np.abs(e)).all(),
               f"{name}: E {e}, lb {lb}")
        _check(torch.equal(one(res.labels).to(dev), ref.labels),
               f"sharded {name} labels != one-device")
        _check(np.allclose(one(e), float(ref.energy), rtol=1e-5),
               f"{name}: E {one(e)} vs {float(ref.energy)}")
        out[name] = dict(energy=e.tolist(), lower_bound=lb.tolist())

    # 3. banded over gy stripes, a warm-started chunk, batched pairs
    Bw = 32
    Bh = _stripe_bh(H, n_devices)
    out["banded"] = "skipped (no stripe-aligned Bh)"
    if Bh is not None:
        my = banded_dist.make_y_mesh(n_devices, devices=devices)
        bkw = dict(kernel=1, tol=0.5, Bh=Bh, Bw=Bw)
        run = banded.BandedRun(t0, d0, q0, a0, **bkw, sweep="steps")
        _, bE, _, bL = run.run(run.init_state(), 4, 2)
        resb = banded_dist.sharded_banded_run(my, t0, d0, q0, a0, **bkw,
                                              sweeps=4, decode_every=2)
        eb, lbb = float(resb.energy), float(resb.lower_bound)
        _check(np.isfinite(eb) and lbb <= eb + 1e-5 * abs(eb),
               f"banded: E {eb}, lb {lbb}")
        _check(torch.equal(resb.labels.to(dev), bL),
               "sharded banded labels != one-device")
        _check(np.isclose(eb, float(bE), rtol=1e-5),
               f"banded E {eb} vs {float(bE)}")
        # warm start: messages of a 2-sweep run round-trip the stripes
        st, _, _, _ = run.run(run.init_state(), 2, 2)
        msgs_in = run.messages(st)
        _, wE, _, wL = run.run(run.init_state(msgs_in), 2, 2)
        resw = banded_dist.sharded_banded_run(
            my, t0, d0, q0, a0, **bkw, sweeps=2, decode_every=2,
            messages=msgs_in)
        _check(torch.equal(resw.labels.to(dev), wL),
               "warm-started sharded banded labels != one-device")
        _check(np.isclose(float(resw.energy), float(wE), rtol=1e-5),
               "warm-started banded energy")
        out["banded"] = dict(energy=eb, lower_bound=lbb, stripes=n_devices,
                             Bh=Bh, Bw=Bw, warm_energy=float(resw.energy))
    Bh2 = _stripe_bh(H, n_devices // batch) if batch > 1 else None
    if Bh2 is not None:
        myb = banded_dist.make_y_mesh(n_devices, devices=devices,
                                      batch=batch)
        resbb = banded_dist.sharded_banded_run(
            myb, theta, D0, Q, alphas, kernel=1, tol=0.5, Bh=Bh2, Bw=Bw,
            sweeps=2, decode_every=2)
        for b in range(batch):
            run_b = banded.BandedRun(theta[b], D0[b], Q[b], alphas[b],
                                     kernel=1, tol=0.5, Bh=Bh2, Bw=Bw,
                                     sweep="steps")
            _, eB, _, LB = run_b.run(run_b.init_state(), 2, 2)
            _check(torch.equal(resbb.labels[b].to(dev), LB),
                   f"batched banded labels != one-device (pair {b})")
            _check(np.isclose(float(resbb.energy[b]), float(eB), rtol=1e-5),
                   f"batched banded energy (pair {b})")
        out["banded_batched"] = resbb.energy.tolist()

    # 4. one K = 2 fusion move over an ('x',) column mesh: take mask and
    #    fused planes bit for bit against the one-device move
    rng = np.random.default_rng(7)

    def mk_planes():
        p = rng.standard_normal((4, H, W)).astype("float32")
        p[2] = np.sign(p[2]) * (np.abs(p[2]) + 0.5)
        return torch.as_tensor(p, device=dev)

    cur, prop = mk_planes(), mk_planes()
    wgt = energy_mod.default_weights(H, W, dtype=torch.float32, device=dev)
    U0 = torch.as_tensor(rng.uniform(0, 3, (H, W)).astype("float32"),
                         device=dev)
    U1 = torch.as_tensor(rng.uniform(0, 3, (H, W)).astype("float32"),
                         device=dev)
    D0f, Qf = binary.fusion_problem(cur, prop)
    reff = binary.binary_fuse(U0, U1, D0f, Qf, wgt, kernel=1, tol=0.9,
                              maxiter=12, max_relgap=0.0,
                              accept_method="sort")
    mx = mesh_mod.make_mesh(n_devices, batch=1, devices=devices)
    fusedx, takex, ef, _ = fusion_dist.sharded_fusion_step(
        mx, cur, prop, U0, U1, wgt, kernel=1, tol=0.9, maxiter=12,
        max_relgap=0.0)
    _check(torch.equal(takex.to(dev), reff.take),
           "sharded fusion take mask != one-device")
    # float32 energy sums reassociate across shards
    _check(np.isclose(float(ef), float(reff.energy), rtol=1e-4),
           f"fusion E {float(ef)} vs {float(reff.energy)}")
    _check(torch.equal(fusedx.to(dev),
                       energy_mod.fuse_labelling(cur, prop, reff.take)),
           "sharded fused planes != one-device")
    out["fusion"] = dict(energy=float(ef), taken=int(takex.sum()),
                         shards=n_devices)

    # 5. the pool: N = 3 pairs through B = batch slots, per-pair eviction;
    #    every result against its own solve to the same stopping rule
    out["pool"] = "skipped (no batch axis)"
    if batch > 1:
        pm, pp = [], []
        for seed in range(1, 4):
            r = np.random.default_rng(seed)
            im1 = r.uniform(0, 255, (H, W, 3))
            im0 = np.roll(im1, 3, axis=1) + r.normal(0, 2, (H, W, 3))
            dm = DispMapNCC([im0.astype("float32"), im1.astype("float32")],
                            np.arange(0, 7), kernel=1, unary_weight=40.0,
                            tol=8.0, device=dev)
            pm.append(dm)
            pp.append([geometry.fronto_parallel(H, W, float(d), dm.dtype,
                                                device=dev)
                       for d in (0, 3, 6)])
        singles = []
        for dm, pr in zip(pm, pp):
            u1, d1, q1, a1, _ = batch_mod.batched_problem([dm], [pr])
            singles.append(trws.solve(u1[0], d1[0], q1[0], a1[0], kernel=1,
                                      tol=dm.tol, maxiter=10,
                                      max_relgap=1e-4, check_every=5))
        res_p = batch_mod.simultaneous_fusion_pool(
            pm, pp, m, maxiter=10, max_relgap=1e-4, check_every=5)
        for r_, ref_ in zip(res_p, singles):
            _check(r_["status"] in ("converged", "maxiter"), f"pool {r_}")
            # same labels, another reduction order across the shards
            _check(np.isclose(r_["energy"], float(ref_.energy), rtol=1e-4),
                   f"pool {r_} vs {float(ref_.energy)}")
        out["pool"] = [dict(r_) for r_ in res_p]
    print("dryrun_multichip OK:", out, flush=True)
    return out


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "dryrun":
        dryrun_multichip(int(sys.argv[2]) if len(sys.argv) > 2 else 8)
    else:
        fn, args = entry()
        res = fn(*args)
        print("entry OK:", [tuple(o.shape) for o in res])
