"""The distribution layer across several cards of one host.

    python3 tools/check_multicard.py          # every visible card (>= 2)
    python3 tools/check_multicard.py --cpu 4 --shape 5 24 32   # a rehearsal:
                                              # 4 CPU shards, gloo, small

chip_smoke.py drives the distribution layer on shards of one card; this
checks what only several cards have:

  1. sharded_solve over one mesh row of all the cards (cross-card halo
     copies) against one card, a synthetic K = 79 problem of 375 x 448
     (teddy's rows; columns that 2, 4 and 8 cards divide), 8 sweeps, compact (kernel 1) and full grid (kernel 2): labels and
     messages bit for bit;
  2. two pairs over a (2, n / 2) mesh, each against its own solve;
  3. sharded_banded_run over one stripe a card against
     BandedRun(sweep="steps"), 4 sweeps with a decode every 2;
  4. entry.dryrun_multichip(n) over the cards;
  5. parallel/multihost.py with one process a card over NCCL: the sharded
     solve and the banded stripes against this process's one-card runs.

Prints one JSON line a check, each with its seconds, and the cards' names
and power limits; any failed check raises (exit code non-zero).
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

from stereo_tpu_torch import entry, testing  # noqa: E402
from stereo_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from stereo_tpu_torch.solvers import banded, banded_dist, trws  # noqa: E402

SWEEPS, BANDED_SWEEPS, BANDED_DECODE = 8, 4, 2
TIMEOUT = 300


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def say(name, **kw):
    print(json.dumps({"check": name, **kw}), flush=True)


def sync(devices):
    for d in {torch.device(x) for x in devices}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def timed(fn, devices):
    t0 = time.perf_counter()
    out = fn()
    sync(devices)
    return out, time.perf_counter() - t0


def solves(devices, prob):
    n = len(devices)
    for compact in (True, False):
        kw = dict(kernel=1, tol=0.5, maxiter=SWEEPS, max_relgap=0.0,
                  check_every=SWEEPS, compact=compact)
        ref, t_one = timed(lambda: trws.solve(*prob, **kw), devices)
        mesh = mesh_mod.make_mesh(n, devices=devices)
        res, t_n = timed(lambda: mesh_mod.sharded_solve(mesh, *prob, **kw),
                         devices)
        check(torch.equal(res.labels, ref.labels)
              and torch.equal(res.messages, ref.messages),
              f"compact={compact}: {n} cards differ from one")
        say("sharded_solve", cards=n, compact=compact, sweeps=SWEEPS,
            one_card_seconds=t_one, seconds=t_n, energy=float(res.energy),
            one_card_energy=float(ref.energy), labels_messages="bit for bit")
    if n % 2 == 0:
        pairs = [prob, [a * 1.5 if j == 0 else a for j, a in enumerate(prob)]]
        stack = [torch.stack([p[j] for p in pairs]) for j in range(4)]
        kw = dict(kernel=1, tol=0.5, maxiter=SWEEPS, max_relgap=0.0,
                  check_every=SWEEPS)
        mesh = mesh_mod.make_mesh(n, batch=2, devices=devices)
        res, t_n = timed(lambda: mesh_mod.sharded_solve(mesh, *stack, **kw),
                         devices)
        for b, p in enumerate(pairs):
            ref = trws.solve(*p, **kw)
            check(torch.equal(res.labels[b].to(ref.labels.device),
                              ref.labels), f"batched pair {b} differs")
        say("sharded_solve_batched", mesh=mesh.shape, seconds=t_n,
            labels="bit for bit")


def stripes(devices, prob):
    n = len(devices)
    H, W = prob[0].shape[1:]
    BW = min(128, W)
    Bh = entry._stripe_bh(H, n)
    check(Bh is not None, f"no stripe height for {n} stripes of {H} rows")
    kw = dict(kernel=1, tol=0.5, Bh=Bh, Bw=BW)
    run = banded.BandedRun(*prob, **kw, sweep="steps")
    (st, _, _, labels), t_one = timed(lambda: run.run(
        run.init_state(), BANDED_SWEEPS, BANDED_DECODE), devices)
    mesh = banded_dist.make_y_mesh(n, devices=devices)
    res, t_n = timed(lambda: banded_dist.sharded_banded_run(
        mesh, *prob, **kw, sweeps=BANDED_SWEEPS, decode_every=BANDED_DECODE),
        devices)
    check(torch.equal(res.labels, labels)
          and torch.equal(res.messages, run.messages(st)),
          f"{n} stripes differ from one card")
    say("sharded_banded", stripes=n, blocks=[Bh, BW], sweeps=BANDED_SWEEPS,
        one_card_seconds=t_one, seconds=t_n, energy=float(res.energy),
        labels_messages="bit for bit")


def processes(devices, prob_np, backend):
    """One process a shard; process 0's results against this process."""
    n = len(devices)
    dev = devices[0]
    H, W = prob_np[0].shape[1:]
    BW = min(128, W)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{sk.getsockname()[1]}"
    Bh = entry._stripe_bh(H, n)
    with tempfile.TemporaryDirectory() as d:
        inp, out = os.path.join(d, "in.npz"), os.path.join(d, "out.npz")
        np.savez(inp, **dict(zip(("theta", "D0", "Q", "alphas"), prob_np)))
        device = "cpu" if torch.device(dev).type == "cpu" else "cuda"
        cmd = [sys.executable, "-m", "stereo_tpu_torch.parallel.multihost",
               "RANK", str(n), coord, "--inputs", inp, "--out", out,
               "--device", device, "--backend", backend, "--tol", "0.5",
               "--maxiter", str(SWEEPS), "--check-every", str(SWEEPS),
               "--banded", str(Bh), str(BW), str(BANDED_SWEEPS),
               str(BANDED_DECODE), "--timeout", str(TIMEOUT)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([str(r) if c == "RANK" else c
                                   for c in cmd], cwd=ROOT,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for r in range(n)]
        try:
            outs = [p.communicate(timeout=TIMEOUT) for p in procs]
        finally:
            for p in procs:  # only the processes started here
                if p.poll() is None:
                    p.kill()
                    p.wait()
        secs = time.perf_counter() - t0
        for p, (_, e) in zip(procs, outs):
            check(p.returncode == 0, f"worker exit {p.returncode}: "
                                     f"{e[-3000:]}")
        got = np.load(out)
        info = json.loads(outs[0][0].strip().splitlines()[-1])
    prob = [torch.as_tensor(a, device=dev) for a in prob_np]
    ref = trws.solve(*prob, kernel=1, tol=0.5, maxiter=SWEEPS,
                     max_relgap=0.0, check_every=SWEEPS)
    check(np.array_equal(got["solve_labels"], ref.labels.cpu().numpy())
          and np.array_equal(got["solve_messages"],
                             ref.messages.cpu().numpy()),
          f"{n} processes: the solve differs from one process")
    run = banded.BandedRun(*prob, kernel=1, tol=0.5, Bh=Bh, Bw=BW,
                           sweep="steps")
    _, _, _, labels = run.run(run.init_state(), BANDED_SWEEPS,
                              BANDED_DECODE)
    check(np.array_equal(got["banded_labels"], labels.cpu().numpy()),
          f"{n} processes: the stripes differ from one process")
    say("multihost", processes=n, backend=info["backend"],
        transport=info["transport"], solve_seconds=info["solve_seconds"],
        banded_seconds=info["banded_seconds"], seconds_with_start=secs,
        launches_process0=json.loads(info["launches"]),
        labels_messages="bit for bit")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", type=int, default=0, metavar="N",
                    help="rehearse on N CPU shards (gloo) instead of cards")
    ap.add_argument("--shape", type=int, nargs=3, default=(79, 375, 448),
                    metavar=("K", "H", "W"))
    a = ap.parse_args()
    if a.cpu:
        devices, backend = ["cpu"] * a.cpu, "gloo"
    else:
        devices, backend = mesh_mod.visible_devices(), "nccl"
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
        say("cards", cards=smi, torch=torch.__version__)
    check(len(devices) >= 2, f"needs 2 or more cards, has {len(devices)}")
    prob_np = testing.synthetic_problem(*a.shape, seed=5)
    prob = [torch.as_tensor(x, device=devices[0]) for x in prob_np]
    solves(devices, prob)
    stripes(devices, prob)
    out, secs = timed(lambda: entry.dryrun_multichip(len(devices),
                                                     devices=devices),
                      devices)
    say("dryrun_multichip", mesh=out["mesh"], seconds=secs)
    processes(devices, prob_np, backend)
    print(json.dumps({"ok": True, "devices": [str(d) for d in devices]}))


if __name__ == "__main__":
    main()
