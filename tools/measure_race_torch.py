"""Time-to-energy race of the TRW-S schedules on one problem: the host's
serial TRW-S against the device schedules of the PyTorch / CUDA port (the
counterpart of tools/measure_race.py).

    python3 tools/measure_race_torch.py [--pair baby2] [--skip host,scan]
        [--host-order raster,banded] [--band 128 64 96]
        [--max-sweeps banded=3000 scan=100] [--out PATH]
    python3 tools/measure_race_torch.py --merge A.json B.json --out C.json
    python3 tools/measure_race_torch.py --device cpu --pair synth ...

The problem is the simultaneous-fusion problem of
examples/run_simultaneous_torch.py: the model's 14 SegPln proposals plus its
start field (K = 15 on baby2), float32, seed 0.  It is cached under
``$TMPDIR`` (``--cache``) so that several runs share one SegPln.  Raced:

  1. the native serial TRW-S (solvers/trws_host.py, float64 on one core) in
     each order of ``--host-order`` (raster, bipartite, or the banded
     solver's block order at ``--band``), to ``--host-maxiter`` iterations
     or a gap of ``--host-relgap``, with its per-iteration trace; the first
     order's final energy is the target of the device schedules;
  2. the device schedules in chunks, each chunk warm-started from the last
     one's messages, until a chunk's decoded energy is at or below the
     target (or to the schedule's cap, when there is no target):
     checkerboard (kernel 1), scanline (kernel 4), the fused raster
     wavefront (kernel 6), the fused banded sweep at each ``--band``
     (kernel 5; packed once, a best-energy incumbent over the chunk's
     decodes), and the checkerboard from a two-level pyramid warm start
     (kernel 1 at the coarse shapes too).

Each schedule first runs one chunk of its shape off the clock.  The report
(JSON, ``--out``) has for each schedule its curve of (sweeps, seconds,
energy, bound) per chunk, the launches of the four kernels it ran, and under
``reach`` the sweeps and seconds to the target and to the 1e-4 and 1e-5 gaps
and where its bound settles.  ``--merge`` joins reports of runs made apart
(for example the host orders in processes of their own) and computes
``reach`` again against the merged target.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from stereo_tpu_torch.device import resolve_device  # noqa: E402
from stereo_tpu_torch.ops import (banded_kernel, minplus,  # noqa: E402
                                  phase_kernel, wavefront_kernel)
from stereo_tpu_torch.solvers import (  # noqa: E402
    banded, hierarchy, scanline, trws, trws_host, wavefront)

# the kernels a race runs, by their wrappers' names (chip_smoke.py's keys)
COUNTED = {"phase_messages_compact": phase_kernel.phase_messages_compact,
           "minplus_send": minplus.minplus_send,
           "sweep_banded": banded_kernel.sweep_banded,
           "sweep_wavefront": wavefront_kernel.sweep_wavefront}
# (schedule, chunk, cap) of each race: the JAX tool's for checkerboard,
# scanline and the hierarchy, measure_wavefront.py's for the wavefront,
# bench.py's run_extras chunk for the banded schedule with the reference
# budget as cap
RACES = {"cb": ("checkerboard", 500, 40000), "scan": ("scanline", 50, 3000),
         "wf": ("wavefront", 25, 800), "banded": ("banded", 100, 3000),
         "hier": ("hierarchy", 500, 40000)}
DECODE_EVERY = 50  # the banded schedule's decodes in a chunk (bench.py:168)
GAPS = (1e-4, 1e-5)


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reset_counts():
    for w in COUNTED.values():
        w.launches = 0


def read_counts() -> dict:
    return {name: w.launches for name, w in COUNTED.items()}


# ------------------------------------------------------------- the problem
def build_problem(dm, proposals):
    """The TRW-S problem of a model's simultaneous fusion over
    ``proposals``, the model's assignment joining as the last label:
    (unary [K, H, W], D0 [K, H, W], Q [4, K, H, W], alphas [4, H, W])."""
    return dm.simultaneous_problem(proposals)[:4]


def default_cache(pair: str) -> str:
    return os.path.join(tempfile.gettempdir(),
                        f"race_problem_torch_{pair}.npz")


def load_problem(pair: str, device, cache: str | None):
    """(unary, D0, Q, alphas, kernel, tol) of ``pair``'s race problem on
    ``device``: read from ``cache`` where it exists, else built
    (examples/run_global_torch.py's model, float32, seed 0, its SegPln
    proposals and start field) and written there."""
    if cache and os.path.exists(cache):
        z = np.load(cache)
        arrs = [torch.as_tensor(z[k], device=device)
                for k in ("unary", "D0", "Q", "alphas")]
        print(f"loaded problem from {cache}", flush=True)
        return (*arrs, int(z["kernel"]), float(z["tol"]))
    from examples.run_global_torch import build_model

    dm = build_model(pair, "float32", seed=0, device=device)
    proposals = dm.segpln(seed=0)
    print(f"{len(proposals)} proposals", flush=True)
    arrs = build_problem(dm, proposals)
    kernel, tol = dm.smoothness_kernel, float(dm.tol)
    if cache:
        np.savez(cache, **{k: a.cpu().numpy() for k, a in zip(
            ("unary", "D0", "Q", "alphas"), arrs)}, kernel=kernel, tol=tol)
    return (*arrs, kernel, tol)


def problem_sha(prob) -> str:
    """A digest of (kernel, tol, unary, D0, Q, alphas): runs made apart
    race on one problem only if theirs agree."""
    sha = hashlib.sha256(repr(prob[:2]).encode())
    for a in prob[2:]:
        sha.update(a.detach().cpu().contiguous().numpy().tobytes())
    return sha.hexdigest()[:16]


# -------------------------------------------------------------------- host
def host_order(order: str, H: int, W: int, band: int = 128) -> np.ndarray:
    if order == "raster":
        return trws_host.raster_order(H, W)
    if order == "bipartite":
        return trws_host.bipartite_order(H, W)
    if order == "banded":
        return np.asarray(banded.banded_order(H, W, min(band, H),
                                              min(band, W)), np.int32)
    raise ValueError(f"unknown order {order!r}")


def run_host(kernel, tol, unary, D0, Q, alphas, maxiter, relgap,
             order="raster", band=128):
    """The serial TRW-S in ``order`` with its per-iteration trace."""
    K, H, W = unary.shape
    theta, tails, heads, q_src, q_dst, al = trws_host.grid_to_edges(
        unary, D0, Q, alphas)
    ordv = host_order(order, H, W, band)
    t0 = time.perf_counter()
    labels, e, lb, iters, tr = trws_host.solve(
        kernel, theta, tails, heads, q_src, q_dst, al, tol, ordv,
        maxiter=maxiter, max_relgap=relgap, trace=True)
    dt = time.perf_counter() - t0
    return {"energy": float(e), "lb": float(lb), "iters": int(iters),
            "seconds": dt,
            "trace_e": tr["energy"].tolist(),
            "trace_lb": tr["lower_bound"].tolist(),
            "trace_s": tr["seconds"].tolist()}


def host_summary(host: dict, order: str) -> dict:
    """The JAX tool's ``host`` entry (with the seconds at which the trace
    first came within 0.1% and 0.01% of its final energy), and the trace
    as a curve."""
    out = {k: host[k] for k in ("energy", "lb", "iters", "seconds")}
    out["order"] = order
    te, ts = np.asarray(host["trace_e"]), np.asarray(host["trace_s"])
    for frac, name in ((1.001, "t_within_0.1pct"),
                       (1.0001, "t_within_0.01pct")):
        hit = np.nonzero(te <= host["energy"] * frac)[0]
        out[name] = float(ts[hit[0]]) if len(hit) else None
    out["curve"] = [{"sweeps": i + 1, "t": s, "e": e, "lb": lb}
                    for i, (e, lb, s) in enumerate(zip(
                        host["trace_e"], host["trace_lb"],
                        host["trace_s"]))]
    return out


# ------------------------------------------------------------------ device
def run_device(kernel, tol, unary, D0, Q, alphas, schedule, chunk,
               max_sweeps, target_e, messages=None, t_accum=0.0, *,
               band=128, decode_every=DECODE_EVERY):
    """Chunked solve recording (cumulative seconds, energy, bound) per
    chunk, each chunk warm-started from the last; stops after the first
    chunk whose energy is at or below ``target_e`` (None: at
    ``max_sweeps``).  -> (curve, messages [4, K, H, W])."""
    kw = dict(kernel=kernel, tol=tol)
    dev, (H, W) = unary.device, unary.shape[1:]
    if schedule == "banded":
        run = banded.BandedRun(unary, D0, Q, alphas, Bh=min(band, H),
                               Bw=min(band, W), **kw)
        state = run.init_state(messages)
    else:
        solve = {"checkerboard": trws.solve,
                 "scanline": scanline.solve_scanline,
                 "wavefront": wavefront.solve_wavefront}[schedule]
    curve = []
    total = 0
    while total < max_sweeps:
        _sync(dev)
        t0 = time.perf_counter()
        if schedule == "banded":
            state, e, lb, _ = run.run(state, chunk, decode_every)
            n = chunk
        else:
            res = solve(unary, D0, Q, alphas, maxiter=chunk,
                        max_relgap=1e-12, check_every=chunk,
                        messages=messages, **kw)
            messages, e, lb, n = (res.messages, res.energy,
                                  res.lower_bound, int(res.iterations))
        e, lb = float(e), float(lb)
        _sync(dev)
        t_accum += time.perf_counter() - t0
        total += n
        curve.append({"sweeps": total, "t": t_accum, "e": e, "lb": lb})
        print(f"  {schedule} {total}: t={t_accum:.2f}s E={e:.8g} "
              f"lb={lb:.8g}", flush=True)
        if target_e is not None and e <= target_e:
            break
    if schedule == "banded":
        messages = run.messages(state)
    return curve, messages


def hierarchy_warm_start(kernel, tol, unary, D0, Q, alphas, *,
                         coarse_sweeps=600, check_every=100,
                         use_kernel=True):
    """The JAX tool's pyramid warm start: two coarsenings, each coarse
    level solved on the checkerboard schedule (to a gap of 1e-6 or
    ``coarse_sweeps``) from the level above and its messages upsampled to
    the next.  -> messages [4, K, H, W]."""
    pyr = [(unary, D0, Q, alphas)]
    for _ in range(2):
        pyr.append(hierarchy.coarsen(*pyr[-1]))
    messages = None
    for lvl in (2, 1):
        res = trws.solve(*pyr[lvl], kernel=kernel, tol=tol,
                         maxiter=coarse_sweeps, max_relgap=1e-6,
                         check_every=check_every, messages=messages,
                         use_kernel=use_kernel)
        messages = hierarchy.upsample_messages(res.messages,
                                               pyr[lvl - 1][0].shape[-2:])
    return messages


# ----------------------------------------------------------------- summary
def reach(curve: list, target_e) -> dict:
    """Where a curve first reaches ``target_e`` (its best energy so far) and
    each gap of GAPS (best energy so far against that point's bound), as
    {sweeps, t} or None; its last point; and where its bound settles (the
    first point within 1e-6 of the last bound, relative)."""
    best, out = float("inf"), {}
    hits = {"target": None, **{f"gap_{g:g}": None for g in GAPS}}
    for p in curve:
        best = min(best, p["e"])
        at = {"sweeps": p["sweeps"], "t": p["t"]}
        if hits["target"] is None and target_e is not None \
                and best <= target_e:
            hits["target"] = at
        for g in GAPS:
            if hits[f"gap_{g:g}"] is None and best - p["lb"] < g * abs(best):
                hits[f"gap_{g:g}"] = at
    last = curve[-1]
    settle = next(p for p in curve
                  if p["lb"] >= last["lb"] - 1e-6 * abs(last["lb"]))
    out.update(hits, sweeps=last["sweeps"], t=last["t"], best_e=best,
               final_lb=last["lb"], lb_settled_sweeps=settle["sweeps"])
    return out


def curves(report: dict) -> dict:
    """Every curve of a report by name: the device schedules', the
    banded one per band, and the host's per order."""
    out = {name: report[name] for name in ("checkerboard", "scanline",
                                           "wavefront", "hierarchy")
           if name in report}
    out.update({f"banded_{b}": c for b, c in report.get("banded",
                                                        {}).items()})
    out.update({f"host_{o}": h["curve"]
                for o, h in report.get("host_orders", {}).items()})
    return out


def finish(report: dict) -> dict:
    """Adds ``reach`` for every curve and prints it, a line a curve."""
    report["reach"] = {name: reach(c, report.get("target_e"))
                       for name, c in curves(report).items() if c}
    print(f"target_e {report.get('target_e')} card {report.get('card')}",
          flush=True)
    for name, r in report["reach"].items():
        print(json.dumps({"curve": name, **r}), flush=True)
    return report


def merge(paths) -> dict:
    """Reports of separate runs of one problem as one (their
    ``problem_sha`` must agree): later files add their schedules; ``host``
    and the target are the first file's that has them."""
    out = {}
    for path in paths:
        with open(path) as f:
            rep = json.load(f)
        if rep["problem_sha"] != out.get("problem_sha", rep["problem_sha"]):
            raise SystemExit(f"{path}: another problem than the reports "
                             "before it")
        for key in ("banded", "host_orders", "launches"):
            out.setdefault(key, {}).update(rep.pop(key, {}))
        rep.pop("reach", None)
        for key in ("host", "host_curve", "target_e"):
            value = rep.pop(key, None)
            if value is not None and out.get(key) is None:
                out[key] = value
        out.update(rep)
    return finish(out)


# -------------------------------------------------------------------- main
def _caps(entries) -> dict:
    """Each race's cap: RACES's, or a ``race=N`` entry of --max-sweeps."""
    out = {k: v[2] for k, v in RACES.items()}
    for item in entries:
        name, _, value = item.partition("=")
        if name not in RACES or not value.isdigit():
            raise SystemExit(f"--max-sweeps: {item!r} is not one of "
                             f"{sorted(RACES)}=N")
        out[name] = int(value)
    return out


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pair", default="baby2")
    ap.add_argument("--host-maxiter", type=int, default=3000)
    ap.add_argument("--host-relgap", type=float, default=1e-5)
    ap.add_argument("--host-order", default="raster",
                    help="comma list of raster, bipartite, banded; the "
                    "first one's energy is the target")
    ap.add_argument("--skip", default="",
                    help="comma list: host,cb,scan,hier,wf,banded")
    ap.add_argument("--band", type=int, nargs="+", default=[128],
                    help="block sizes of the banded race (and of the host's "
                    "banded order: the first)")
    ap.add_argument("--target-e", type=float, default=None,
                    help="the devices' target (default: the host's energy; "
                    "with the host skipped, none: race to the caps)")
    ap.add_argument("--max-sweeps", nargs="*", default=[],
                    help="race=N: a race's cap (races: "
                    + ", ".join(f"{k} {v[2]}" for k, v in RACES.items())
                    + "; a chunk is the smaller of its own and the cap)")
    ap.add_argument("--cache", default=None,
                    help="problem cache (default: $TMPDIR/"
                    "race_problem_torch_<pair>.npz)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(
        tempfile.gettempdir(), "race_report_torch.json"))
    ap.add_argument("--merge", nargs="+", default=None,
                    help="join these reports into --out and stop")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    if args.merge:
        report = merge(args.merge)
        with open(args.out, "w") as f:
            json.dump(report, f)
        print(f"REPORT WRITTEN {args.out}", flush=True)
        return report
    dev = resolve_device(args.device)
    skip = set(filter(None, args.skip.split(",")))
    caps = _caps(args.max_sweeps)
    chunks = {k: min(v[1], caps[k]) for k, v in RACES.items()}

    cache = args.cache or default_cache(args.pair)
    unary, D0, Q, alphas, kernel, tol = load_problem(args.pair, dev, cache)
    K, H, W = unary.shape
    print(f"problem: K={K} H={H} W={W} kernel={kernel} tol={tol}",
          flush=True)
    prob = (kernel, tol, unary, D0, Q, alphas)
    report = {"pair": args.pair, "K": K, "H": H, "W": W, "kernel": kernel,
              "tol": tol, "problem_sha": problem_sha(prob), "device": str(dev),
              "card": nvidia_smi() if dev.type == "cuda" else None,
              "launches": {}}

    target_e = args.target_e
    if "host" not in skip:
        report["host_orders"] = {}
        for order in args.host_order.split(","):
            print(f"host serial ({order})...", flush=True)
            host = run_host(*prob, args.host_maxiter, args.host_relgap,
                            order=order, band=args.band[0])
            print(f"host {order}: E={host['energy']:.8g} "
                  f"lb={host['lb']:.8g} iters={host['iters']} "
                  f"t={host['seconds']:.1f}s", flush=True)
            report["host_orders"][order] = host_summary(host, order)
            if "host" not in report:
                report["host"] = {k: v for k, v in report["host_orders"][
                    order].items() if k != "curve"}
                report["host_curve"] = {"e": host["trace_e"][::10],
                                        "s": host["trace_s"][::10]}
                if target_e is None:
                    target_e = host["energy"]
    report["target_e"] = target_e

    def race(key, name, messages=None, t_accum=0.0, **kw):
        schedule = "checkerboard" if key == "hier" else RACES[key][0]
        if messages is None:  # one chunk of the race's shape, off the clock
            run_device(*prob, schedule, chunks[key], chunks[key], None, **kw)
        print(f"{name} race...", flush=True)
        reset_counts()
        curve, _ = run_device(*prob, schedule, chunks[key], caps[key],
                              target_e, messages, t_accum, **kw)
        report["launches"][name] = read_counts()
        return curve

    for key in ("cb", "scan", "wf"):
        if key not in skip:
            report[RACES[key][0]] = race(key, RACES[key][0])
    if "banded" not in skip:
        report["banded"] = {str(b): race("banded", f"banded_{b}", band=b)
                            for b in args.band}
    if "hier" not in skip:
        print("hierarchy warm start...", flush=True)
        # the coarse shapes and the fine chunk, off the clock
        hierarchy_warm_start(*prob, coarse_sweeps=2, check_every=2)
        run_device(*prob, "checkerboard", chunks["hier"], chunks["hier"],
                   None)
        reset_counts()
        _sync(dev)
        t0 = time.perf_counter()
        messages = hierarchy_warm_start(*prob)
        _sync(dev)
        warm_t = time.perf_counter() - t0
        warm_counts = read_counts()
        print(f"  warm start took {warm_t:.2f}s", flush=True)
        report["hierarchy"] = race("hier", "hierarchy", messages, warm_t)
        report["hierarchy_warm_seconds"] = warm_t
        report["launches"]["hierarchy_warm_start"] = warm_counts
    finish(report)
    with open(args.out, "w") as f:
        json.dump(report, f)
    print(f"REPORT WRITTEN {args.out}", flush=True)
    return report


if __name__ == "__main__":
    main()
