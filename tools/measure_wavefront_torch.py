"""Raster-wavefront TRW-S race: seconds and sweeps to a target energy on one
problem, optionally from a coarse-to-fine warm start (the counterpart of
tools/measure_wavefront.py).

    python3 tools/measure_wavefront_torch.py [--pair baby2] [--chunk 25]
        [--max-sweeps 800] [--target-e E | --report race_report.json]
        [--levels 3 --coarse-sweeps 200] [--out PATH]
    python3 tools/measure_wavefront_torch.py --device cpu --pair synth ...

The problem is tools/measure_race_torch.py's (cached under ``$TMPDIR``,
``--cache``).  The wavefront schedule is the host's raster order, sweep for
sweep; each sweep is one launch of the fused wavefront kernel (kernel 6).
With ``--levels`` above 1 the race starts from
solvers/hierarchy.py::wavefront_warm_start, whose coarse levels run kernel 6
at the coarse shapes (built off the clock first), and its seconds count.
The target comes from ``--target-e``, or from a race report's ``target_e``
(``--report``); with neither the race runs to ``--max-sweeps``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from stereo_tpu_torch.device import resolve_device  # noqa: E402
from stereo_tpu_torch.solvers import hierarchy  # noqa: E402
from tools.measure_race_torch import (  # noqa: E402
    _sync, default_cache, finish, load_problem, nvidia_smi, problem_sha,
    read_counts, reset_counts, run_device)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pair", default="baby2")
    ap.add_argument("--chunk", type=int, default=25)
    ap.add_argument("--max-sweeps", type=int, default=800)
    ap.add_argument("--target-e", type=float, default=None)
    ap.add_argument("--report", default=None,
                    help="a race report whose target_e is the target")
    ap.add_argument("--levels", type=int, default=1,
                    help="coarse-to-fine warm-start pyramid levels (1 = off)")
    ap.add_argument("--coarse-sweeps", type=int, default=200)
    ap.add_argument("--cache", default=None,
                    help="problem cache (default: tools/measure_race_torch.py"
                    "'s)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(
        tempfile.gettempdir(), "wavefront_race_torch.json"))
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    dev = resolve_device(args.device)
    target_e = args.target_e
    if target_e is None and args.report:
        with open(args.report) as f:
            target_e = json.load(f).get("target_e")
    unary, D0, Q, alphas, kernel, tol = load_problem(
        args.pair, dev, args.cache or default_cache(args.pair))
    K, H, W = unary.shape
    print(f"problem: K={K} H={H} W={W} kernel={kernel} tol={tol} "
          f"device={dev}", flush=True)
    prob = (kernel, tol, unary, D0, Q, alphas)
    kw = dict(kernel=kernel, tol=tol, levels=args.levels)

    # the first chunk builds the kernels and makes the first launches
    t0 = time.perf_counter()
    run_device(*prob, "wavefront", args.chunk, args.chunk, None)
    t_first = time.perf_counter() - t0
    print(f"first chunk ({args.chunk} sweeps) incl. build: {t_first:.1f}s",
          flush=True)

    messages, t_accum, warm_counts = None, 0.0, None
    if args.levels > 1:
        # the coarse shapes off the clock, then the timed warm start
        hierarchy.wavefront_warm_start(unary, D0, Q, alphas, coarse_sweeps=2,
                                       **kw)
        reset_counts()
        _sync(dev)
        t0 = time.perf_counter()
        messages = hierarchy.wavefront_warm_start(
            unary, D0, Q, alphas, coarse_sweeps=args.coarse_sweeps, **kw)
        _sync(dev)
        t_accum = time.perf_counter() - t0
        warm_counts = read_counts()
        print(f"warm start (levels={args.levels}, {args.coarse_sweeps} "
              f"coarse sweeps): {t_accum:.2f}s", flush=True)
    reset_counts()
    curve, _ = run_device(*prob, "wavefront", args.chunk, args.max_sweeps,
                          target_e, messages, t_accum)
    report = {"pair": args.pair, "K": K, "H": H, "W": W, "kernel": kernel,
              "tol": tol, "problem_sha": problem_sha(prob), "device": str(dev),
              "card": nvidia_smi() if dev.type == "cuda" else None,
              "target_e": target_e, "levels": args.levels,
              "coarse_sweeps": args.coarse_sweeps, "warm_seconds": t_accum,
              "first_chunk_seconds": t_first, "wavefront": curve,
              "launches": {"wavefront": read_counts(),
                           "wavefront_warm_start": warm_counts}}
    finish(report)
    with open(args.out, "w") as f:
        json.dump(report, f)
    print(f"REPORT WRITTEN {args.out}", flush=True)
    return report


if __name__ == "__main__":
    main()
