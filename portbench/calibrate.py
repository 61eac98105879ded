"""The readings that the limits of a cell's comparison are set from: the
program's numbers on many seeds and the control's on a few, at the cell's
own size, in one process.  The benchmark's own runs do not run this.

    python3 portbench/calibrate.py --workload <cell> --seeds 12 \
        --control-seeds 3 [--first-seed N] [--out FILE]

Each seed runs one job of the cell's mix and is judged by check.judge; one
JSON line a job, with the model's raw readings (its ``readings``) and, for
a solve, the certified bound.  The control is the reference put in the
program's place in the next precision down, as the configuration's model
states it (its ``control``; portbench/models/<model>.py).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    from portbench import check, harness

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None

    def say(**kw):
        line = json.dumps(kw)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    spec = harness.load_spec()
    cell = harness.find(spec["workloads"], args.workload, "workload")
    cfg = harness.config(cell["config"])
    mix = harness.traffic(cell["traffic"])
    ims = harness.images(cfg)
    model = harness.model_kind(cfg["model"])
    from stereo_tpu_torch.ops import _build
    _build.build_all()
    ref = model.Reference(cfg, ims, "cuda")
    sides = [("program", None, args.seeds),
             ("control", model.control(ref), args.control_seeds)]
    for side, control, n in sides:
        prog = harness.Program(cfg, mix, ims, "cuda", control=control)
        prog.warm_up()
        for i in range(n):
            seed = args.first_seed + i
            prog.set_seed(seed)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            job = prog.run()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            t1 = time.perf_counter()
            view = prog.view()
            numbers, _ = check.judge(ref, model, prog.kind, prog.order, view,
                                     [job])
            lb_ref = (prog.kind.certified_bound(ref, view, job["messages"])
                      if job.get("messages") is not None else None)
            say(cell=args.workload, side=side, seed=seed, job_s=dt,
                judge_s=time.perf_counter() - t1,
                sweeps=job.get("sweeps"), moves=job.get("moves"),
                energy=job["energy"], bound=job.get("bound"),
                certified_bound=lb_ref, energy_ref=ref.energy(job["planes"]),
                numbers=numbers, **model.readings(ref, view, prog.order))
        del prog
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
