"""Full plane-label proposal sweep on the bundled Middlebury pairs with the
PyTorch / CUDA port — the counterpart of examples/run_full_sweep.py.

binary_fuse_until_convergence over the 14 SegPln proposals on BOTH teddy and
baby2 with energy traces, followed by simultaneous fusion from a restart;
writes the traces (JSON) and the disparity-map renders per pair.

    python3 examples/run_full_sweep_torch.py                 # on the GPU
    python3 examples/run_full_sweep_torch.py --device cpu --pairs synth \\
        --maxiter-sim 16
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from stereo_tpu_torch.utils import viz  # noqa: E402
from examples.run_global_torch import build_model  # noqa: E402


def sweep_pair(name, dtype, seed, maxiter_sim, outdir, device):
    dm = build_model(name, dtype, seed, device=device)
    t0 = time.perf_counter()
    segplns = dm.segpln(seed=seed)
    print(f"[{name}] {len(segplns)} SegPln proposals "
          f"({time.perf_counter()-t0:.1f}s)")

    trace = {"pair": name, "iterative": [dm.energy()]}
    t0 = time.perf_counter()

    class Recorder:
        def __init__(self, dm):
            self.dm = dm
            self.orig = dm.binary_fusion

        def __call__(self, P):
            e, lb = self.orig(P)
            trace["iterative"].append(e)
            return e, lb

    dm.binary_fusion = Recorder(dm)
    n = dm.binary_fuse_until_convergence(segplns, seed=seed)
    dm.binary_fusion = dm.binary_fusion.orig
    e_iter = dm.energy()
    t_iter = time.perf_counter() - t0
    print(f"[{name}] iterative: E = {e_iter:.6g} "
          f"({n} fusions, {t_iter:.1f}s)")

    dm.restart()
    dm.maxiter = maxiter_sim
    dm.max_relgap = 1e-5
    sim_trace = []

    class T:
        def record(self, e, lb, **kw):
            sim_trace.append(dict(energy=e, lower_bound=lb, **kw))

    t0 = time.perf_counter()
    e_sim, lb, iters = dm.simultaneous_fusion(segplns, trace=T())
    t_sim = time.perf_counter() - t0
    print(f"[{name}] simultaneous: E = {e_sim:.6g} (lb {lb:.6g}, "
          f"{iters} sweeps, {t_sim:.1f}s); ratio {e_sim/e_iter:.4f}")

    trace.update(simultaneous=sim_trace, e_iter=e_iter, e_sim=e_sim,
                 lb=lb, t_iter=t_iter, t_sim=t_sim, fusions=n, sweeps=iters,
                 device=str(dm.device))
    viz.save_dispmap(os.path.join(outdir, f"{name}_disp.png"),
                     dm.current_dispmap() * dm.d_step, energy=e_sim)
    return trace


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", nargs="+", default=["teddy", "baby2"])
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--maxiter-sim", type=int, default=10000)
    ap.add_argument("--outdir", default=tempfile.gettempdir())
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    traces = [sweep_pair(p, args.dtype, args.seed, args.maxiter_sim,
                         args.outdir, args.device) for p in args.pairs]
    out = os.path.join(args.outdir, "full_sweep_traces.json")
    with open(out, "w") as f:
        json.dump(traces, f, indent=1)
    print("traces written to", out)
    for t in traces:
        if not t["e_sim"] <= t["e_iter"] * 1.02:
            raise SystemExit(f"{t['pair']}: simultaneous should not trail "
                             "iterative badly")


if __name__ == "__main__":
    main()
