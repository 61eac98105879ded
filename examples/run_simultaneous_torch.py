"""Simultaneous fusion on baby2 with the PyTorch / CUDA port — the
counterpart of examples/run_simultaneous.py (the example_simultaneous.m
equivalent, Fig. 4 of "Simultaneous Fusion Moves for 3D-Label Stereo"):
iterative binary fusion to convergence, then simultaneous TRW-S fusion of the
same 14 SegPln proposals from a restart.

    python3 examples/run_simultaneous_torch.py            # on the GPU
    python3 examples/run_simultaneous_torch.py --device cpu --pair synth \\
        --maxiter 16
    python3 examples/run_simultaneous_torch.py --trace simultaneous_trace.json

On the GPU the simultaneous phase runs the CUDA sweep kernels (float32).
"""

import argparse
import contextlib
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from examples.run_global_torch import build_model  # noqa: E402
from stereo_tpu_torch.utils import profiling  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pair", default="baby2")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--maxiter", type=int, default=3000)
    ap.add_argument("--schedule", default="banded",
                    choices=["checkerboard", "scanline", "wavefront",
                             "banded"])
    ap.add_argument("--band", type=int, default=128,
                    help="block size for --schedule banded")
    ap.add_argument("--max-relgap", type=float, default=1e-5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", metavar="PATH",
                    help="run the simultaneous fusion under torch.profiler, "
                         "write the chrome trace to PATH and print the "
                         "seconds in each of the program's spans")
    args = ap.parse_args()
    if args.dtype != "float32" and args.device != "cpu":
        ap.error("--dtype float64 needs --device cpu: the CUDA kernels of "
                 "the simultaneous phase take float32 only")

    dm = build_model(args.pair, args.dtype, args.seed, device=args.device)
    dm.schedule = args.schedule
    dm.band = args.band

    t0 = time.perf_counter()
    segplns = dm.segpln(seed=args.seed)
    print(f"{len(segplns)} SegPln proposals in {time.perf_counter()-t0:.2f}s")

    # iterative binary fusion until no proposal improves
    # (example_simultaneous.m:38)
    t0 = time.perf_counter()
    iters = dm.binary_fuse_until_convergence(segplns, seed=args.seed)
    e_iter = dm.energy()
    print(f"iterative fusion: E = {e_iter:.6g} "
          f"({iters} fusions, {time.perf_counter()-t0:.2f}s)")

    # simultaneous fusion from a restart (example_simultaneous.m:49-52)
    dm.restart()
    dm.maxiter = args.maxiter
    dm.max_relgap = args.max_relgap
    trace = (profiling.device_trace(args.trace) if args.trace
             else contextlib.nullcontext())
    t0 = time.perf_counter()
    with trace as prof:
        e_sim, lb, trws_iters = dm.simultaneous_fusion(segplns, verbose=True)
    dt = time.perf_counter() - t0
    print(f"simultaneous fusion: E = {e_sim:.6g} (lb {lb:.6g}, "
          f"{trws_iters} TRW-S iters, {dt:.2f}s)")
    print(f"simultaneous/iterative energy ratio: {e_sim/e_iter:.4f}")
    if prof is not None:
        for name, (s, n) in profiling.span_seconds(prof).items():
            print(f"{name:>18}: {s:8.3f} s in {n} spans")
    return dm


if __name__ == "__main__":
    main()
