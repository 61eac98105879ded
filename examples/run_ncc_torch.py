"""NCC-unary demo on teddy with the PyTorch / CUDA port — the counterpart of
examples/run_ncc.py.

Builds the NCC model, generates RANSAC plane proposals on a 50-px grid plus a
fronto-parallel ladder, runs iterative binary fusion and then simultaneous
fusion from a restart, and reports both energies.

    python3 examples/run_ncc_torch.py                 # on the GPU
    python3 examples/run_ncc_torch.py --device cpu --max-disp 8 --maxiter 16
    python3 examples/run_ncc_torch.py --trace ncc_trace.json

The first run on a GPU compiles the CUDA kernels into
stereo_tpu_torch/build/ (a few seconds).
"""

import argparse
import contextlib
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from stereo_tpu_torch.models.ncc import (  # noqa: E402
    DispMapNCC, grid_proposals)
from stereo_tpu_torch.utils import io, profiling  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pair", default="teddy")
    ap.add_argument("--max-disp", type=int, default=50)
    ap.add_argument("--grid-step", type=int, default=50)
    ap.add_argument("--skip-simultaneous", action="store_true")
    ap.add_argument("--schedule", default="banded",
                    choices=["banded", "checkerboard", "wavefront",
                             "scanline"],
                    help="TRW-S schedule for the simultaneous phase "
                         "(banded|checkerboard|wavefront|scanline); banded "
                         "(blocked wavefront) is run_ncc.py's default")
    ap.add_argument("--maxiter", type=int, default=1000)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "float64"],
                    help="float64 on a GPU needs --skip-simultaneous: the "
                         "CUDA kernels of that phase are float32")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", metavar="PATH",
                    help="run the fusion phases under torch.profiler, "
                         "write the chrome trace to PATH and print the "
                         "seconds in each of the program's spans")
    args = ap.parse_args()
    if (args.dtype != "float32" and args.device != "cpu"
            and not args.skip_simultaneous):
        ap.error("--dtype float64 needs --device cpu or --skip-simultaneous: "
                 "the CUDA kernels of the simultaneous phase take float32 "
                 "only")

    np_dtype = np.dtype(args.dtype)
    pair = io.load_pair(args.pair, dtype=np_dtype)
    disparities = np.arange(0, args.max_disp + 1)
    tol = 8.0 * (disparities[1] - disparities[0])
    t0 = time.perf_counter()
    dm = DispMapNCC(pair.images, disparities, kernel=1, unary_weight=40.0,
                    tol=tol, maxiter=args.maxiter, schedule=args.schedule,
                    device=args.device)
    print(f"device {dm.device}; setup + NCC volume: "
          f"{time.perf_counter()-t0:.2f}s; initial energy {dm.energy():.6g}")

    # proposals: plane fits on a coarse grid plus a fronto-parallel ladder
    t0 = time.perf_counter()
    proposals = grid_proposals(dm, args.grid_step, args.max_disp)
    print(f"{len(proposals)} proposals in {time.perf_counter()-t0:.2f}s")

    trace = (profiling.device_trace(args.trace) if args.trace
             else contextlib.nullcontext())
    with trace as prof:
        fuse(dm, proposals, args)
    if prof is not None:
        for name, (s, n) in profiling.span_seconds(prof).items():
            print(f"{name:>18}: {s:8.3f} s in {n} spans")
    return dm


def fuse(dm, proposals, args):
    """Iterative binary fusion, then simultaneous fusion from a restart."""
    t0 = time.perf_counter()
    dm.binary_fusion_sweep(proposals, chunk=len(proposals))
    t_fuse = time.perf_counter() - t0
    single_energy = dm.energy()
    print(f"iterative fusion: E = {single_energy:.6g} "
          f"({len(proposals)} moves in {t_fuse:.2f}s, "
          f"{len(proposals)/t_fuse:.1f} moves/s)")

    if not args.skip_simultaneous:
        # simultaneous fusion from restart
        dm.restart()
        t0 = time.perf_counter()
        e, lb, iters = dm.simultaneous_fusion(proposals)
        print(f"simultaneous fusion: E = {e:.6g} (lb {lb:.6g}, "
              f"{iters} TRW-S iters, {time.perf_counter()-t0:.2f}s)")
        print(f"energy ratio simultaneous/iterative: {e/single_energy:.4f}")


if __name__ == "__main__":
    main()
