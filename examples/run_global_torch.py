"""Binary fusion of SegPln proposals on teddy with the PyTorch / CUDA port —
the counterpart of examples/run_global.py (the example_global.m equivalent,
Fig. 4b of "In Defense of 3D-Label Stereo").

    python3 examples/run_global_torch.py                 # on the GPU
    python3 examples/run_global_torch.py --device cpu --pair synth
    python3 examples/run_global_torch.py --trace global_trace.json

The first run on a GPU compiles the native segmentation into
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

from stereo_tpu_torch import geometry  # noqa: E402
from stereo_tpu_torch.config import CVPR08Options  # noqa: E402
from stereo_tpu_torch.models.global_stereo import (  # noqa: E402
    DispMapGlobalStereo)
from stereo_tpu_torch.utils import io, metrics, profiling  # noqa: E402


def build_model(pair_name, dtype, seed=0, kernel=1, device="cuda"):
    pair = io.load_pair(pair_name, dtype=np.dtype(dtype))
    options = CVPR08Options(smoothness_kernel=kernel)
    t0 = time.perf_counter()
    dm = DispMapGlobalStereo(
        pair.images, pair.P, pair.disp_range, pair.disparity_factor, options,
        seed=seed, device=device)
    print(f"device {dm.device}; setup (incl. segmentation weights): "
          f"{time.perf_counter()-t0:.2f}s; initial energy {dm.energy():.6g}")
    return dm


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pair", default="teddy")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", metavar="PATH",
                    help="run the fusion moves under torch.profiler, "
                         "write the chrome trace to PATH and print the "
                         "seconds in each of the program's spans")
    args = ap.parse_args()

    dm = build_model(args.pair, args.dtype, args.seed, device=args.device)

    t0 = time.perf_counter()
    segplns = dm.segpln(seed=args.seed)
    print(f"{len(segplns)} SegPln proposals in {time.perf_counter()-t0:.2f}s")

    trace = (profiling.device_trace(args.trace) if args.trace
             else contextlib.nullcontext())
    t0 = time.perf_counter()
    with trace as prof:
        for i, P in enumerate(segplns):
            e, lb = dm.binary_fusion(P)
            print(f"  SegPln {i+1}/{len(segplns)}: E = {e:.6g}")
    dt = time.perf_counter() - t0
    print(f"final energy {dm.energy():.6g} "
          f"({len(segplns)} fusions in {dt:.2f}s, {len(segplns)/dt:.2f} "
          "moves/s)")

    gt = io.load_ground_truth(args.pair)
    if gt is not None:
        d = geometry.own_disparity(dm.assignment).cpu().numpy()
        d = d / dm.disparity_factor
        rate = metrics.bad_pixel_rate(d, gt, threshold=1.0)
        print(f"bad-pixel rate (|err| > 1): {100 * rate:.2f}%")
    else:
        print("no GT disparities found (set STEREO_TPU_GT_DIR to enable "
              "bad-pixel %)")
    if prof is not None:
        for name, (s, n) in profiling.span_seconds(prof).items():
            print(f"{name:>18}: {s:8.3f} s in {n} spans")
    return dm


if __name__ == "__main__":
    main()
