"""Where the main path's time goes on the GPU: a torch.profiler trace of a few
binary fusion moves and a few sweeps of simultaneous fusion on teddy K = 79.

    python3 tools/profile_main_path.py [--moves 3] [--sweeps 16]
                                       [--schedule checkerboard|banded|wavefront]

``--schedule`` picks the TRW-S schedule of the simultaneous-fusion window
(checkerboard: two launches of the compact phase kernel per sweep; banded:
one launch of the fused banded sweep kernel per sweep, 128 x 128 blocks;
wavefront: one launch of the fused raster-order sweep kernel per sweep).
For each of the two windows it prints one JSON line: host seconds (around a
synchronise), the sum of the device kernels' time, the device's busy share
(kernel time over host time), the number of kernel launches, and the kernels
that took most of the device time.  The last line is the card's name and
power limit.  Needs a GPU and nvcc; the profiler adds host time to every
launch, so read the shares, not the seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from stereo_tpu_torch.models.ncc import (  # noqa: E402
    DispMapNCC, grid_proposals)
from stereo_tpu_torch.ops import _build  # noqa: E402
from stereo_tpu_torch.utils import io  # noqa: E402


def traced(name: str, fn, top: int = 8) -> dict:
    """Run ``fn`` under the profiler and summarise the device's side."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    kernels = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            kernels.append((us, e.count, e.key))
    if not kernels:
        raise RuntimeError("the profiler recorded no device time")
    kernels.sort(reverse=True)
    device_s = sum(k[0] for k in kernels) * 1e-6
    row = dict(window=name, host_seconds=host_s, device_seconds=device_s,
               device_busy_share=device_s / host_s,
               launches=sum(k[1] for k in kernels),
               top=[dict(kernel=key[:60], ms=us * 1e-3, count=n)
                    for us, n, key in kernels[:top]])
    print(json.dumps(row), flush=True)
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--moves", type=int, default=3)
    ap.add_argument("--sweeps", type=int, default=16)
    ap.add_argument("--schedule", default="checkerboard",
                    choices=["checkerboard", "banded", "wavefront"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    _build.build_all()
    pair = io.load_pair("teddy", dtype=np.float32)
    dm = DispMapNCC(pair.images, np.arange(0, 51), kernel=1,
                    unary_weight=40.0, tol=8.0, maxiter=args.sweeps,
                    check_every=8, schedule=args.schedule, device="cuda")
    proposals = grid_proposals(dm)
    # warm up both windows outside the traces (allocator, kernel load)
    dm.binary_fusion_sweep(proposals[:1])
    dm.restart()
    traced("binary_fusion_sweep",
           lambda: dm.binary_fusion_sweep(proposals[:args.moves]))
    dm.restart()
    dm.simultaneous_fusion(proposals)
    dm.restart()
    traced(f"simultaneous_fusion[{args.schedule}]",
           lambda: dm.simultaneous_fusion(proposals))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())


if __name__ == "__main__":
    main()
