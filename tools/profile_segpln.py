"""Where SegPln's seconds go on the GPU machine: the RSSD volume on the card,
its copy to the host, the WTA, and each of the 14 segmentations and plane
fits, one after another; then the whole ``segpln`` call with one worker and
with its default pool.

    python3 tools/profile_segpln.py [--pairs teddy baby2]

One JSON line a pair, then the card's name and power limit.  Needs a GPU.
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

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from stereo_tpu_torch.ops import photo  # noqa: E402
from stereo_tpu_torch.proposals import segmentation, segpln  # noqa: E402
from stereo_tpu_torch.utils import io  # noqa: E402

COL_THRESH, WINDOW = 30.0, 2  # CVPR08Options' col_thresh and window


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def profile_pair(name: str, dev) -> dict:
    pair = io.load_pair(name, dtype=np.float32)
    lo, hi = pair.disp_range
    f = pair.disparity_factor
    disps = np.arange(lo * f, hi * f + 1)[::-1].astype(np.float64)
    ims = [torch.as_tensor(im, device=dev) for im in pair.images]
    Ps = [torch.as_tensor(p, dtype=torch.float32, device=dev)
          for p in pair.P]
    timed(lambda: photo.rssd_volume(ims, Ps, disps[:16], COL_THRESH, WINDOW))
    corr, t_vol = timed(lambda: photo.rssd_volume(ims, Ps, disps, COL_THRESH,
                                                  WINDOW))
    host, t_copy = timed(lambda: corr.cpu().numpy())
    disp, t_wta = timed(lambda: segpln.wta_disparity(host, disps, WINDOW))
    rows = []
    for b, mult in enumerate(segpln.MULTS):
        sp = segpln.SEGMENT_PARAMS * mult
        if b < segpln.N_MEAN_SHIFT:
            labels, t_seg = timed(lambda: segmentation.mean_shift(
                pair.images[0], int(sp[0]), float(sp[1]), int(sp[2]),
                device=dev))
        else:
            labels, t_seg = timed(lambda: segmentation.felzenszwalb(
                pair.images[0], 0.0, float(sp[3]), int(sp[2])))
        rng = np.random.default_rng(np.random.SeedSequence((0, b)))
        _, t_fit = timed(lambda: segpln.fit_segment_planes(disp, labels,
                                                           rng=rng))
        rows.append(dict(b=b, segments=int(len(np.unique(labels))),
                         segmentation_seconds=t_seg, fit_seconds=t_fit))
    whole = {}
    for workers in (1, None):
        _, secs = timed(lambda: segpln.segpln(
            pair.images, list(pair.P), disps, COL_THRESH, WINDOW, seed=0,
            workers=workers, device=dev))
        whole["default" if workers is None else str(workers)] = secs
    return dict(pair=name, volume_shape=list(corr.shape),
                volume_seconds=t_vol, copy_seconds=t_copy, wta_seconds=t_wta,
                segmentation_seconds=sum(r["segmentation_seconds"]
                                         for r in rows),
                fit_seconds=sum(r["fit_seconds"] for r in rows),
                segpln_seconds_by_workers=whole,
                default_workers=max(1, min(8, (os.cpu_count() or 2) - 1)),
                rows=rows)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", nargs="+", default=["teddy", "baby2"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_segpln.py needs a GPU")
    dev = torch.device("cuda")
    for name in args.pairs:
        print(json.dumps(profile_pair(name, dev)), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
