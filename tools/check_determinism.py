"""Run-to-run differences on the card: the global model's initial energy
(DispMapGlobalStereo, CVPR08 defaults, seed 0, on a bundled pair), computed
twice in one process and once in each of two further processes, under
``torch.use_deterministic_algorithms(True)``; then twice more in one process
with the switch off.  Each run keeps the intermediates of that energy in
the order they are made (the images, the mean-shift segments, the smoothness
weights, the random start, its plane field, the unary and pairwise maps,
their sums and the energy), and the first of them that differs between two
runs is named.

    python3 tools/check_determinism.py [--pair teddy] [--device cuda]

Prints one JSON line per comparison (``first_difference``: the name of the
first intermediate that differs, or null; for each that differs, its
elements that differ and the largest difference) and a last line with the
verdict.  The child processes write their intermediates to a temporary
directory that is removed at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

# cuBLAS reads this when the card is first used; deterministic mode raises
# on a cuBLAS call without it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from stereo_tpu_torch import energy  # noqa: E402
from stereo_tpu_torch.config import CVPR08Options  # noqa: E402
from stereo_tpu_torch.models.global_stereo import (  # noqa: E402
    DispMapGlobalStereo)
from stereo_tpu_torch.utils import io  # noqa: E402


def intermediates(pair_name: str, device: str) -> dict:
    """{name: numpy array} of one computation of the initial energy, in the
    order the values are made."""
    pair = io.load_pair(pair_name, dtype=np.float32)
    dm = DispMapGlobalStereo(pair.images, pair.P, pair.disp_range,
                             pair.disparity_factor, CVPR08Options(), seed=0,
                             device=device)
    a = dm.assignment
    unary = dm.unary_map(a)
    pair_map = energy.pairwise_energy_map(a, dm.smooth_weights,
                                          dm.smoothness_kernel, dm.tol,
                                          dm.normalize)
    usum = unary.sum(dtype=torch.float32)
    psum = pair_map.sum(dtype=torch.float32)
    out = {"images": torch.stack(list(dm.images)),
           "segments": dm.segments,
           "smooth_weights": dm.smooth_weights,
           "start_disparity": dm.start_disparity,
           "assignment": a, "unary": unary, "pairwise_map": pair_map,
           "unary_sum": usum, "pairwise_sum": psum,
           "energy_sum": usum + psum,
           "stored_energy": np.float64(dm.energy())}
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in out.items()}


def compare(a: dict, b: dict) -> dict:
    """The first intermediate (in ``a``'s order) whose bits differ, and each
    difference."""
    diffs = {}
    for name, x in a.items():
        y = b[name]
        if x.shape != y.shape or x.dtype != y.dtype:
            diffs[name] = dict(shape=[x.shape, y.shape],
                               dtype=[str(x.dtype), str(y.dtype)])
            continue
        if x.tobytes() != y.tobytes():
            d = np.abs(x.astype(np.float64) - y.astype(np.float64))
            diffs[name] = dict(elements=int((x != y).sum()),
                               max_abs_diff=float(d.max()),
                               values=[float(x.ravel()[0]),
                                       float(y.ravel()[0])]
                               if x.size == 1 else None)
    return dict(first_difference=next(iter(diffs), None), differences=diffs)


def child(path: str, pair_name: str, device: str):
    torch.use_deterministic_algorithms(True)
    np.savez(path, **intermediates(pair_name, device))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pair", default="teddy")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.pair, args.device)
        return
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("check_determinism.py: no card; pass --device cpu")
    torch.use_deterministic_algorithms(True)
    runs = {"process0_run0": intermediates(args.pair, args.device),
            "process0_run1": intermediates(args.pair, args.device)}
    with tempfile.TemporaryDirectory() as d:
        for i in (1, 2):
            path = os.path.join(d, f"process{i}.npz")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--pair", args.pair, "--device", args.device,
                            "--child", path], check=True)
            with np.load(path) as z:
                runs[f"process{i}"] = {k: z[k] for k in runs[
                    "process0_run0"]}
    torch.use_deterministic_algorithms(False)
    runs["nondeterministic_run0"] = intermediates(args.pair, args.device)
    runs["nondeterministic_run1"] = intermediates(args.pair, args.device)
    pairs = [("process0_run0", "process0_run1"),
             ("process0_run0", "process1"), ("process1", "process2"),
             ("process0_run0", "nondeterministic_run0"),
             ("nondeterministic_run0", "nondeterministic_run1")]
    firsts = []
    for a, b in pairs:
        c = compare(runs[a], runs[b])
        firsts.append(c["first_difference"])
        print(json.dumps({"compare": [a, b], "pair": args.pair,
                          "device": args.device, **c}), flush=True)
    e = {k: float(r["stored_energy"]) for k, r in runs.items()}
    print(json.dumps({"verdict": "no intermediate differs" if not any(firsts)
                      else "differs", "first_differences": firsts,
                      "initial_energy": e}), flush=True)


if __name__ == "__main__":
    main()
