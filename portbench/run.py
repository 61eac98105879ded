"""The benchmark of stereo_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout, on a machine with an NVIDIA GPU.  Prints,
as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; last, ``checks``: each number the comparison with the plain
reference judged, beside its limit.  The same numbers end standard error.
Exits non-zero without a result when there is no GPU, when the program is
not beside it, or when the process has loaded the JAX package or JAX.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# build and kernel caches at fixed places inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(ROOT, ".portbench_cache", sub)
# one thread for the host's numerical libraries: the load comes from one
# process, and the program's host work is Python launching device work
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch

    from portbench import harness

    spec = harness.load_spec()
    cell = harness.find(spec["workloads"], args.workload, "workload")
    chips = cell.get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "stereo_tpu_torch")):
        print("portbench: stereo_tpu_torch is not beside the benchmark",
              file=sys.stderr)
        return 2
    mine = {g: [m for m in spec[g]
                if args.workload in m.get("workloads", [args.workload])]
            for g in ("per_layer", "end_to_end")}
    out = harness.run_cell(
        cell, harness.config(cell["config"]), harness.traffic(cell["traffic"]),
        harness.limits(args.workload), seed=args.seed, seconds=args.seconds,
        trace=bool(args.trace), device="cuda", per_layer=mine["per_layer"],
        end_to_end=mine["end_to_end"], t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    ok = out.pop("_ok")
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if ok[name] else 'FAIL'}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
