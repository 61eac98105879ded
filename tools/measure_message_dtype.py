"""Energy and lower bound against sweeps with float32, bfloat16 and float16
message storage, on the TRW-S problems of chip_smoke.py: teddy NCC
K = 79 (the main path's model after its binary fusion sweep, restarted)
and baby2 K = 15 (the global model fused to convergence, restarted).

    python3 tools/measure_message_dtype.py [--pairs teddy baby2]
        [--sweeps 16 32 64 128 256 512 1024]

Needs one NVIDIA GPU.  For each problem and storage type, one TRWSRun on
the checkerboard schedule (compact, kernel 1) from zero messages, run in
chunks up to each of ``--sweeps`` with a decode every 16 sweeps; each
chunk's best decoded energy and its lower bound.  One JSON line per
problem and storage type, the card's name and power limit last.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402  (exits at once without a GPU)
from stereo_tpu_torch.models.ncc import grid_proposals  # noqa: E402
from stereo_tpu_torch.solvers import trws  # noqa: E402

STORAGE = (torch.float32, torch.bfloat16, torch.float16)
DECODE_EVERY = 16


def problem(pair: str):
    """(args, kw) of trws.solve for chip_smoke.py's problem of ``pair``."""
    if pair == "teddy":
        dm = cs.make_model()
        props = grid_proposals(dm, cs.GRID_STEP, cs.MAX_DISP)
        dm.binary_fusion_sweep(props, chunk=len(props))
    else:
        dm, _ = cs.make_global_model(pair)
        props = dm.segpln(seed=0)
        dm.binary_fuse_until_convergence(props, seed=0)
    dm.restart()
    return cs.model_problem(dm, props)


def trace(args, kw, m_dtype, marks) -> list:
    """[(sweeps, best energy of the chunk, lower bound)] at each mark."""
    run = trws.TRWSRun(*args, **kw, message_dtype=m_dtype)
    state, done, out = run.init_state(), 0, []
    for mark in marks:
        state, e, lb, _ = run.run(state, mark - done,
                                  decode_every=DECODE_EVERY)
        done = mark
        out.append((mark, float(e), float(lb)))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", nargs="*", default=["teddy", "baby2"])
    ap.add_argument("--sweeps", nargs="*", type=int,
                    default=[16, 32, 64, 128, 256, 512, 1024])
    args = ap.parse_args()
    smi = cs.nvidia_smi()
    for pair in args.pairs:
        t0 = time.perf_counter()
        pargs, kw = problem(pair)
        setup = time.perf_counter() - t0
        for m_dtype in STORAGE:
            t0 = time.perf_counter()
            rows = trace(pargs, kw, m_dtype, sorted(args.sweeps))
            print(json.dumps({
                "pair": pair, "K": pargs[0].shape[0],
                "storage": str(m_dtype).removeprefix("torch."),
                "decode_every": DECODE_EVERY, "setup_seconds": setup,
                "seconds": time.perf_counter() - t0,
                "sweeps_energy_lower_bound": rows}), flush=True)
        del pargs
        torch.cuda.empty_cache()
    print(smi, flush=True)


if __name__ == "__main__":
    main()
