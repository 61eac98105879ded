"""Build one fused sweep kernel alone, hold it against its plain version and
time it: the short loop for work on csrc/banded_kernel.cu (kernel 5, the
default) or csrc/wavefront_kernel.cu (kernel 6).

    python3 tools/time_banded_kernel.py [--kernel banded|wavefront]

Needs one NVIDIA GPU and nvcc.  It builds only the kernel's source, then
runs chip_smoke.py's own functions (no second copy of them):
``banded_sweep_vs_plain`` / ``wavefront_sweep_vs_plain`` (every
``BANDED_CASES`` / ``WAVEFRONT_CASES`` entry, both smoothness kernels, from
zero and from the warm state, bit for bit), the repeatability check
``banded_sweep_repeatable`` / ``wavefront_sweep_repeatable`` (two sweeps
from one state, same bits), and ``time_banded_sweep`` /
``time_wavefront_sweep`` at teddy's shape, K = 79, and at K = 15 on
370 x 413, the two shapes that split a step's fixed cost from its
arithmetic (median of 12 sweeps each); the wavefront kernel also at teddy's
K = 202 (median of 4).  One JSON line per step, the build's with ptxas's
registers and spills per entry function; the card's name and power limit
last.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402  (exits at once without a GPU)
from stereo_tpu_torch.ops import _build  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("banded", "wavefront"),
                    default="banded")
    kind = ap.parse_args().kernel
    smi = cs.nvidia_smi()
    source = f"{kind}_kernel"
    t0 = time.perf_counter()
    _build.load(source)
    log = _build.build_log.get(source, {})
    cs.say("build", source=source, seconds=time.perf_counter() - t0,
           ptxas=cs.ptxas_by_function(log.get("ptxas", "")))
    name = f"sweep_{kind}"
    err = {name: 0.0}
    if kind == "banded":
        cases = cs.banded_sweep_vs_plain(err)
        cs.say("banded_vs_plain", cases=cases, max_abs_err=err[name])
        cs.banded_sweep_repeatable()
        timed = [("", 79, 375, 450, 12), ("_k15", 15, 370, 413, 12)]
        time_sweep = cs.time_banded_sweep
    else:
        cases = cs.wavefront_sweep_vs_plain(err)
        cs.say("wavefront_vs_plain", cases=cases, max_abs_err=err[name])
        cs.wavefront_sweep_repeatable()
        timed = [("", 79, 375, 450, 12), ("_k15", 15, 370, 413, 12),
                 ("_k202", cs.K_WIDE, 375, 450, 4)]
        time_sweep = cs.time_wavefront_sweep
    for suffix, K, H, W, reps in timed:
        cs.say(name + suffix, card=smi,
               **time_sweep(K, H, W, reps, plain=False))
    print(smi, flush=True)


if __name__ == "__main__":
    main()
