"""Build the fused banded sweep kernel alone, hold it against its plain
version and time it: the short loop for work on csrc/banded_kernel.cu.

    python3 tools/time_banded_kernel.py

Needs one NVIDIA GPU and nvcc.  It builds only csrc/banded_kernel.cu, then
runs chip_smoke.py's own functions (no second copy of them):
``banded_sweep_vs_plain`` (every ``BANDED_CASES`` entry, both smoothness
kernels, from zero and from the warm state, bit for bit), the repeatability
check ``banded_sweep_repeatable`` (two sweeps from one state, same bits), and
``time_banded_sweep`` at teddy's shape, K = 79, and at K = 15 on 370 x 413,
the two shapes that split a step's fixed cost from its arithmetic (median of
12 sweeps each).  One JSON line per step; the card's name and power limit
last.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402  (exits at once without a GPU)
from stereo_tpu_torch.ops import _build  # noqa: E402


def main():
    smi = cs.nvidia_smi()
    t0 = time.perf_counter()
    _build.load("banded_kernel")
    log = _build.build_log.get("banded_kernel", {})
    cs.say("build", seconds=time.perf_counter() - t0,
           ptxas=[ln for ln in log.get("ptxas", "").splitlines()
                  if "registers" in ln or "spill" in ln])
    err = {"sweep_banded": 0.0}
    cases = cs.banded_sweep_vs_plain(err)
    cs.say("banded_vs_plain", cases=cases, max_abs_err=err["sweep_banded"])
    cs.banded_sweep_repeatable()
    cs.say("sweep_banded", card=smi,
           **cs.time_banded_sweep(79, 375, 450, 12, plain=False))
    cs.say("sweep_banded_k15", card=smi,
           **cs.time_banded_sweep(15, 370, 413, 12, plain=False))
    print(smi, flush=True)


if __name__ == "__main__":
    main()
