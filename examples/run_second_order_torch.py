"""Second-order scalar-disparity stereo (the ojw_stereo pipeline core) with
the PyTorch / CUDA port — the counterpart of examples/run_second_order.py.

Runs the SecondOrderStereo model — scalar disparity per pixel, triple-clique
truncated second-derivative prior (4- or 8-connect), QPBO fusion with cubic
reduction and the geometric visibility model — through the
ojw_stereo_optim-style proposal schedule on a crop of a bundled pair.  The
images, the unary and curvature maps and the projections are on the device;
the fusion tables and the QPBO are on the host, so a crop keeps the runtime
interactive.

    python3 examples/run_second_order_torch.py               # on the GPU
    python3 examples/run_second_order_torch.py --device cpu --pair synth \\
        --crop 0 24 0 32 --max-disp 8 --iters 4
    python3 examples/run_second_order_torch.py --full        # SameUni ->
        # SegPln -> Smooth* (ojw_stereo.m:144-192); every fusion's field is
        # checkpointed through utils/checkpoint

A fusion that fails after the first is recorded by the model and ends its
loop; this script then exits non-zero.
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from stereo_tpu_torch.config import CVPR08Options  # noqa: E402
from stereo_tpu_torch.models.second_order import (  # noqa: E402
    SecondOrderStereo, ojw_stereo)
from stereo_tpu_torch.utils import io, viz  # noqa: E402
from stereo_tpu_torch.utils.checkpoint import Checkpointer  # noqa: E402


def raise_on_error(stage: str, info: dict):
    """A fusion failure is swallowed into ``info["error"]`` by the model;
    here it ends the run."""
    if info.get("error") is not None:
        raise RuntimeError(f"{stage}: a fusion failed") from info["error"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pair", default="teddy")
    ap.add_argument("--crop", type=int, nargs=4, default=[120, 240, 100, 280],
                    metavar=("Y0", "Y1", "X0", "X1"))
    ap.add_argument("--max-disp", type=int, default=14)
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--connect", type=int, default=4, choices=(4, 8))
    ap.add_argument("--kernel", type=int, default=1, choices=(1, 2))
    ap.add_argument("--no-visibility", action="store_true")
    ap.add_argument("--full", action="store_true",
                    help="run the full proposal_method pipeline")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "second_order_disp.png"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    pair = io.load_pair(args.pair)
    y0, y1, x0, x1 = args.crop
    crop = lambda im: im[y0:y1, x0:x1]
    P = pair.P.copy()
    P[1, 0, 3] = -0.25  # quarter-pixel shift per disparity unit (teddy)

    opts = CVPR08Options(
        connect=args.connect, smoothness_kernel=args.kernel,
        visibility=not args.no_visibility,
        max_iters=args.iters, average_over=min(4, args.iters),
        converge=0.0,
    )

    if args.full:
        ck = Checkpointer(os.path.join(os.path.dirname(args.out),
                                       "second_order_ckpt"), name="D")
        t0 = time.perf_counter()
        model, info = ojw_stereo(
            [crop(pair.images[0]), crop(pair.images[1])], P,
            (0, args.max_disp), 1, opts, seed=0, verbose=True,
            save_progress=lambda it, d: ck.save(it, {"D": d}),
            device=args.device,
        )
        ck.wait()
        dt = time.perf_counter() - t0
        for name, st in info["stages"].items():
            raise_on_error(f"stage {name}", st)
            es = st["energy"]
            print(f"stage {name}: E {es[0]:.6g} -> {es[-1]:.6g} "
                  f"({len(es)-1} fusions)")
        print(f"total: {dt:.1f}s; last field checkpointed in "
              f"{ck.directory} (steps {ck.steps()})")
        viz.save_dispmap(args.out, model.disp,
                         energy=info["stages"]["smooth_star"]["energy"][-1])
        print("disparity render:", args.out)
        return

    t0 = time.perf_counter()
    dm = SecondOrderStereo(
        [crop(pair.images[0]), crop(pair.images[1])], P,
        (0, args.max_disp), 1, opts, seed=0, device=args.device,
    )
    print(f"device {dm.device}; setup: {time.perf_counter()-t0:.1f}s; "
          f"initial E = {dm.energy():.6g}")

    t0 = time.perf_counter()
    info = {}
    energies = dm.optimize(
        schedule=("sweep_ftb", "smooth", "fronto", "random"),
        max_iters=args.iters, verbose=True, info=info,
    )
    raise_on_error("optimize", info)
    dt = time.perf_counter() - t0
    print(f"final E = {energies[-1]:.6g} after {len(energies)-1} fusions "
          f"({dt:.1f}s, {(len(energies)-1)/dt:.2f} moves/s); seconds a "
          f"fusion in terms / solve: {info['timings'].mean(axis=0)}")
    viz.save_dispmap(args.out, dm.disp, energy=energies[-1])
    print("disparity render:", args.out)


if __name__ == "__main__":
    main()
