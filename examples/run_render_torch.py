"""New-view synthesis on a bundled stereo pair with the PyTorch / CUDA port
(the imrender IBR toolbox) — the counterpart of examples/run_render.py.

Synthesizes the middle view between the two cameras of a bundled pair with
both renderers:

  edgemodes — CVPR'07 pairwise-dictionary-prior renderer
              (ibr_edgemodes.m: truncquad colour modes + TRW-S over
              per-pixel mode sets), all on the device;
  occl      — BMVC'07 occlusion-aware renderer (ibr_occlrender.m: explicit
              depth sweep, QPBO fusion with visibility-node cliques), the
              projections on the device, the cliques and QPBO on the host.

The pair's P convention (utils/io): view 2 at u = x + P(1,4,2) * d_raw; the
middle output view puts the inputs at +/- half that parallax.  A crop keeps
the occl renderer's host-side clique assembly interactive.  The images are
written with the port's own PNG encoder (utils/io.write_png).

    python3 examples/run_render_torch.py                     # on the GPU
    python3 examples/run_render_torch.py --device cpu --crop 120 150 120 160 \\
        --levels 4
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from stereo_tpu_torch.render import OcclRenderOptions, render_occl  # noqa: E402
from stereo_tpu_torch.render.edgemodes import render_edgemodes  # noqa: E402
from stereo_tpu_torch.utils import io  # noqa: E402


def middle_view_P(disp_factor):
    """[2, 3, 4] projections of the two inputs relative to the middle view."""
    P = np.zeros((2, 3, 4))
    for i, s in enumerate((+0.5, -0.5)):
        P[i, :3, :3] = np.eye(3)
        P[i, 0, 3] = s * disp_factor
    return P


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pair", default="teddy")
    ap.add_argument("--crop", type=int, nargs=4, default=[120, 240, 120, 280],
                    metavar=("Y0", "Y1", "X0", "X1"))
    ap.add_argument("--levels", type=int, default=9)
    ap.add_argument("--renderer", choices=("edgemodes", "occl", "both"),
                    default="both")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "render"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    pair = io.load_pair(args.pair, dtype=np.float32)
    y0, y1, x0, x1 = args.crop
    views = [im[y0:y1, x0:x1] for im in pair.images]
    sz = views[0].shape[:2]
    # raw disparity range from the pair metadata (teddy: 0..59 * factor 4)
    d_max = float(pair.disp_range[1] * pair.disparity_factor)
    P = middle_view_P(abs(pair.P[1, 0, 3]))
    disps = np.linspace(d_max, 0.0, args.levels)

    def save(path, img):
        io.write_png(path, img)
        print(f"  wrote {path}")

    if args.renderer in ("edgemodes", "both"):
        t0 = time.time()
        res = render_edgemodes(views, P, disps, sz, lam=20.0, thresh=30.0,
                               max_modes=6, maxiter=60, device=args.device)
        img = np.clip(res.image.cpu().numpy(), 0, 255).astype(np.uint8)
        print(f"edgemodes: E={res.energy:.1f} lb={res.lower_bound:.1f} "
              f"{time.time() - t0:.1f}s")
        save(f"{args.out}_edgemodes.png", img)

    if args.renderer in ("occl", "both"):
        t0 = time.time()
        res = render_occl(views, P, disps, sz,
                          OcclRenderOptions(col_thresh=30.0, lambda_=0.02,
                                            num_loops=1, visibility=True),
                          device=args.device)
        img = np.clip(res.image, 0, 255).astype(np.uint8)
        print(f"occl: E_last={res.energies[-1]:.1f} "
              f"unlabelled={sum(res.unlabelled)} "
              f"vis={res.visibility.mean():.3f} {time.time() - t0:.1f}s")
        save(f"{args.out}_occl.png", img)


if __name__ == "__main__":
    main()
