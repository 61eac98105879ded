"""Multi-pair pooled simultaneous fusion over a device mesh with the PyTorch
/ CUDA port — the counterpart of examples/run_batch.py.

The "high-res multi-pair batch" configuration (BASELINE.json configs[4]):
several same-shaped stereo problems streamed through ``--batch`` slots of a
('batch', 'x') mesh (parallel/batch.py: per-pair convergence and eviction),
each pair's columns over ``--shards`` shards of its row.  Each pair fuses a
fronto-parallel ladder (every 6 disparities) with checkerboard TRW-S,
checking the stopping rule every 25 sweeps.

    python3 examples/run_batch_torch.py                       # on the GPU
    python3 examples/run_batch_torch.py --pairs teddy teddy teddy --shards 3
    python3 examples/run_batch_torch.py --device cpu --max-disp 6 --maxiter 20

Shards and slots share the visible cards when there are fewer cards than
batch x shards.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from stereo_tpu_torch import geometry  # noqa: E402
from stereo_tpu_torch.device import resolve_device  # noqa: E402
from stereo_tpu_torch.models.ncc import DispMapNCC  # noqa: E402
from stereo_tpu_torch.parallel import batch as batch_mod  # noqa: E402
from stereo_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from stereo_tpu_torch.utils import io  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", nargs="+", default=["teddy", "teddy"])
    ap.add_argument("--max-disp", type=int, default=30)
    ap.add_argument("--maxiter", type=int, default=200)
    ap.add_argument("--check-every", type=int, default=25)
    ap.add_argument("--batch", type=int, default=2,
                    help="slots of the pool (mesh rows)")
    ap.add_argument("--shards", type=int, default=1,
                    help="column shards of each pair (mesh columns)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build(args):
    """The mesh, the models and their proposal ladders."""
    dev = resolve_device(args.device)
    n = args.batch * args.shards
    if dev.type == "cuda":
        cards = mesh_mod.visible_devices()
        devices = [cards[i % len(cards)] for i in range(n)]
    else:
        devices = [dev] * n
    mesh = mesh_mod.make_mesh(n, batch=args.batch, devices=devices)
    disparities = np.arange(0, args.max_disp + 1)
    models = []
    for name in args.pairs:
        pair = io.load_pair(name, dtype=np.float32)
        models.append(DispMapNCC(pair.images, disparities, kernel=1,
                                 unary_weight=40.0, tol=8.0, device=dev))
    H, W = models[0].sz
    props = [[geometry.fronto_parallel(H, W, float(d), m.dtype, device=dev)
              for d in range(0, args.max_disp + 1, 6)] for m in models]
    return mesh, models, props


def run(args, mesh, models, props):
    """The pool over the mesh, with its progress and summary printed.
    -> (per-pair results, seconds)."""
    devices = sorted({str(d) for row in mesh.devices for d in row})
    print(f"mesh: {mesh.shape} on {devices}")
    H, W = models[0].sz
    t0 = time.perf_counter()
    out = batch_mod.simultaneous_fusion_pool(
        models, props, mesh, maxiter=args.maxiter, max_relgap=1e-4,
        check_every=args.check_every,
        on_progress=lambda i, r: print(
            f"  pair {i} ({args.pairs[i]}): {r['status']} after "
            f"{r['iterations']} sweeps, E = {r['energy']:.6g}"))
    dt = time.perf_counter() - t0
    total_iters = 0
    for name, r in zip(args.pairs, out):
        e = "none" if r["energy"] is None else f"{r['energy']:.6g}"
        print(f"{name}: E = {e}, lb = {r['lower_bound']}, "
              f"iters = {r['iterations']} ({r['status']})")
        total_iters += r["iterations"]
    print(f"pooled fusion: {dt:.2f}s for {len(models)} pairs "
          f"({H * W * total_iters / dt / 1e6:.1f} Mpixel-iters/s)")
    return out, dt


def main(argv=None):
    args = parse(argv)
    return run(args, *build(args))


if __name__ == "__main__":
    main()
