"""Coarse-to-fine warm starting for the TRW-S solvers (port of
stereo_tpu/solvers/hierarchy.py).

The checkerboard schedule propagates information one pixel per sweep; on
large grids the dual variables need many sweeps to carry long-range context.
Classic multigrid fix: build a pyramid of coarsened problems (2x2 pixel
blocks; labels are global proposals so the label set is unchanged), run the
solver coarse-to-fine, and upsample the converged messages as the warm start
of the next level.  The warm start is *only* an initializer — any message
state is a valid dual point — so the fine-level bound and stopping rule keep
their exact TRW-S semantics.

STATUS: EXPERIMENTAL — no regime where the pyramid pays has been found.  The
upsampled coarse messages bias the fine dual toward block-constant splits
that the fine schedule must first undo.  Correctness is unaffected; kept as
a recorded experiment, not a production path.

Coarsening rules: unaries are summed over each block (a block acts as one
pixel taking one label), positions are averaged, directed-edge weights sum
the parallel boundary edges of the block pair.  Messages upsample by
replication scaled by 1/2 per parallel-edge split so dual magnitudes stay
balanced.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stereo_tpu_torch import geometry
from stereo_tpu_torch.solvers import trws, wavefront
from stereo_tpu_torch.solvers.trws import TRWSResult


def _pool_sum(x, f):
    """Sum over f x f blocks of the last two axes (shape must divide)."""
    shape = x.shape[:-2] + (x.shape[-2] // f, f, x.shape[-1] // f, f)
    return x.reshape(shape).sum(dim=(-3, -1))


def _crop_to_multiple(x, f):
    H, W = x.shape[-2:]
    return x[..., : H - H % f, : W - W % f]


def coarsen(unary, D0, Q, alphas, f: int = 2):
    """One pyramid level: [K, H, W] fields -> [K, H//f, W//f]."""
    unary_c = _pool_sum(_crop_to_multiple(unary, f), f)
    D0_c = _pool_sum(_crop_to_multiple(D0, f), f) / (f * f)
    Q_c = _pool_sum(_crop_to_multiple(Q, f), f) / (f * f)
    alphas_c = _pool_sum(_crop_to_multiple(alphas, f), f) / f
    # zero the coarse border in-edges that no longer exist
    Hc, Wc = unary_c.shape[-2:]
    valid = torch.stack(
        [geometry.valid_mask(Hc, Wc, d, dtype=unary.dtype,
                             device=unary.device) for d in range(4)], 0)
    return unary_c, D0_c, Q_c, alphas_c * valid


def upsample_messages(messages, target_hw, f: int = 2):
    """[4, K, Hc, Wc] -> [4, K, H, W] by replication, halved per split edge."""
    up = messages.repeat_interleave(f, dim=-2).repeat_interleave(f, dim=-1) / f
    H, W = target_hw
    pad_h = H - up.shape[-2]
    pad_w = W - up.shape[-1]
    if pad_h or pad_w:
        up = F.pad(up, (0, pad_w, 0, pad_h))
    return up


def _pyramid(unary, D0, Q, alphas, levels: int):
    """The problem and up to ``levels - 1`` coarsenings of it, finest first;
    a level whose shorter side is under 16 pixels is not coarsened."""
    pyramid = [(unary, D0, Q, alphas)]
    for _ in range(levels - 1):
        if min(pyramid[-1][0].shape[-2:]) < 16:
            break
        pyramid.append(coarsen(*pyramid[-1]))
    return pyramid


def solve_hierarchical(
    unary, D0, Q, alphas, *, kernel, tol, maxiter=1000, max_relgap=1e-4,
    levels: int = 3, coarse_sweeps: int = 300, check_every: int = 8,
    use_kernel: bool = True,
) -> TRWSResult:
    """Pyramid warm start + exact fine-level solve with the checkerboard
    solver (same contract as trws.solve)."""
    pyramid = _pyramid(unary, D0, Q, alphas, levels)
    kw = dict(kernel=kernel, tol=tol, max_relgap=max_relgap,
              check_every=check_every, use_kernel=use_kernel)
    messages = None
    for lvl in range(len(pyramid) - 1, 0, -1):
        res = trws.solve(*pyramid[lvl], maxiter=coarse_sweeps,
                         messages=messages, **kw)
        target_hw = pyramid[lvl - 1][0].shape[-2:]
        messages = upsample_messages(res.messages, target_hw)
    return trws.solve(*pyramid[0], maxiter=maxiter, messages=messages, **kw)


def wavefront_warm_start(
    unary, D0, Q, alphas, *, kernel, tol, levels: int = 3,
    coarse_sweeps: int = 200, use_kernel: bool = True,
):
    """Coarse-to-fine warm start for the *wavefront* (raster-order) solver:
    solve the coarsened pyramid with wavefront sweeps and return upsampled
    fine-level messages [4, K, H, W] (None if the problem is too small to
    coarsen).

    The raster schedule already mixes along whole rows and columns per
    sweep, so it needs far fewer sweeps than the checkerboard — but each fine
    sweep is T sequential diagonals; a few quarter-size coarse sweeps stand
    in for most of them.  Like solve_hierarchical, the result is only an
    initializer: the fine solve keeps exact TRW-S semantics and bounds."""
    pyramid = _pyramid(unary, D0, Q, alphas, levels)
    messages = None
    for lvl in range(len(pyramid) - 1, 0, -1):
        res = wavefront.solve_wavefront(
            *pyramid[lvl], kernel=kernel, tol=tol, maxiter=coarse_sweeps,
            max_relgap=1e-12, messages=messages, check_every=coarse_sweeps,
            use_kernel=use_kernel)
        target_hw = pyramid[lvl - 1][0].shape[-2:]
        messages = upsample_messages(res.messages, target_hw)
    return messages
