"""Woodford-unary disparity model, the dispmap_globalstereo equivalent (port
of stereo_tpu/models/global_stereo.py).

Unary from "Global stereo reconstruction under second-order smoothness
priors" (Woodford et al., PAMI 2009): projective warp + robust log kernel
(dispmap_globalstereo.m:355-375, 405).  Smoothness weights from mean-shift
segmentation: lambda_h inside a segment, lambda_l across boundaries, scaled by
num_images (preprocess, :377-414).  Pairwise terms act on disparities
normalized by (d - d_min)/d_step (:336-345).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from stereo_tpu_torch import geometry
from stereo_tpu_torch.config import CVPR08Options
from stereo_tpu_torch.device import DEFAULT_DEVICE
from stereo_tpu_torch.models.base import DispMap
from stereo_tpu_torch.ops import photo
from stereo_tpu_torch.proposals import segmentation, segpln as segpln_mod


class DispMapGlobalStereo(DispMap):
    def __init__(self, images, P, disp_range, disparity_factor,
                 options: CVPR08Options | None = None, *, seed: int = 0,
                 device=DEFAULT_DEVICE, **kw):
        options = options or CVPR08Options()
        super().__init__(images, options.smoothness_kernel, device=device,
                         **kw)
        self.options = options
        self.tol = float(options.disp_thresh)

        P = np.asarray(P, dtype=np.float64)  # [n_views, 3, 4]
        if np.abs(P[0] - np.eye(3, 4)).max() > 1e-12:
            raise ValueError("First image must be reference image")
        self.P = P
        self._P_other = torch.as_tensor(P[1], dtype=self.dtype,
                                        device=self.device)

        self.disp_range = tuple(disp_range)
        self.disparity_factor = int(disparity_factor)
        disps = np.arange(disp_range[0] * disparity_factor,
                          disp_range[1] * disparity_factor + 1)
        self.disps = np.sort(disps)[::-1].astype(np.float64)  # descending
        self.d_min = float(self.disps[-1])
        self.d_step = float(self.disps[0] - self.d_min)
        self.normalize = (self.d_min, self.d_step)

        self._preprocess()
        H, W = self.sz
        rng = np.random.default_rng(seed)
        self.start_disparity = torch.as_tensor(
            rng.random((H, W)) * self.d_step + self.d_min, dtype=self.dtype,
            device=self.device)
        self.restart()

    # -------------------------------------------------------------- setup
    def _preprocess(self):
        """Segmentation-modulated smoothness weights + kernel-2 rescaling
        (preprocess, dispmap_globalstereo.m:377-414)."""
        opts = self.options
        im_u8 = self.images[0].clamp(0, 255).cpu().numpy().astype(np.uint8)
        seg = segmentation.mean_shift(
            im_u8.astype(np.float64), int(opts.seg_params[0]),
            float(opts.seg_params[1]), int(opts.seg_params[2]),
            device=self.device)
        self._weights_from_segments(seg)
        self.improve = opts.improve > 0

    def _weights_from_segments(self, seg):
        """Smoothness weights from a segmentation [H, W]: the weight of the
        in-edge from the DIRS[d] neighbour is lambda_h when both pixels share
        a segment, else lambda_l (:399-403), times num_images /
        ((connect == 8) + 1); for the truncated quadratic the weights are
        divided by tol and tol squared (:410-413).  The kernel-2 rescale is
        applied to the options' tol, so the call may be repeated."""
        opts = self.options
        H, W = self.sz
        seg = np.asarray(seg)
        self.segments = seg
        scale = len(self.images) / ((opts.connect == 8) + 1)
        w = np.zeros((geometry.NUM_DIRS, H, W))
        for d, (dy, dx) in enumerate(geometry.DIRS):
            nbr = np.roll(seg, (-dy, -dx), axis=(0, 1))
            same = seg == nbr
            valid = geometry.valid_mask(H, W, d, device="cpu").numpy()
            w[d] = (same * opts.lambda_h + ~same * opts.lambda_l) * scale \
                * valid
        self.tol = float(opts.disp_thresh)
        if self.smoothness_kernel == 2:
            w = w / self.tol
            self.tol = self.tol ** 2
        self.smooth_weights = torch.as_tensor(w, dtype=self.dtype,
                                              device=self.device)

    def restart(self):
        """Reset to the (fixed) random initial field (:208-211, 347-353)."""
        self.assignment = geometry.plane_field_from_disparity(
            self.start_disparity)

    # -------------------------------------------------------------- unary
    def unary_map(self, planes: torch.Tensor) -> torch.Tensor:
        return self.unary_partial()(planes)

    def unary_partial(self):
        """The unary as a callable of a plane field (for fused sweeps)."""
        return functools.partial(
            unary_pure, self.images[0], self.images[1], self._P_other,
            float(self.options.col_thresh), self.d_min, self.d_step)

    # ---------------------------------------------------------- proposals
    def segpln(self, seed: int = 0) -> list[torch.Tensor]:
        """14 segmentation-driven piecewise-planar proposals (:60-201)."""
        props = segpln_mod.segpln(
            self.images, [self.P[i] for i in range(len(self.images))],
            self.disps, self.options.col_thresh, self.options.window,
            seed=seed, device=self.device)
        return [self._tensor(p) for p in props]


def unary_pure(im_ref, im_other, P_other, col_thresh, d_min, d_step, planes):
    """The Woodford unary of a plane field [4, H, W] -> [H, W]."""
    return photo.unary_cost(planes, im_ref, im_other, P_other, col_thresh,
                            d_min=d_min, d_step=d_step)
