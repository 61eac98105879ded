"""Typed configuration for the stereo engine.

Replaces the reference's three config mechanisms — ojw_default_options.m
(per-algorithm defaults struct), validating property setters
(dispmap_super.m:39-56), and the C++ MexParams key/value parser
(cpp/utils/mexutils.h:52-95) — with one frozen dataclass tree that is hashable
(usable as a jit static argument) and serializable with a run.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class SolverOptions:
    """Fusion / message-passing budgets (dispmap_super.m:8-13)."""

    maxiter: int = 1000
    max_relgap: float = 1e-4
    improve: bool = False  # run QPBO-I on unlabelled nodes (rd_mex.cpp:91-92)

    def __post_init__(self):
        if self.max_relgap < 0:
            raise ValueError("Maximum relative gap must be non-negative")


@dataclass(frozen=True)
class CVPR08Options:
    """The 'cvpr08' defaults of ojw_default_options.m:58-83 (used subset)."""

    disp_thresh: float = 0.02
    smoothness_kernel: int = 1  # 1: truncated linear, 2: truncated quadratic
    col_thresh: float = 30.0
    occl_const: float = 0.01  # occl_val = occl_const + log 2 (ojw_stereo.m:132)
    lambda_l: float = 9.0
    lambda_h: float = 108.0
    seg_params: tuple = (4, 5, 0)
    connect: int = 4
    improve: int = 4
    independent: bool = False  # merge regions before the choose_labels
    # splice (exact per-region flips) instead of strongly-connected regions
    # with lowest-region clique attribution (ojw_default_options.m:78)
    max_iters: int = 3000
    converge: float = 0.01
    average_over: int = 20
    window: int = 2
    visibility: bool = True
    planar: bool = True
    # stage codes for the full pipeline: SameUni, SegPln, Smooth*
    # (ojw_default_options.m:80); tuple of ints, [N,H,W] array, or callable
    proposal_method: tuple = (1, 2, 3)

    def __post_init__(self):
        if self.smoothness_kernel not in (1, 2):
            raise ValueError("smoothness_kernel must be 1 or 2")
        if self.connect not in (4, 8):
            raise ValueError("connect must be 4 or 8")


def cvpr08_options(**overrides) -> CVPR08Options:
    return dataclasses.replace(CVPR08Options(), **overrides)


@dataclass(frozen=True)
class CVPR07Options:
    """'cvpr07'/'edgemodes' rendering defaults (ojw_default_options.m:38-43);
    parameterizes the new-view-synthesis path (roadmapped)."""

    thresh: float = 50.0 / (3 ** 0.5)
    lam: float = 1.0
    connect: int = 8


@dataclass(frozen=True)
class BMVC07Options:
    """'bmvc07'/'occlrender' rendering defaults (ojw_default_options.m:44-57)."""

    col_thresh: float = 12.5
    disp_thresh: float = 1.9
    lam: float = 0.24
    tex_weight: float = 6.0
    tex_thresh: float = (5000.0 ** 0.5) / 2
    num_loops: int = 2
    smoothness_kernel: int = 1
    connect: int = 4
    contract: int = 0
    improve: int = 0
    visibility: bool = True


def default_options(algorithm: str):
    """The ojw_default_options dispatch (ojw_default_options.m:36-83)."""
    if algorithm in ("cvpr08", "stereo"):
        return CVPR08Options()
    if algorithm in ("cvpr07", "edgemodes"):
        return CVPR07Options()
    if algorithm in ("bmvc07", "occlrender"):
        return BMVC07Options()
    raise ValueError("Algorithm not recognised")
