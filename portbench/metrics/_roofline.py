"""Least time of a TRW-S sweep's work on one NVIDIA H100, from the problem's
sizes alone: the yardstick of the roofline and bound shares.

Frozen here so that a later change to the program cannot move it.  The work
counted is the algorithm's, not a kernel's: a sweep of sequential TRW-S
over an H x W grid with K labels sends 8 messages a pixel (4 edges, both
passes), each a K x K min-plus of six float32 operations a term (sub,
abs|mul, min, mul, add, min), and moves each pixel's arrays once: theta,
D0 (K floats each), the two neighbour-position groups (2 K each) and ten
scalars read, the two message groups (2 K each) read and written.
"""

from __future__ import annotations

# published peaks of one H100 SXM (NVIDIA data sheet, 700 W): HBM bytes/s,
# float32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
OPS_PER_STEP = 6


def bound_of(n_bytes: float, n_ops: float) -> dict:
    """Least seconds for work that moves ``n_bytes`` once and does ``n_ops``
    float32 operations: the larger of the two at the published peaks, and
    which of them it is."""
    bytes_s = n_bytes / PEAK_BYTES
    ops_s = n_ops / PEAK_F32
    return dict(bytes_s=bytes_s, ops_s=ops_s, bound_s=max(bytes_s, ops_s),
                bound_by="bytes" if bytes_s >= ops_s else "operations")


def sweep_bounds(K: int, pixels: int) -> dict:
    """Least time of one TRW-S sweep of ``pixels`` nodes with K labels."""
    return bound_of(pixels * (14 * K + 10) * 4,
                    8 * pixels * K * K * OPS_PER_STEP)
