"""Skewing and the column sends of the wavefront family of TRW-S schedules
(port of the part of stereo_tpu/solvers/wavefront.py that solvers/banded.py
imports).

Under a wavefront order a node depends only on nodes of the previous
anti-diagonal, so one sweep walks anti-diagonals and updates all nodes of one
diagonal in parallel.  On *skewed* arrays (S[y, t] = A[y, t - y]) the
anti-diagonals are columns.  This module holds what the banded solver needs
of that machinery:

  - ``skew`` / ``unskew``;
  - ``_send_head`` / ``_send_tail``: the two message updates on column-shaped
    data ``[..., K, L]``, both through ``ops.minplus.minplus_send``;
  - the direction constants ``LT, RT, UP, DN`` and the groups ``GROUP_A`` =
    (RT, DN), written by a forward pass, and ``GROUP_B`` = (LT, UP), written
    by a backward pass.

Message and edge conventions are those of solvers/trws.py: buffer
``M[d][k]`` at pixel p holds the message on the edge (tail = p + DIRS[d] ->
head p); the potential is ``alpha * TR(|Q[d][k_tail] - D0[k_head]|)`` with
Q, D0 and alpha taken at the head.

The raster-order solver itself (``_Skewed``, ``decode_raster``,
``solve_wavefront``) comes with the port of its fused sweep kernel
(stereo_tpu/ops/wavefront_kernel.py); see ROADMAP.md.
"""

from __future__ import annotations

import torch

from stereo_tpu_torch.ops.minplus import minplus_send, minplus_send_ref

LT, RT, UP, DN = 0, 1, 2, 3
GROUP_A = (RT, DN)
GROUP_B = (LT, UP)


def skew(a: torch.Tensor, W: int) -> torch.Tensor:
    """[..., H, W] -> [..., H, T]: S[..., y, t] = A[..., y, t - y], zero
    where t - y is outside [0, W).  T = H + W - 1."""
    H = a.shape[-2]
    T = H + W - 1
    y = torch.arange(H, device=a.device)[:, None]
    t = torch.arange(T, device=a.device)[None, :]
    x = t - y
    valid = (x >= 0) & (x < W)
    idx = x.clamp(0, W - 1).expand(a.shape[:-1] + (T,))
    out = torch.gather(a, -1, idx)
    return torch.where(valid, out, torch.zeros((), dtype=a.dtype,
                                               device=a.device))


def unskew(s: torch.Tensor, W: int) -> torch.Tensor:
    """Inverse of skew: [..., H, T] -> [..., H, W]."""
    H = s.shape[-2]
    y = torch.arange(H, device=s.device)[:, None]
    x = torch.arange(W, device=s.device)[None, :]
    idx = (x + y).expand(s.shape[:-1] + (W,))
    return torch.gather(s, -1, idx)


def _send(use_kernel: bool):
    return minplus_send if use_kernel else minplus_send_ref


def _send_head(gD, Mold, Q, D0, alpha, kernel, tol, use_kernel=True):
    """Head-send: msg'[k_t] = min_{k_h}(gD[k_h] - Mold[k_h]
    + a TR(Q[k_t] - D0[k_h])).

    gD/Mold/Q/D0: [..., K, L] (leading axes broadcast); alpha: [..., L].
    Returns (message minus its minimum over k_t, that minimum)."""
    return _send(use_kernel)(gD - Mold, Q, D0, alpha, tol, kernel)


def _send_tail(gD_tail, Mold, Q, D0, alpha, kernel, tol, use_kernel=True):
    """Tail-send: msg'[k_h] = min_{k_t}(gD_tail[k_t] - Mold[k_t]
    + a TR(Q[k_t] - D0[k_h])).

    The targets are the heads, so D0 and Q change places in the send (TR is
    even: |D0 - Q| = |Q - D0| exactly, and so are their squares)."""
    return _send(use_kernel)(gD_tail - Mold, D0, Q, alpha, tol, kernel)
