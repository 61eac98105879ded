"""Windowed filters: zero-padded box sums and means, the moving average of
one axis and the 'valid' separable average (port of
stereo_tpu/ops/filters.py).

Written as shifted adds, not as a convolution: a float32 convolution on a
CUDA device runs through cuDNN in TF32 by default and the cost volume would
lose digits.  The new averages divide by a tensor, not by a Python number:
on a CUDA tensor PyTorch turns a division by a Python number into a
multiplication by its reciprocal, which can differ in the last bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def box_sum(x, radius: int, axes=(-2, -1)):
    """Sum over a (2r+1)^2 window, zero padding — conv2(x, ones, 'same').

    x: [..., H, W]; one pass of 2r+1 shifted adds per axis."""
    k = 2 * radius + 1
    for ax in axes:
        a = ax % x.ndim
        n = x.shape[a]
        pad = [0, 0] * (x.ndim - a - 1) + [radius, radius]
        xp = F.pad(x, pad)
        acc = xp.narrow(a, 0, n)
        for s in range(1, k):
            acc = acc + xp.narrow(a, s, n)
        x = acc
    return x


def box_mean(x, radius: int, axes=(-2, -1)):
    """Mean with *constant* divisor (2r+1)^2 (zero padding, no
    renormalization)."""
    k = 2 * radius + 1
    return box_sum(x, radius, axes) / (k * k)


def _div(x, c: float):
    """x / c as an IEEE division on every device (see the module note)."""
    return x / x.new_full((), c)


def separable_average_1d(x, radius: int, axis: int):
    """1-D moving average of width 2r+1 (fspecial('average',[1 w]) conv),
    zero-padded 'same'; shifted adds, left to right."""
    k = 2 * radius + 1
    a = axis % x.ndim
    n = x.shape[a]
    xp = F.pad(x, [0, 0] * (x.ndim - a - 1) + [radius, radius])
    acc = xp.narrow(a, 0, n)
    for s in range(1, k):
        acc = acc + xp.narrow(a, s, n)
    return _div(acc, k)


def valid_average_2d(x, radius: int):
    """Separable (2r+1) x (2r+1) average with 'valid' extent:
    conv2(filt, filt', x, 'valid') of ojw_segpln.m:101.
    x: [..., H, W] -> [..., H-2r, W-2r].

    The (2r+1)^2 window is summed one shifted add at a time in row-major
    order, the order of a window reduction on the CPU."""
    k = 2 * radius + 1
    H, W = x.shape[-2:]
    h, w = H - k + 1, W - k + 1
    acc = x[..., :h, :w]
    for i in range(k):
        for j in range(k):
            if i or j:
                acc = acc + x[..., i:i + h, j:j + w]
    return _div(acc, k * k)
