"""What every kernel wrapper does around a launch: check the tensors it was
given, and raise when the launch is refused."""

from __future__ import annotations

import torch


def check_tensor(name: str, t: torch.Tensor, shape, device,
                 dtype=torch.float32):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: the CUDA kernels read raw pointers."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        what = "float32" if dtype == torch.float32 else str(dtype)
        raise ValueError(f"{name}: the CUDA kernel takes {what}, got "
                         f"{t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def launch_failed(fn: str, code: int):
    raise RuntimeError(f"{fn}: kernel launch refused (cudaError {code})")
