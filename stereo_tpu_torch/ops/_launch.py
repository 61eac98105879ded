"""What every kernel wrapper does around a launch: check the tensors it was
given, hand in the staging scratch a kernel asks for, and raise when the
launch is refused."""

from __future__ import annotations

import ctypes

import torch


def check_tensor(name: str, t: torch.Tensor, shape, device,
                 dtype=torch.float32, contiguous: bool = True):
    """Raise unless ``t`` is a ``dtype`` tensor on ``device``, of ``shape``
    (unless None) and contiguous (unless ``contiguous`` is False, for a
    kernel that reads it through its strides): the CUDA kernels read raw
    pointers."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        what = "float32" if dtype == torch.float32 else str(dtype)
        raise ValueError(f"{name}: the CUDA kernel takes {what}, got "
                         f"{t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def launch_failed(fn: str, code: int):
    raise RuntimeError(f"{fn}: kernel launch refused (cudaError {code})")


def launch_staged(fn: str, call, device):
    """Launch through a C entry point of the staging hand-shake
    (csrc/minplus.cuh::plan_stage decides, once, whether a block's sources
    fit shared memory): ``call(scratch, floats, need)`` is made without
    scratch; where it asks for some in ``need`` it launched nothing, and is
    made again with that many float32 of global scratch.  Raises if the
    launch is refused."""
    need = ctypes.c_longlong(0)
    code = call(None, 0, ctypes.byref(need))
    if code == 0 and need.value > 0:
        floats = need.value
        scratch = torch.empty((floats,), dtype=torch.float32, device=device)
        code = call(scratch.data_ptr(), floats, ctypes.byref(need))
        if code == 0 and need.value > floats:
            raise RuntimeError(f"{fn}: asked for {need.value} floats of "
                               f"scratch after {floats}")
    if code != 0:
        launch_failed(fn, code)
