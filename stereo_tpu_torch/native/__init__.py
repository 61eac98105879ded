"""The port's native segmentation (``segment.cpp``), built at first use and
bound with ctypes (port of stereo_tpu/native/__init__.py, for the two entry
points that proposals/segmentation.py calls).

``segment.cpp`` is compiled by the host C++ compiler into
``stereo_tpu_torch/build/libsegment-<hash>.so``; the hash covers the source
and the flags, so an edited source is rebuilt and a fresh checkout never
loads a library built elsewhere.  The library is written under a temporary
name and renamed into place, so a concurrent process never loads a
half-written file.  Nothing is built when the package is imported.  A
missing compiler or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "segment.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "build")
# portable baseline: no -march=native, so the library carries no ISA
# extension of the machine that built it
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib = None


def _compiler() -> str:
    for name in ("g++", "c++"):
        exe = shutil.which(name)
        if exe:
            return exe
    raise RuntimeError("no C++ compiler (g++, c++) on PATH: the native "
                       "segmentation cannot be built")


def library_path() -> str:
    """Where the library of the present source and flags lives."""
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libsegment-{digest.hexdigest()[:12]}.so")


def build() -> str:
    """Compile ``segment.cpp`` unless its library exists; its path."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [_compiler(), *FLAGS, "-o", tmp, SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"building the native segmentation failed (exit "
                           f"{proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            L = ctypes.CDLL(build())
            u32p = ctypes.POINTER(ctypes.c_uint32)
            f32p = ctypes.POINTER(ctypes.c_float)
            L.felzenszwalb.argtypes = [f32p, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_float, ctypes.c_float,
                                       ctypes.c_int, u32p]
            L.felzenszwalb.restype = ctypes.c_int
            L.connect_modes.argtypes = [f32p, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_float, ctypes.c_int, u32p]
            L.connect_modes.restype = ctypes.c_int
            _lib = L
        return _lib
