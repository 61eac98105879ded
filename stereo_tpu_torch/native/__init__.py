"""The port's native host code, built at first use and bound with ctypes
(port of stereo_tpu/native/__init__.py).  Three libraries, one per source:

  ``segment``  ``segment.cpp``: ``felzenszwalb``, ``connect_modes``
               (proposals/segmentation.py);
  ``qpbo``     ``qpbo.cpp``: ``qpbo_solve`` (solvers/qpbo_host.py);
  ``trws``     ``trws.cpp``: ``trws_serial`` (solvers/trws_host.py).

A source is compiled by the host C++ compiler into
``stereo_tpu_torch/build/lib<name>-<hash>.so``; the hash covers the source
and the flags, so an edited source is rebuilt and a fresh checkout never
loads a library built elsewhere.  The library is written under a temporary
name and renamed into place, so a concurrent process never loads a
half-written file.  Nothing is built when the package is imported.  A
missing compiler or a failed build raises.  ``SOURCE`` is the segmentation's
source; every function takes the library's name, ``"segment"`` by default.
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
NAMES = ("segment", "qpbo", "trws")
# portable baseline: no -march=native, so the library carries no ISA
# extension of the machine that built it
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _compiler() -> str:
    for name in ("g++", "c++"):
        exe = shutil.which(name)
        if exe:
            return exe
    raise RuntimeError("no C++ compiler (g++, c++) on PATH: the native "
                       "library cannot be built")


def source(name: str = "segment") -> str:
    """The C++ source of library ``name``."""
    if name not in NAMES:
        raise ValueError(f"unknown native library {name!r}; one of {NAMES}")
    return SOURCE if name == "segment" else os.path.join(_DIR, f"{name}.cpp")


def library_path(name: str = "segment") -> str:
    """Where the library of the present source and flags lives."""
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    with open(source(name), "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(name: str = "segment") -> str:
    """Compile library ``name`` unless it exists; its path."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [_compiler(), *FLAGS, "-o", tmp, source(name)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"building the native {name} library failed "
                           f"(exit {proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _bind_segment(L: ctypes.CDLL):
    u32p = ctypes.POINTER(ctypes.c_uint32)
    f32p = ctypes.POINTER(ctypes.c_float)
    L.felzenszwalb.argtypes = [f32p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_float, ctypes.c_float, ctypes.c_int,
                               u32p]
    L.felzenszwalb.restype = ctypes.c_int
    L.connect_modes.argtypes = [f32p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_float, ctypes.c_int, u32p]
    L.connect_modes.restype = ctypes.c_int


def _bind_qpbo(L: ctypes.CDLL):
    ct = ctypes
    f64p, i32p = ct.POINTER(ct.c_double), ct.POINTER(ct.c_int32)
    L.qpbo_solve.argtypes = [
        ct.c_int, ct.c_int,  # n_nodes, n_edges
        f64p, f64p,  # U0, U1
        i32p, i32p,  # tails, heads
        f64p, f64p, f64p, f64p,  # E00, E01, E10, E11
        ct.c_int,  # improve
        i32p,  # labels out (-1 unlabelled)
        f64p, f64p, i32p,  # energy, lower bound, n_unlabelled
        i32p,  # regions out (nullable)
    ]
    L.qpbo_solve.restype = ct.c_int


def _bind_trws(L: ctypes.CDLL):
    ct = ctypes
    f64p, i32p = ct.POINTER(ct.c_double), ct.POINTER(ct.c_int32)
    L.trws_serial.argtypes = [
        ct.c_int, ct.c_int, ct.c_int, ct.c_int,  # kernel, K, N, E
        f64p, i32p, i32p,  # unary, tails, heads
        f64p, f64p, f64p, ct.c_double,  # q_src, q_dst, alphas, tol
        i32p, ct.c_int, ct.c_double,  # order, maxiter, max_relgap
        i32p, f64p, f64p,  # labels, energy, lb
        f64p, f64p, f64p,  # trace_e, trace_lb, trace_t (nullable)
    ]
    L.trws_serial.restype = ct.c_int


_BINDERS = {"segment": _bind_segment, "qpbo": _bind_qpbo,
            "trws": _bind_trws}


def lib(name: str = "segment") -> ctypes.CDLL:
    """The loaded library ``name`` (built on first use)."""
    with _lock:
        if name not in _libs:
            L = ctypes.CDLL(build(name))
            _BINDERS[name](L)
            _libs[name] = L
        return _libs[name]
