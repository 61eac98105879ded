"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by nvcc into
``build/lib<name>-<hash>.so`` (the hash covers the source, every shared header
``csrc/*.cuh`` and the flags, so a change to any of them is rebuilt), then
loaded with ctypes.  Nothing is built when
the package is imported: ``load(name)`` builds at first use, and
``build_all()`` starts one nvcc per source, all together.  A build that fails
raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# per-source extra flags; no FMA contraction, so a kernel rounds like its
# plain PyTorch version (see the note in each source)
EXTRA_FLAGS = {"banded_decode": ("-fmad=false",),
               "phase_kernel": ("-fmad=false",),
               "minplus_send": ("-fmad=false",),
               "minplus_pair": ("-fmad=false",),
               "banded_kernel": ("-fmad=false",),
               "wavefront_kernel": ("-fmad=false",),
               "k2_block": ("-fmad=false",)}

_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, dict] = {}  # name -> {"seconds", "ptxas", "path"}


def sources() -> list[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe:
        return exe
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def _target(name: str, csrc_dir: str = CSRC_DIR,
            build_dir: str = BUILD_DIR) -> tuple[str, str, tuple[str, ...]]:
    """(source, library path, flags) of ``<csrc_dir>/<name>.cu``; the
    library's name carries a digest of the flags, the source and every
    header ``*.cuh`` beside it."""
    src = os.path.join(csrc_dir, name + ".cu")
    flags = NVCC_FLAGS + EXTRA_FLAGS.get(name, ())
    digest = hashlib.sha256(" ".join(flags).encode())
    headers = sorted(f for f in os.listdir(csrc_dir) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(csrc_dir, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    out = os.path.join(build_dir, f"lib{name}-{digest.hexdigest()[:12]}.so")
    return src, out, flags


def _start(name: str):
    src, out, flags = _target(name)
    if os.path.exists(out):
        return None, out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *flags, "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return (proc, tmp, cmd, time.perf_counter()), out


def _finish(name: str, started, out: str) -> str:
    if started is not None:
        proc, tmp, cmd, t0 = started
        log, _ = proc.communicate()
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(
                f"nvcc failed for {name} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{log}")
        os.replace(tmp, out)
        build_log[name] = {"seconds": time.perf_counter() - t0,
                           "ptxas": log, "path": out}
    return out


def build_all() -> dict[str, str]:
    """Compile every source under csrc/ (one nvcc each, started together)."""
    started = {name: _start(name) for name in sources()}
    return {name: _finish(name, st, out)
            for name, (st, out) in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built if need be."""
    lib = _libs.get(name)
    if lib is None:
        st, out = _start(name)
        lib = ctypes.CDLL(_finish(name, st, out))
        _libs[name] = lib
    return lib
