"""Builds the port's native sources at first use.

Two routes, both into a shared library with a plain C interface, loaded
with ctypes:
  * ``nvcc`` for the CUDA kernels (no PyTorch headers, so a build takes
    seconds);
  * ``g++`` for the native C++ engine (``csrc/lzani_core.cpp``).
A library lands in ``lzani_tpu_torch/_build/`` under a name keyed by a
hash of the sources and the flags, so a stale build is never loaded (the
lesson of the JAX package's executable cache: every input that changes
compiled code keys the cache). The g++ build uses ``-march=native``, so
its key also holds the host's name: a checkout copied to another machine
builds anew.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
GXX_FLAGS = ("-O3", "-std=c++20", "-shared", "-fPIC", "-march=native")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc of the CUDA toolkit PyTorch finds (CUDA_HOME, PATH, or the
    toolkit's default prefix)."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _build(name: str, sources: list[str], compiler: list[str],
           flags: tuple, key: str, libs: tuple = ()) -> str:
    """Compile `sources` with `compiler` unless the build keyed by their
    hash, the flags and `key` already exists; returns its path."""
    h = hashlib.sha1()
    for src in sources:
        with open(src, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(flags + libs).encode())
    h.update(key.encode())
    path = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    cmd = [*compiler, *flags, "-o", tmp, *sources, *libs]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{compiler[0]} failed ({res.returncode}): "
                           f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, path)
    return path


def build_library(name: str, sources: list[str]) -> str:
    """CUDA sources -> shared library (nvcc, sm_90a); returns its path."""
    return _build(name, sources, [nvcc_path()], NVCC_FLAGS, "")


def build_gxx(name: str, sources: list[str]) -> str:
    """C++ sources -> shared library (g++ for this host); returns its
    path."""
    return _build(name, sources, ["g++"], GXX_FLAGS,
                  f"{platform.node()} {platform.machine()}", ("-lpthread",))


def load_library(name: str, sources: list[str]) -> ctypes.CDLL:
    """Build (once per process and source hash) and load a library."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_library(name, sources))
            _libs[name] = lib
        return lib
