"""Builds the port's native sources at first use.

Two routes, both into a shared library with a plain C interface, loaded
with ctypes:
  * ``nvcc`` for the CUDA kernels (no PyTorch headers, so a build takes
    seconds);
  * ``g++`` for the native C++ engine (``csrc/lzani_core.cpp``).
A library lands in ``lzani_tpu_torch/_build/`` under a name keyed by a
hash of the sources, the headers they include and the flags, so a stale
build is never loaded (the lesson of the JAX package's executable cache:
every input that changes compiled code keys the cache). The g++ build uses ``-march=native``, so
its key also holds the host's name: a checkout copied to another machine
builds anew.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import re
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-std=c++20", "-shared", "-fPIC", "-march=native")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_paths: dict[str, str] = {}


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


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _inputs(sources: list[str]) -> list[str]:
    """`sources` and every file they include with ``#include "..."`` (from
    the including file's directory, transitively), each once, in order."""
    seen, todo = [], list(sources)
    while todo:
        path = os.path.abspath(todo.pop(0))
        if path in seen:
            continue
        seen.append(path)
        with open(path, "rb") as fh:
            for inc in _INCLUDE.findall(fh.read()):
                todo.append(os.path.join(os.path.dirname(path),
                                         inc.decode()))
    return seen


def build_key(sources: list[str], flags: tuple, key: str) -> str:
    """The hash that names a build: the text of `sources` and of the
    headers they include, the flags and `key`."""
    h = hashlib.sha1()
    for src in _inputs(sources):
        with open(src, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(flags).encode())
    h.update(key.encode())
    return h.hexdigest()[:16]


def _build(name: str, sources: list[str], compiler: list[str],
           flags: tuple, key: str, libs: tuple = ()) -> str:
    """Compile `sources` with `compiler` unless the build named by
    ``build_key`` already exists; returns its path."""
    path = os.path.join(BUILD_DIR,
                        f"lib{name}_{build_key(sources, flags + libs, key)}"
                        f".so")
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
    with open(path + ".log", "w") as fh:   # the compiler's report
        fh.write(res.stdout + res.stderr)
    return path


def build_library(name: str, sources: list[str], defines: tuple = ()) -> str:
    """CUDA sources -> shared library (nvcc, sm_90a); returns its path.
    `defines` (``-D`` flags) key the build as the other flags do."""
    return _build(name, sources, [nvcc_path()], NVCC_FLAGS + tuple(defines),
                  "")


def build_gxx(name: str, sources: list[str]) -> str:
    """C++ sources -> shared library (g++ for this host); returns its
    path."""
    return _build(name, sources, ["g++"], GXX_FLAGS,
                  f"{platform.node()} {platform.machine()}", ("-lpthread",))


def load_library(name: str, sources: list[str],
                 defines: tuple = ()) -> ctypes.CDLL:
    """Build (once per process and source hash) and load a library."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_library(name, sources, defines)
            lib = ctypes.CDLL(path)
            _libs[name], _paths[name] = lib, path
        return lib


def build_report(name: str) -> str:
    """What the compiler printed when it built the library `name` (for
    nvcc: ptxas's registers, shared memory and spills of each kernel);
    empty when the build predates the report."""
    try:
        with open(_paths[name] + ".log") as fh:
            return fh.read()
    except (KeyError, OSError):
        return ""
