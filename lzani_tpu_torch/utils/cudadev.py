"""The port's card check, without torch: the CLI asks it for every backend
but ``native``, and the hybrid at entry, so that a run that never warms
the device never imports torch."""

from __future__ import annotations

import ctypes as ct
import functools


@functools.cache
def cuda_device_count() -> int:
    """CUDA devices that libcuda reports (``cuInit`` and
    ``cuDeviceGetCount``), 0 without libcuda or a device. Asked once per
    process; loads no torch."""
    try:
        lib = ct.CDLL("libcuda.so.1")
    except OSError:
        return 0
    n = ct.c_int(0)
    if lib.cuInit(0) != 0 or lib.cuDeviceGetCount(ct.byref(n)) != 0:
        return 0
    return n.value
