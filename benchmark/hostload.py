"""Readings of the host around each job, so that a run that reads slow can
be told from one that ran on a loaded host: the host's CPU time by kind
(``/proc/stat``: busy, steal, iowait), this process's CPU seconds and
context switches (``getrusage``), its threads, the load average and the
cores' clock (``/proc/cpuinfo``). A reading that the host does not offer
is left out."""

from __future__ import annotations

import os
import resource
import time

_STAT_KEYS = ("user", "nice", "system", "idle", "iowait", "irq", "softirq",
              "steal")


def _cpu_jiffies() -> dict | None:
    try:
        with open("/proc/stat") as fh:
            parts = fh.readline().split()
    except OSError:
        return None
    return dict(zip(_STAT_KEYS, (int(x) for x in parts[1:9])))


def _mhz() -> float | None:
    try:
        with open("/proc/cpuinfo") as fh:
            vals = [float(ln.split(":")[1]) for ln in fh
                    if ln.startswith("cpu MHz")]
    except (OSError, ValueError, IndexError):
        return None
    return sum(vals) / len(vals) if vals else None


def _threads() -> int | None:
    try:
        with open("/proc/self/status") as fh:
            for ln in fh:
                if ln.startswith("Threads:"):
                    return int(ln.split()[1])
    except (OSError, ValueError):
        pass
    return None


def snapshot() -> dict:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"t": time.perf_counter(), "jiffies": _cpu_jiffies(),
            "cpu_s": ru.ru_utime + ru.ru_stime, "nvcsw": ru.ru_nvcsw,
            "nivcsw": ru.ru_nivcsw, "mhz": _mhz(), "threads": _threads(),
            "load1": os.getloadavg()[0]}


def between(a: dict, b: dict) -> dict:
    """What the host did from snapshot `a` to `b`: shares of the host's
    CPU time (all cores) that were busy, stolen by the hypervisor and
    waiting on I/O; this process's CPU seconds and voluntary and
    involuntary context switches; and `b`'s clock, threads and load."""
    out = {"proc_cpu_s": b["cpu_s"] - a["cpu_s"],
           "nvcsw": b["nvcsw"] - a["nvcsw"],
           "nivcsw": b["nivcsw"] - a["nivcsw"], "load1": b["load1"]}
    if a["jiffies"] and b["jiffies"]:
        d = {k: b["jiffies"][k] - a["jiffies"][k] for k in _STAT_KEYS}
        tot = sum(d.values()) or 1
        out["host_busy"] = (d["user"] + d["nice"] + d["system"] + d["irq"]
                            + d["softirq"]) / tot
        out["host_steal"] = d["steal"] / tot
        out["host_iowait"] = d["iowait"] / tot
    for k in ("mhz", "threads"):
        if b[k] is not None:
            out[k] = b[k]
    return out
