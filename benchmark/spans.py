"""What the readers of the engine's spans share.

The cuda engine records spans when a torch profiler is recording, so a
``--trace 1`` run's jobs carry them in ``job.stats["spans"]``: tuples
``(name, unit, t0, t1, thread)`` on ``time.perf_counter()`` seconds, the
clock of ``Matcher.times`` and of the trace. A program that records no
spans leaves the key out, and every function here then returns None.
"""

from __future__ import annotations


def of(job, name: str) -> list[tuple] | None:
    """The job's spans named `name`, or None where the job has no
    spans."""
    spans = job.stats.get("spans")
    if spans is None:
        return None
    return [s for s in spans if s[0] == name]


def job_sum(job, name: str) -> float | None:
    """Seconds of the job's spans named `name`, summed; None where the
    job has none of them."""
    got = of(job, name)
    return sum(s[3] - s[2] for s in got) if got else None


def mean_per_job(run, name: str) -> float | None:
    """The mean over the window's whole jobs of ``job_sum``, over the
    jobs that have such spans; None where none has."""
    vals = [v for v in (job_sum(j, name) for j in run.ok_jobs)
            if v is not None]
    return sum(vals) / len(vals) if vals else None


def idle(trace, a: float, b: float) -> float:
    """Seconds of [a, b), cut to the traced window, in which no device
    interval runs."""
    a, b = max(a, trace.t0), min(b, trace.t1)
    return max(0.0, (b - a) - trace.busy(a, b)) if b > a else 0.0


def has_device(run) -> bool:
    tr = run.trace
    return tr is not None and tr.t1 > tr.t0 and len(tr.start) > 0
