"""The traced run's reduction: device intervals from ``torch.profiler``,
put on the host's clock, and what they say about the window.

The profiler stamps its events on the wall clock; the harness opens one
``record_function`` span around each job, whose start it also reads on
``time.perf_counter``. The offset between the two puts every device
interval on the clock of the program's phase marks (``Matcher.times``).
"""

from __future__ import annotations

import numpy as np


def _ns(ev, what: str) -> int:
    return int(getattr(ev, f"{what}_ns")())


def is_device(ev) -> bool:
    """A kernel, copy or set on the card: an event on the CUDA timeline
    that is not a user annotation (the profiler mirrors each
    ``record_function`` span there)."""
    return str(ev.device_type()).endswith("CUDA") and \
        not ev.is_user_annotation()


class Trace:
    """Device intervals of the traced window on the host's clock:
    ``start``, ``end`` (seconds, arrays), ``names``, and the window
    ``t0``, ``t1``."""

    def __init__(self, starts, ends, names, t0: float, t1: float):
        order = np.argsort(starts, kind="stable")
        self.start = np.asarray(starts, np.float64)[order]
        self.end = np.asarray(ends, np.float64)[order]
        self.names = [names[i] for i in order]
        self.t0, self.t1 = t0, t1
        self._union = None

    @classmethod
    def from_profiler(cls, prof, job_marks, t0: float, t1: float):
        """`job_marks`: (span name, perf_counter start) of each job's
        ``record_function`` span."""
        evs = prof.profiler.kineto_results.events()
        marks = dict(job_marks)
        offs = [_ns(e, "start") * 1e-9 - marks[e.name()] for e in evs
                if str(e.device_type()).endswith("CPU")
                and e.name() in marks]
        if not offs:
            raise RuntimeError("the trace holds none of the jobs' spans")
        off = float(np.median(offs))
        starts, ends, names = [], [], []
        for e in evs:
            if is_device(e) and e.name() not in marks:
                s = _ns(e, "start") * 1e-9 - off
                starts.append(s)
                ends.append(s + _ns(e, "duration") * 1e-9)
                names.append(e.name())
        return cls(starts, ends, names, t0, t1)

    def busy(self, lo: float, hi: float) -> float:
        """Seconds in [lo, hi) in which any device interval runs (their
        union)."""
        a, b = self.union
        return float(np.clip(np.minimum(b, hi) - np.maximum(a, lo), 0,
                             None).sum())

    @property
    def union(self) -> tuple[np.ndarray, np.ndarray]:
        """The union of the device intervals: (starts, ends), disjoint and
        ascending."""
        if self._union is None:
            out: list[list[float]] = []
            for a, b in zip(self.start.tolist(), self.end.tolist()):
                if out and a <= out[-1][1]:
                    out[-1][1] = max(out[-1][1], b)
                else:
                    out.append([a, b])
            arr = np.asarray(out, np.float64).reshape(-1, 2)
            self._union = (arr[:, 0], arr[:, 1])
        return self._union

    def gaps(self) -> list[tuple[float, float]]:
        """Idle stretches of the window, between the busy ones."""
        out, cur = [], self.t0
        for a, b in zip(*(x.tolist() for x in self.union)):
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if a > cur:
                out.append((cur, a))
            cur = max(cur, b)
        if self.t1 > cur:
            out.append((cur, self.t1))
        return out

    def by_name(self) -> list[tuple[str, float]]:
        """Device seconds summed by operation name, most first."""
        tot: dict[str, float] = {}
        for n, a, b in zip(self.names, self.start.tolist(),
                           self.end.tolist()):
            tot[n] = tot.get(n, 0.0) + (b - a)
        return sorted(tot.items(), key=lambda kv: -kv[1])
