"""replay.queue_s: seconds a downloaded unit waits in the replay pool's
queue before its native replay call starts (its ``unit.queue`` span,
from its submission to the start of its task on a pool thread), the
mean over every unit of the window's jobs."""

from benchmark import spans


def read(run):
    vals = []
    for job in run.ok_jobs:
        vals += [s[3] - s[2] for s in spans.of(job, "unit.queue") or []]
    return sum(vals) / len(vals) if vals else None
