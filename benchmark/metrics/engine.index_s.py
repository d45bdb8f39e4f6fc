"""engine.index_s: seconds a job's main thread spends building the
reference indexes (``GroupIndex`` / ``BigIndex``), the sum of its
``unit.index`` spans, the mean over the window's jobs."""

from benchmark import spans


def read(run):
    return spans.mean_per_job(run, "unit.index")
