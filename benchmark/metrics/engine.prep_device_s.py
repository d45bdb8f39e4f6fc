"""engine.prep_device_s: device seconds of a job's query prep
(``query_prep`` / ``big_query_prep``), the sum of its ``dev.prep``
spans, the mean over the window's jobs."""

from benchmark import spans


def read(run):
    return spans.mean_per_job(run, "dev.prep")
