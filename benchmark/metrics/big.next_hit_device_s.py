"""big.next_hit_device_s: device seconds of a job's ``next_hit`` planes
on the long-genome path (``big_query_prep``: for each reference, the
flip, cummin and flip over the query positions and the masked write),
the sum of its ``dev.next_hit`` spans, the mean over the window's jobs.
Part of ``engine.prep_device_s``; a program without these spans reads
None."""

from benchmark import spans


def read(run):
    return spans.mean_per_job(run, "dev.next_hit")
