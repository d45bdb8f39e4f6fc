"""big.search_device_s: device seconds of a job's candidate searches on
the long-genome path (``big_query_prep``: for each reference, the two
``searchsorted`` calls of the queries' keys in its sorted keys and the
start and count planes), the sum of its ``dev.search`` spans, the mean
over the window's jobs. Part of ``engine.prep_device_s``; a program
without these spans reads None."""

from benchmark import spans


def read(run):
    return spans.mean_per_job(run, "dev.search")
