"""big.kmers_device_s: device seconds of a job's k-mer key streams on the
long-genome path (``kmer_keys`` over each reference in ``big_ref_join``
and over each unit's queries in ``big_query_prep``), the sum of its
``dev.kmers`` spans, the mean over the window's jobs. Part of
``engine.join_device_s`` and ``engine.prep_device_s``; the group path
records none, and a program without these spans reads None."""

from benchmark import spans


def read(run):
    return spans.mean_per_job(run, "dev.kmers")
