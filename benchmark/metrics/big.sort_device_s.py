"""big.sort_device_s: device seconds of a job's reference sorts on the
long-genome path (``big_ref_join``: each reference's stable sort of its
k-mer keys and the write of its position list), the sum of its
``dev.sort`` spans, the mean over the window's jobs. Part of
``engine.join_device_s``; a program without these spans reads None."""

from benchmark import spans


def read(run):
    return spans.mean_per_job(run, "dev.sort")
