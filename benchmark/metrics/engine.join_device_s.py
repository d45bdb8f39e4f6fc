"""engine.join_device_s: device seconds of a job's reference joins
(``group_join`` / ``big_ref_join``), the sum of its ``dev.join`` spans
(from the event before the join to the event after it, idle time inside
included), the mean over the window's jobs. Device spans exist on a
card only."""

from benchmark import spans


def read(run):
    return spans.mean_per_job(run, "dev.join")
