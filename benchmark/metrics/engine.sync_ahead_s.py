"""engine.sync_ahead_s: seconds a job's downloads wait for work queued
after their own unit's kernel (the next unit's prep and kernel on the
one stream), the sum of its ``unit.sync_ahead`` spans, the mean over
the window's jobs. On a card the wait for the unit's own kernel is
``unit.sync_own``; the two add up to ``download_sync_s``."""

from benchmark import spans


def read(run):
    return spans.mean_per_job(run, "unit.sync_ahead")
