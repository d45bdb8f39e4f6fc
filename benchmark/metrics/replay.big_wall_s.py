"""replay.big_wall_s: seconds of a job's native replay calls on the pool's
threads (each unit's ``unit.replay`` span, from the start of its task to
the end of its call), summed, the mean over the window's jobs. In the
long-genome cell every unit is a long-genome unit, whose call spreads
its references over the pool's width. A program without the span reads
None."""

from benchmark import spans


def read(run):
    return spans.mean_per_job(run, "unit.replay")
