"""replay.c_us_per_pair: microseconds inside the native replay calls a
replayed pair, summed over the pool's threads (``replay_c_s`` over
``replay_pairs`` of ``Matcher.engine_stats``, over every job of the
window)."""


def read(run):
    c = sum(j.stats.get("replay_c_s", 0.0) for j in run.ok_jobs)
    n = sum(j.stats.get("replay_pairs", 0) for j in run.ok_jobs)
    return 1e6 * c / n if n else None
