"""replay.tail_s: the cuda engine's wait for the replay pool after its
last download (``replay_tail_s`` of ``Matcher.engine_stats``), the mean
per job over the window's jobs."""


def read(run):
    vals = [j.stats["replay_tail_s"] for j in run.ok_jobs
            if "replay_tail_s" in j.stats]
    return sum(vals) / len(vals) if vals else None
