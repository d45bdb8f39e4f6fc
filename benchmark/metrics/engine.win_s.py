"""engine.win_s: the cuda engine's counter ``win_s``
(``all2all_cuda(stats=)``, read through ``Matcher.engine_stats``): the
main thread's seconds building the index builds' WIN arbitration words
(``anchor_tables.win_words``), part of ``dispatch_s``, the mean per job
over the window's jobs. A program without the counter reads None."""


def read(run):
    vals = [j.stats["win_s"] for j in run.ok_jobs if "win_s" in j.stats]
    return sum(vals) / len(vals) if vals else None
