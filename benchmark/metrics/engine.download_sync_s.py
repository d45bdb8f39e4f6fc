"""engine.download_sync_s: the cuda engine's counter ``download_sync_s``
(``all2all_cuda(stats=)``, read through ``Matcher.engine_stats``), the
mean per job over the window's jobs."""


def read(run):
    vals = [j.stats["download_sync_s"] for j in run.ok_jobs
            if "download_sync_s" in j.stats]
    return sum(vals) / len(vals) if vals else None
