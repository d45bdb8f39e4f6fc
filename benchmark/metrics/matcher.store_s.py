"""matcher.store_s: seconds a job spends writing its TSV and ids files
(``Matcher.times``: "Storing results"), the mean over the window's
jobs."""


def read(run):
    jobs = run.ok_jobs
    return sum(j.phase_s("store") for j in jobs) / len(jobs) \
        if jobs else None
