"""matcher.load_s: seconds a job spends loading its FASTA and reordering
the genomes (``Matcher.times``: "Loading sequences" through "Reordering
sequences"), the mean over the window's jobs."""


def read(run):
    jobs = run.ok_jobs
    return sum(j.phase_s("load", "reorder") for j in jobs) / len(jobs) \
        if jobs else None
