"""ingest.mb_per_s: the rate of the jobs' FASTA ingest, in 10^6 bytes a
second: the sum of the ingest counters ``ingest_bytes`` (bytes read,
after gzip) over 10^6 times the sum of ``ingest_s`` (the first read to
the last item stored), over the window's jobs (``Matcher.engine_stats``).
A program without the counters reads None."""


def read(run):
    jobs = [j for j in run.ok_jobs
            if "ingest_bytes" in j.stats and "ingest_s" in j.stats]
    secs = sum(j.stats["ingest_s"] for j in jobs)
    if not jobs or secs <= 0:
        return None
    return sum(j.stats["ingest_bytes"] for j in jobs) / (1e6 * secs)
