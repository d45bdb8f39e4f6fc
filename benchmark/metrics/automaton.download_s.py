"""automaton.download_s: seconds a job's row loop spends on the automaton
backend's downloads (``RefIndexJax.collect``'s copies of the triples,
statuses and fallback flags, the wait for the card's parse and fold
included), the sum of its ``row.download`` spans, the mean over the
window's jobs. A program whose automaton backend records no spans reads
None."""

from benchmark import spans


def read(run):
    return spans.mean_per_job(run, "row.download")
