"""automaton.index_s: seconds a job's row loop spends building each
reference row's index on the automaton backend (``RefIndexJax``, the
group path's ``CudaRefIndex`` of one reference), the sum of its
``row.index`` spans, the mean over the window's jobs. A program whose
automaton backend records no spans reads None."""

from benchmark import spans


def read(run):
    return spans.mean_per_job(run, "row.index")
