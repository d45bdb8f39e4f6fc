"""kernels.row_parse_device_s: device seconds of a job's row parse
launches on the automaton backend (``parse_events`` at G = 1, one launch
a query batch of a reference row), the sum of its ``dev.kernel`` spans,
the mean over the window's jobs. The cell runs only the automaton
backend, so every ``dev.kernel`` span is a row parse; a program whose
automaton backend records no spans reads None."""

from benchmark import spans


def read(run):
    return spans.mean_per_job(run, "dev.kernel")
