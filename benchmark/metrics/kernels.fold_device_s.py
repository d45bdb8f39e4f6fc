"""kernels.fold_device_s: device seconds of a job's fold launches on the
automaton backend (``fold_stats``: each event log folded into its
factors and stats triple on the card), the sum of its ``dev.fold`` spans,
the mean over the window's jobs. A program whose automaton backend
records no spans reads None."""

from benchmark import spans


def read(run):
    return spans.mean_per_job(run, "dev.fold")
