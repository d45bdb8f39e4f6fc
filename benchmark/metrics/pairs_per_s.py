"""pairs_per_s: ordered genome pairs of every whole job in the window,
over the window's whole time (its start to the end of its last job)."""


def read(run):
    return sum(j.pairs for j in run.ok_jobs) / (run.t1 - run.t0)
