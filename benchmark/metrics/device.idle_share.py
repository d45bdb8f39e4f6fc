"""device.idle_share: the share of the traced window (whole jobs, load
and store included) in which no kernel or copy runs on the card, in %."""


def read(run):
    tr = run.trace
    if tr is None or tr.t1 <= tr.t0 or not len(tr.start):
        return None
    return 100.0 * (1.0 - tr.busy(tr.t0, tr.t1) / (tr.t1 - tr.t0))
