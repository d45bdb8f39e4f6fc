"""kernels.roofline: the least time the card could take for the work of
the pairs it parsed, over the time it was busy (the union of every
kernel and copy) during the jobs' matching phases, in %.

The work is counted from the genomes and the pair set
(``benchmark/work.py``), never from the program's buffers: one symbol
compare per query position of every pair, and every genome's symbols
read once at 3 bits plus a 12-byte triple a pair. The pairs the card
parsed are the engine's ``kernel_pairs`` and ``big_pairs``; the few that
fell back to the host (``cap_fallbacks``) take their share of the
compares with them."""

import sys

from benchmark import work


def read(run):
    tr = run.trace
    peak = work.peaks(run.device_kind)
    if tr is None or peak is None:
        return None
    compares = nbytes = busy = 0.0
    for job in run.ok_jobs:
        dev_pairs = job.stats.get("kernel_pairs", 0) + \
            job.stats.get("big_pairs", 0)
        if not dev_pairs:
            continue
        c, b, pairs = work.all_pairs_work(run.lengths[job.coll])
        compares += c * dev_pairs / pairs
        nbytes += b - 12 * (pairs - dev_pairs)
        busy += sum(tr.busy(a, e) for p, a, e in job.phase_spans()
                    if p == "match")
    if not busy or not compares:
        return None
    least, bound = work.least_seconds(compares, nbytes, peak)
    print(f"bench: kernels.roofline: {compares:.6g} compares, {nbytes:.6g} "
          f"bytes, least {least:.6g} s ({bound} bound), busy {busy:.6g} s",
          file=sys.stderr)
    return 100.0 * least / busy
