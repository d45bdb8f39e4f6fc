"""kernels.automaton_roofline: the least time the card could take for the
work of the pairs the automaton backend folded, over the device time of
its two kernels during the jobs' matching phases, in %.

The work is counted as ``kernels.roofline`` counts it (``benchmark/
work.py``): one symbol compare per query position of every pair, and
every genome's symbols read once at 3 bits plus a 12-byte triple a
pair, scaled to the engine's ``fold_pairs`` (the triples folded on the
card, capacity fallbacks and rejected logs left out). The time is the
union of the trace's intervals whose name holds ``parse_group_kernel``
or ``fold_kernel``: the parse and the fold of each row's batches, which
together do the work that one parse and the host replay do on the cuda
backend."""

import sys

from benchmark import work
from benchmark.trace import Trace

KERNELS = ("parse_group_kernel", "fold_kernel")


def read(run):
    tr = run.trace
    peak = work.peaks(run.device_kind)
    if tr is None or peak is None:
        return None
    sel = [i for i, n in enumerate(tr.names) if any(k in n for k in KERNELS)]
    if not sel:
        return None
    kern = Trace(tr.start[sel], tr.end[sel], [tr.names[i] for i in sel],
                 tr.t0, tr.t1)
    compares = nbytes = busy = 0.0
    for job in run.ok_jobs:
        folded = job.stats.get("fold_pairs", 0)
        if not folded:
            continue
        c, b, pairs = work.all_pairs_work(run.lengths[job.coll])
        compares += c * folded / pairs
        nbytes += b - 12 * (pairs - folded)
        busy += sum(kern.busy(a, e) for p, a, e in job.phase_spans()
                    if p == "match")
    if not busy or not compares:
        return None
    least, bound = work.least_seconds(compares, nbytes, peak)
    print(f"bench: kernels.automaton_roofline: {compares:.6g} compares, "
          f"{nbytes:.6g} bytes, least {least:.6g} s ({bound} bound), "
          f"{' + '.join(KERNELS)} {busy:.6g} s", file=sys.stderr)
    return 100.0 * least / busy
