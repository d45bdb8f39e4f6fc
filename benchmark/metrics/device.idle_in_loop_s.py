"""device.idle_in_loop_s: seconds of the cuda engine's loop (its
``engine.loop`` span: the first dispatch to the end of the last
download) in which no kernel or copy runs on the card, the mean over
the window's jobs. The part of ``device.idle_share`` that the main
thread's chain leaves.

On standard error it splits that idle time by what the main thread was
doing (its ``unit.*`` spans; the rest is the loop's own bookkeeping and
the handing of units to the replay pool), and gives each device stage's
span beside the device time that the trace finds busy inside it."""

import sys

from benchmark import spans

MAIN = ("unit.index", "unit.prep", "unit.launch", "unit.sync_own",
        "unit.sync_ahead", "unit.copy")
DEVICE = ("dev.join", "dev.prep", "dev.kernel", "dev.compact")


def read(run):
    if not spans.has_device(run):
        return None
    tr = run.trace
    jobs = [j for j in run.ok_jobs if spans.of(j, "engine.loop")]
    if not jobs:
        return None
    in_loop = 0.0
    idle_by = dict.fromkeys(MAIN, 0.0)
    stage = {n: [0.0, 0.0] for n in DEVICE}
    for j in jobs:
        in_loop += sum(spans.idle(tr, s[2], s[3])
                       for s in spans.of(j, "engine.loop"))
        for n in MAIN:
            idle_by[n] += sum(spans.idle(tr, s[2], s[3])
                              for s in spans.of(j, n))
        for n in DEVICE:
            for s in spans.of(j, n):
                stage[n][0] += s[3] - s[2]
                stage[n][1] += tr.busy(s[2], s[3])
    n = len(jobs)
    rest = in_loop - sum(idle_by.values())
    print("bench: device idle in loops, s a job: " + ", ".join(
        f"{k} {v / n:.6g}" for k, v in list(idle_by.items())
        + [("other", rest)]) + "; device stages, span / busy s a job: "
        + ", ".join(f"{k} {a / n:.6g} / {b / n:.6g}"
                    for k, (a, b) in stage.items()), file=sys.stderr)
    return in_loop / n
