"""device.idle_outside_loop_s: seconds of the traced window outside the
cuda engine's loops (``engine.loop`` spans) in which no kernel or copy
runs on the card, a job: the window's idle time less the idle time
inside every job's loop, over the jobs. The part of
``device.idle_share`` that host work between two jobs' kernels leaves.

On standard error it splits that idle time by what the program was
doing: the engine's set-up (``engine.setup``), its wait for the replay
pool (``engine.replay_tail``), each phase of ``Matcher.times`` outside
the engine's spans, the end of each job after its last mark (the
harness's garbage collection and release of the card's cache), and the
rest (between jobs: the next job's start before its first mark). It
also prints how well
the spans and the trace agree: the device time outside every job's
engine spans, as a share of the window's busy time, and how far before
its ``engine.setup`` a job's first device interval starts."""

import sys

from benchmark import spans

ENGINE = ("engine.setup", "engine.loop", "engine.replay_tail")


def read(run):
    if not spans.has_device(run):
        return None
    tr = run.trace
    jobs = [j for j in run.jobs if spans.of(j, "engine.loop")]
    if not jobs:
        return None
    part = dict.fromkeys(ENGINE, 0.0)
    busy_in_engine = lead = after = 0.0
    phases: dict = {}
    for j in jobs:
        eng = [(n, s[2], s[3]) for n in ENGINE for s in spans.of(j, n)]
        for n, a, b in eng:
            part[n] += spans.idle(tr, a, b)
            busy_in_engine += tr.busy(a, b)
        for p, a, b in j.phase_spans():
            inner = sum(spans.idle(tr, max(a, lo), min(b, hi))
                        for _, lo, hi in eng if lo < b and hi > a)
            phases[p] = phases.get(p, 0.0) + spans.idle(tr, a, b) - inner
        if j.times:
            after += spans.idle(tr, j.times[-1][0], j.end)
        t_setup = min(a for n, a, _ in eng if n == "engine.setup")
        early = (tr.start >= j.start) & (tr.start < t_setup)
        if early.any():
            lead = max(lead, t_setup - float(tr.start[early].min()))
    window_idle = spans.idle(tr, tr.t0, tr.t1)
    outside = window_idle - part["engine.loop"]
    rest = outside - part["engine.setup"] - part["engine.replay_tail"] - \
        sum(phases.values()) - after
    n = len(jobs)
    busy = tr.busy(tr.t0, tr.t1)
    split = ", ".join(f"{k} {v / n:.6g}" for k, v in (
        [("engine.setup", part["engine.setup"]),
         ("engine.replay_tail", part["engine.replay_tail"])]
        + [(f"matcher.{p}", v) for p, v in phases.items()]
        + [("after_last_mark", after), ("between_jobs", rest)]))
    print(f"bench: device idle s a job: in loops "
          f"{part['engine.loop'] / n:.6g}, outside {outside / n:.6g} "
          f"({split}); device busy outside the engine's spans "
          f"{busy - busy_in_engine:.6g} s of {busy:.6g} s "
          f"({100.0 * (busy - busy_in_engine) / busy:.4g}%); first device "
          f"interval before engine.setup by at most {1e3 * lead:.4g} ms",
          file=sys.stderr)
    return outside / n
