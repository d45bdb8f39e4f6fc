"""engine.setup_s: the cuda engine's counter ``setup_s``
(``all2all_cuda(stats=)``, read through ``Matcher.engine_stats``): entry
to the first dispatch (the query matrix packed and uploaded, routing,
the unit plan), the mean per job over the window's jobs. It spans the
same interval as the engine's ``engine.setup`` span, which the idle
split of ``device.idle_outside_loop_s`` reads."""


def read(run):
    vals = [j.stats["setup_s"] for j in run.ok_jobs if "setup_s" in j.stats]
    return sum(vals) / len(vals) if vals else None
