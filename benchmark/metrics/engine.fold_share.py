"""engine.fold_share: of the pairs the group kernel parsed with a log
(the cuda engine's ``kernel_pairs``), the share whose triples the fold
kernel computed on the card (``fold_pairs``), over the window's jobs
(``Matcher.engine_stats``), in %. A program that does not fold on that
route has no ``fold_pairs`` and reads None, as does a window without
kernel pairs."""


def read(run):
    jobs = [j for j in run.ok_jobs
            if "fold_pairs" in j.stats and "kernel_pairs" in j.stats]
    kernel = sum(j.stats["kernel_pairs"] for j in jobs)
    if not kernel:
        return None
    return 100.0 * sum(j.stats["fold_pairs"] for j in jobs) / kernel
