"""One run of one cell: set-up, the timed window of whole all-vs-all jobs,
the check against the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix or metric is
found by name: the cell in ``BENCHMARK.json``, its configuration at the
cell's ``file``, its mix at ``benchmark/traffic/<traffic>.json``, and each
metric's reader at ``benchmark/metrics/<metric>.py`` (a module with
``read(run) -> float | None``; None leaves the metric out of the line).

The program under test is ``lzani_tpu_torch``: the window drives its
normal path, ``Matcher(params).run_all2all()``, one fresh ``Matcher`` a
job, which loads, reorders, matches and stores. Jobs alternate between
two collections generated from the seed; once ``--seconds`` have passed
the job in flight finishes, so no job is cut. Between jobs the card's
cached memory is handed back, so that every job sizes its launches from
the free memory a fresh process of the tool would see.

Beside the metrics, each run reports its set-up by phase, whether it
built the program's libraries (a checkout's first run does), and the
host's load in the window (``hostload``), on standard error and in the
result line.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
#: top-level modules that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "lzani_tpu")
#: phase marks of ``Matcher.times`` and the host phase each one ends
PHASES = (("Loading sequences", "load"), ("Loading filter", "load"),
          ("Comparing sequence and filter compatibility", "load"),
          ("Reordering sequences", "reorder"), ("LZ matching", "match"),
          ("Storing results", "store"))


class NoCard(RuntimeError):
    pass


def load_cell(root: str, name: str) -> dict:
    """The cell `name` of ``root/BENCHMARK.json`` with its configuration,
    its mix, and the metrics it reports (end-to-end and per-layer)."""
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    with open(os.path.join(root, cfg_entry["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(root, "benchmark", "traffic",
                           cell["traffic"] + ".json")) as fh:
        traffic = json.load(fh)

    def reported(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return dict(root=root, cell=cell, config=config, traffic=traffic,
                end_to_end=reported(spec["end_to_end"]),
                per_layer=reported(spec["per_layer"]))


def load_reader(root: str, metric: str):
    """The ``read`` function of ``benchmark/metrics/<metric>.py``."""
    path = os.path.join(root, "benchmark", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Job:
    """One timed all-vs-all job: its collection, its pairs, the program's
    phase marks (``Matcher.times``) and engine counters, its host-clock
    span, and the files it wrote."""

    def __init__(self, k, coll, pairs, tsv, ids):
        self.k, self.coll, self.pairs, self.tsv, self.ids = \
            k, coll, pairs, tsv, ids
        self.times: list[tuple[float, str]] = []
        self.stats: dict = {}
        self.start = self.end = 0.0
        self.error: str | None = None
        self.host: dict = {}
        self.threads = 0

    def phase_spans(self):
        """(phase, start, end) of each mark of ``Matcher.times``; a phase
        named twice in PHASES is the sum of its marks."""
        out = []
        for (t_prev, _), (t, label) in zip(self.times, self.times[1:]):
            for mark, phase in PHASES:
                if label == mark:
                    out.append((phase, t_prev, t))
        return out

    def phase_s(self, *phases) -> float:
        return sum(b - a for p, a, b in self.phase_spans() if p in phases)


class Run:
    """What the metric readers read: the cell, the jobs, the window
    (host clock), the set-up seconds, the collections' genome lengths,
    the device's name, and the reduced trace (None without --trace 1)."""

    def __init__(self, cell):
        self.cell = cell
        self.jobs: list[Job] = []
        self.t0 = self.t1 = 0.0
        self.setup_s = 0.0
        self.setup: dict = {}
        self.lengths: list[list[int]] = []
        self.device_kind = ""
        self.trace = None
        self.host: dict = {}

    @property
    def ok_jobs(self) -> list[Job]:
        return [j for j in self.jobs if j.error is None]


def make_params(config: dict, fasta: str, out: str):
    """The program's ``Params`` of one job of `config`."""
    from lzani_tpu_torch.params import Params

    pr = config["params"]
    p = Params(output_format=config["output"]["format"])
    (p.min_anchor_len, p.min_seed_len, p.max_dist_in_ref,
     p.max_dist_in_query, p.min_region_len, p.approx_window,
     p.approx_mismatches, p.approx_run_len) = (
        int(pr[k]) for k in ("mal", "msl", "mrd", "mqd", "reg", "aw", "am",
                             "ar"))
    p.backend = config["backend"]
    p.no_threads = int(config["threads"])
    p.verbosity_level = 0
    p.input_file_names = [fasta]
    p.output_file_name = out
    return p


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _read_lines(path: str) -> list[str] | None:
    try:
        with open(path, "rb") as fh:
            return fh.read().decode("latin-1").splitlines(keepends=True)
    except OSError:
        return None


def _build_files(root: str) -> dict:
    """(size, mtime) of each file of the program's build directory."""
    out = {}
    d = os.path.join(root, "lzani_tpu_torch", "_build")
    with contextlib.suppress(OSError):
        for e in os.scandir(d):
            with contextlib.suppress(OSError):
                st = e.stat()
                out[e.name] = (st.st_size, st.st_mtime_ns)
    return out


def run(cell: dict, seed: int, seconds: float, trace: bool,
        t_start: float, device=None) -> dict:
    """One run of `cell`; returns the result line's object. `device` None
    means the first CUDA card, and a missing card raises NoCard; the
    tests pass ``"cpu"`` (the kernels' plain versions) at small sizes."""
    import torch

    from . import check, generate, hostload
    from .reference import tsv

    root, config, traffic = cell["root"], cell["config"], cell["traffic"]
    chips = int(cell["cell"]["chips"])
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            raise NoCard(f"this cell needs {chips} CUDA card(s); torch sees "
                         f"{torch.cuda.device_count()}")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"
    cache = os.path.join(root, ".bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)
    built_before = _build_files(root)

    from lzani_tpu_torch.matcher import Matcher

    res = Run(cell)
    phases = res.setup
    t = time.perf_counter()
    phases["imports_s"] = t - t_start
    if on_card:
        torch.empty(1, device=device)
        torch.cuda.synchronize(device)
        res.device_kind = torch.cuda.get_device_name(device)
    else:
        res.device_kind = "cpu"
    phases["context_s"] = time.perf_counter() - t
    _log(f"bench: {cell['cell']['name']} seed {seed} on {res.device_kind}; "
         f"host cores {os.cpu_count()}, affinity "
         f"{len(os.sched_getaffinity(0))}, threads {config['threads']} "
         f"(0 = all), torch intra-op {torch.get_num_threads()}")

    work = tempfile.mkdtemp(prefix="lzbench-")
    try:
        cols = []
        t_gen = t_write = 0.0
        for c in (0, 1):
            t = time.perf_counter()
            names, codes, fam = generate.collection(
                seed, c, config["collection"], traffic)
            t_gen += time.perf_counter() - t
            t = time.perf_counter()
            fasta = os.path.join(work, f"collection{c}.fna")
            generate.write_fasta(fasta, names, codes)
            t_write += time.perf_counter() - t
            cols.append((names, codes, fam, fasta))
            res.lengths.append([len(x) for x in codes])
        phases["generate_s"], phases["write_s"] = t_gen, t_write

        # one small warm job of the cell's own shapes: the longest genomes
        t = time.perf_counter()
        names, codes, _, _ = cols[0]
        warm = sorted(range(len(codes)), key=lambda i: -len(codes[i]))[
            :int(config["warm_genomes"])]
        fasta = os.path.join(work, "warm.fna")
        generate.write_fasta(fasta, [names[i] for i in warm],
                             [codes[i] for i in warm])
        if not Matcher(make_params(config, fasta,
                                   os.path.join(work, "warm.tsv")),
                       device=None if on_card else device).run_all2all():
            raise RuntimeError("the warm job failed")
        gc.collect()
        if on_card:
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
        phases["warm_job_s"] = time.perf_counter() - t
        phases["built"] = _build_files(root) != built_before

        if trace:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if on_card else []))
        else:
            prof = contextlib.nullcontext()
        marks = []
        with prof:
            res.t0 = time.perf_counter()
            res.setup_s = res.t0 - t_start
            h0 = hostload.snapshot()
            k = 0
            while True:
                c = k % 2
                n = len(cols[c][1])
                out = os.path.join(work, f"job{k}.tsv")
                job = Job(k, c, n * (n - 1), out,
                          os.path.join(work, f"job{k}.ids.tsv"))
                params = make_params(config, cols[c][3], out)
                m = Matcher(params, device=None if on_card else device)
                span = (torch.profiler.record_function(f"bench.job{k}")
                        if trace else contextlib.nullcontext())
                h_job = hostload.snapshot()
                job.start = time.perf_counter()
                with span:
                    marks.append((f"bench.job{k}", time.perf_counter()))
                    try:
                        if not m.run_all2all():
                            job.error = "run_all2all returned False"
                    except Exception as exc:    # a failed job is counted
                        job.error = repr(exc)
                job.times = list(m.times)
                job.stats = dict(m.engine_stats or {})
                job.threads = params.no_threads
                # what a fresh process of the tool would start from
                del m
                gc.collect()
                if on_card:
                    torch.cuda.empty_cache()
                job.end = time.perf_counter()
                job.host = hostload.between(h_job, hostload.snapshot())
                res.jobs.append(job)
                k += 1
                if job.end - res.t0 >= seconds:
                    break
            res.t1 = res.jobs[-1].end
            res.host = hostload.between(h0, hostload.snapshot())
        res.host.update(cores=os.cpu_count(),
                        affinity=len(os.sched_getaffinity(0)),
                        torch_threads=torch.get_num_threads(),
                        replay_threads=res.jobs[0].threads)
        log_jobs(res)
        peak = 0
        if on_card:
            torch.cuda.synchronize(device)
            peak = int(torch.cuda.max_memory_allocated(device))
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

        if trace:
            from .trace import Trace

            res.trace = Trace.from_profiler(prof, marks, res.t0, res.t1)
        del prof

        # the check: the plain reference against the files the jobs wrote
        lz_cfg = check.lz_cfg(config["params"])
        comps = tsv.FORMATS[config["output"]["format"]]
        refs = [check.Collection(names, codes, lz_cfg,
                                 check.sample_of(seed, c, fam, codes,
                                                 config["check"]), comps)
                for c, (names, codes, fam, _) in enumerate(cols)]
        workers = min(int(config["check"].get("workers", 1)),
                      os.cpu_count() or 1)
        t = time.perf_counter()
        check.compute_all(refs, workers)
        _log(f"bench: reference: {sum(len(r.sample) for r in refs)} pairs "
             f"on {workers} process(es) in {time.perf_counter() - t:.1f} s")
        nums = dict.fromkeys(check.LIMITS, 0)
        for job in res.jobs:
            if job.error is not None:
                _log(f"bench: job {job.k} failed: {job.error}")
                nums["jobs_failed"] += 1
            got = check.compare_job(refs[job.coll], _read_lines(job.tsv),
                                    _read_lines(job.ids))
            for key, v in got.items():
                nums[key] += v
            for path in (job.tsv, job.ids):
                with contextlib.suppress(OSError):
                    os.remove(path)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    metrics = {}
    for m in (cell["per_layer"] if trace else cell["end_to_end"]):
        v = load_reader(root, m["name"])(res)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    attempted = sum(j.pairs for j in res.jobs)
    failed = sum(j.pairs for j in res.jobs if j.error is not None)
    checks = {k: {"value": v, "limit": check.LIMITS[k]}
              for k, v in nums.items()}
    out = {"correct": all(v <= check.LIMITS[k] for k, v in nums.items()),
           "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if on_card else "cpu",
                      "kind": res.device_kind, "count": chips if on_card
                      else 0, "memory_peak_bytes": peak}}
    if res.trace is not None:
        tr = res.trace
        out["device"]["busy_s"] = tr.busy(tr.t0, tr.t1)
        out["device"]["window_s"] = tr.t1 - tr.t0
        out["breakdown"] = {
            "device_ops": [[n, s] for n, s in tr.by_name()[:10]],
            "idle_gaps": idle_gaps(res, 10)}
    out["setup"] = res.setup
    out["host"] = res.host
    out["checks"] = checks
    return out


def log_jobs(res: Run) -> None:
    """The window's jobs on standard error, one line each: phases, engine
    counters, launch shape and the host's readings."""
    _log(f"bench: {len(res.jobs)} jobs, "
         f"{sum(j.pairs for j in res.jobs)} pairs in "
         f"{res.t1 - res.t0:.3f} s; set-up {res.setup_s:.3f} s "
         f"{json.dumps(res.setup)}; host {json.dumps(res.host)}")
    for j in res.jobs:
        st, h = j.stats, j.host
        _log(f"bench: job {j.k}: {j.end - j.start:.3f} s; load "
             f"{j.phase_s('load', 'reorder'):.3f}, match "
             f"{j.phase_s('match'):.3f} (dispatch "
             f"{st.get('dispatch_s', 0):.3f}, sync "
             f"{st.get('download_sync_s', 0):.3f}, replay tail "
             f"{st.get('replay_tail_s', 0):.3f}), store "
             f"{j.phase_s('store'):.3f}; fallbacks "
             f"{st.get('cap_fallbacks', 0) + st.get('big_cap_fallbacks', 0)}"
             f"; G_big {st.get('G_big', 0)} B_big {st.get('B_big', 0)} "
             f"units {sum(st.get('device_units', []))}; host busy "
             f"{h.get('host_busy', -1):.3f} steal "
             f"{h.get('host_steal', -1):.4f} iowait "
             f"{h.get('host_iowait', -1):.4f}, process cpu "
             f"{h['proc_cpu_s']:.2f} s, switches {h['nvcsw']}/"
             f"{h['nivcsw']}, MHz {h.get('mhz', -1):.0f}, load "
             f"{h['load1']:.2f}")


def idle_gaps(res: Run, top: int) -> list[list]:
    """The `top` longest idle stretches of the device in the traced
    window, each named by the host phases in which it began and ended
    (``job<k>.<phase>``, or ``between_jobs``), joined by ``>`` where they
    differ."""
    spans = []
    for job in res.jobs:
        spans += [(a, b, f"job{job.k}.{p}") for p, a, b in job.phase_spans()]

    def phase_at(t):
        return next((nm for lo, hi, nm in spans if lo <= t < hi),
                    "between_jobs")

    out = []
    for a, b in sorted(res.trace.gaps(), key=lambda g: g[0] - g[1])[:top]:
        first, last = phase_at(a), phase_at(b)
        out.append([first if first == last else f"{first}>{last}", b - a])
    return out


def forbidden_modules() -> list[str]:
    """Modules of ``sys.modules`` whose top-level name (the part before
    the first dot) is one of FORBIDDEN, compared whole."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = load_cell(ROOT, args.workload)
    except (OSError, KeyError, ValueError) as exc:
        _log(f"bench: cannot load the cell: {exc!r}")
        return 2
    try:
        out = run(cell, args.seed, args.seconds, bool(args.trace), t_start)
    except NoCard as exc:
        _log(f"bench: {exc}")
        return 3
    bad = forbidden_modules()
    if bad:
        _log(f"bench: the process holds modules it must not: {bad}")
        return 4
    for k, v in out["checks"].items():
        _log(f"check {k}: {v['value']} (limit {v['limit']})")
    print(json.dumps(out), flush=True)
    return 0
