"""The cuda engine's spans (``ops/spans.py``): recorded only under a
running torch profiler, one set per work unit
under the unit's id, inside the engine's loop, adding up to the engine's
counters, and leaving the outputs as they are; the automaton backend's
(``all2all_jax``), one set per reference row; the benchmark's readers
of them, on a traced run of the harness on the CPU and on made-up
traces. The device spans' clock is checked on a card (marked ``cuda``)."""
import contextlib
import json
import re
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness, work
from benchmark.tests import tiny
from benchmark.trace import Trace
from lzani_tpu_torch import cli as tcli
from lzani_tpu_torch import synth
from lzani_tpu_torch.matcher import Matcher
from lzani_tpu_torch.ops import cuda_engine as tce
from lzani_tpu_torch.ops import engine_jax as tej
from lzani_tpu_torch.ops import spans as tsp
from lzani_tpu_torch.params import Params
from lzani_tpu_torch.synth import mutate, write_fasta

CPU = torch.device("cpu")
UNIT_SPANS = ("unit.prep", "unit.launch", "unit.sync_ahead", "unit.copy",
              "unit.queue", "unit.replay")
#: spans recorded on the replay pool's threads
POOL_SPANS = ("unit.queue", "unit.replay")
SPAN_METRICS = ("engine.index_s", "engine.sync_ahead_s", "replay.queue_s")
HOST_METRICS = ("engine.setup_s",) + SPAN_METRICS
DEVICE_METRICS = ("engine.join_device_s", "engine.prep_device_s",
                  "kernels.parse_device_s", "device.idle_in_loop_s",
                  "device.idle_outside_loop_s")


def _codes(seed, n=7, length=600):
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 4, length).astype(np.uint8)
    return [mutate(rng, base, 0.01 + 0.03 * k, n_ns=k % 2, indels=k % 3)
            for k in range(n)]


def _params(path):
    """The group path ("group" replayed, "fold" folded on the device), or
    (mal > 13) the long-genome path."""
    p = Params()
    if path == "big":
        p.min_anchor_len, p.min_seed_len = 14, 9
    return p


def _regions(path, tmp_path):
    """The region file of a run on `path`: the group path's logs are
    replayed on the host only where regions are asked."""
    return {} if path == "fold" else {
        "region_path": str(tmp_path / "regions.bin")}


class _NoEvent:
    def __init__(self, *a, **kw):
        raise AssertionError("a CUDA event was made with spans off")


def test_spans_are_off_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _NoEvent)
    assert not tsp.requested()
    st = {}
    tce.all2all_cuda(_codes(1, n=5), Params(), device=CPU, stats=st)
    assert "spans" not in st and st["dispatches"] > 0


def test_the_profilers_flag_turns_spans_on():
    """``requested`` reads a private flag of torch's profiler; without it
    no run would record spans."""
    assert hasattr(torch.autograd.profiler, "_is_profiler_enabled"), \
        "torch.autograd.profiler._is_profiler_enabled is gone: " \
        "spans.requested() can no longer see a running profiler"
    assert not tsp.requested()
    with profile(activities=[ProfilerActivity.CPU]):
        assert tsp.requested()
    assert not tsp.requested()


def _traced(codes, p, **kw):
    st = {}
    with profile(activities=[ProfilerActivity.CPU]):
        out = tce.all2all_cuda(codes, p, device=CPU, stats=st, **kw)
    return out, st


@pytest.mark.parametrize("path", ["group", "big", "fold"])
def test_each_unit_has_its_spans_inside_the_loop(path, tmp_path):
    """Each unit's spans, once each; a folded unit has no pair for the
    pool, so no ``unit.queue`` or ``unit.replay``."""
    _, st = _traced(_codes(2), _params(path), **_regions(path, tmp_path))
    sp = st["spans"]
    assert all(len(s) == 5 and s[2] <= s[3] for s in sp)
    eng = {s[0]: s for s in sp if s[1] is None}
    assert sorted(eng) == ["engine.loop", "engine.replay_tail",
                           "engine.setup"]
    setup, loop, tail = (eng[k] for k in ("engine.setup", "engine.loop",
                                          "engine.replay_tail"))
    assert setup[3] == loop[2] and loop[3] == tail[2]
    units = [s for s in sp if s[1] is not None]
    n = st["dispatches"]
    assert n >= (2 if path == "group" else 1)
    assert {s[1] for s in units} == set(range(n))
    for k in range(n):
        names = sorted(s[0] for s in units if s[1] == k)
        if path == "fold":
            assert all(names.count(x) == (x not in POOL_SPANS)
                       for x in UNIT_SPANS), (k, names)
            continue
        assert all(names.count(x) == 1 for x in UNIT_SPANS), (k, names)
        queue, replay = (next(s for s in units if s[1] == k and s[0] == x)
                         for x in POOL_SPANS)
        assert replay[2] >= queue[3] and replay[4] == queue[4], k
    assert not [s for s in sp if s[0].startswith("dev.")]  # no card
    assert min(s[2] for s in units) >= setup[3]
    for s in units:
        if s[0] in POOL_SPANS:                      # the pool's threads
            assert loop[2] <= s[2] and s[3] <= tail[3], s
            assert s[4] != "MainThread"
        else:
            assert loop[2] <= s[2] and s[3] <= loop[3], s
            assert s[4] == "MainThread"
    assert sum(s[0] == "unit.index" for s in units) >= 1


@pytest.mark.parametrize("path", ["group", "big", "fold"])
def test_spans_add_up_to_the_counters(path, tmp_path):
    _, st = _traced(_codes(3), _params(path), **_regions(path, tmp_path))
    total = {}
    for name, _, t0, t1, _ in st["spans"]:
        total[name] = total.get(name, 0.0) + (t1 - t0)
    # on the CPU there is no stream: the whole sync is sync_ahead
    assert "unit.sync_own" not in total
    assert total["unit.sync_ahead"] == pytest.approx(st["download_sync_s"],
                                                     abs=1e-9)
    assert (total["unit.index"] + total["unit.prep"] + total["unit.launch"]
            <= st["dispatch_s"] + 1e-3)
    assert total["engine.setup"] == pytest.approx(st["setup_s"], abs=1e-9)
    assert total["engine.replay_tail"] == pytest.approx(
        st["replay_tail_s"], abs=1e-9)
    assert st["native_rows"] == 0
    if path == "fold":
        # no pair left for the pool: no replay call, no replay span
        assert "unit.replay" not in total and st["replay_c_s"] == 0
        assert st["fold_pairs"] == st["kernel_pairs"] > 0
        return
    # each unit's replay span holds its native call
    assert total["unit.replay"] >= st["replay_c_s"] > 0


class _StageLog:
    """A unit's spans that list the device stages it enters and leaves."""

    def __init__(self):
        self.log = []

    @contextlib.contextmanager
    def stage(self, name):
        self.log.append(("+", name))
        yield
        self.log.append(("-", name))


@pytest.mark.parametrize("path", ["group", "big"])
def test_each_build_records_dev_refs_once_before_its_join(path):
    """An index build records ``dev.refs`` once, then ``dev.join``, which
    holds the long-genome join's own stages; ``dev.refs`` is outside it,
    so ``engine.join_device_s`` reads the join alone."""
    eng = tce.CudaAll2All(_codes(5), _params(path), devices=[CPU])
    r_lists = ([0, 3, -1, -1], [-1] * 4) if path == "group" else ([0, 2],
                                                                 [4])
    if path == "big":
        eng.big_launch_shape(2, CPU)
    for r_list in r_lists:
        rec = _StageLog()
        eng.routes[path].build(r_list, CPU, rec)
        assert rec.log[:3] == [("+", "dev.refs"), ("-", "dev.refs"),
                               ("+", "dev.join")], rec.log
        assert rec.log[-1] == ("-", "dev.join")
        assert [s for s in rec.log if s[1] == "dev.refs"] == rec.log[:2]
        inner = {n for _, n in rec.log[3:-1]}
        assert inner == (set() if path == "group" else {"dev.kmers",
                                                        "dev.sort"})


def test_outputs_equal_with_spans_on_and_off(tmp_path):
    codes = _codes(4)
    rp = [str(tmp_path / f"r{k}.bin") for k in range(2)]
    off = tce.all2all_cuda(codes, Params(), device=CPU, region_path=rp[0],
                           replay_threads=1)
    on, st = _traced(codes, Params(), region_path=rp[1], replay_threads=1)
    assert st["spans"] and off.tobytes() == on.tobytes()
    with open(rp[0], "rb") as a, open(rp[1], "rb") as b:
        assert a.read() == b.read()


def test_matcher_logs_a_span_count(tmp_path, capsys):
    fa = str(tmp_path / "in.fna")
    codes = _codes(5, n=4)
    write_fasta(fa, [f"s{k}" for k in range(len(codes))], codes)
    argv = ["all2all", "--in-fasta", fa, "--out", str(tmp_path / "o.tsv"),
            "-t", "2", "-V", "2", "--backend", "cuda"]
    m = Matcher(tcli.parse_args(argv), device=CPU)
    with profile(activities=[ProfilerActivity.CPU]):
        assert m.run_all2all()
    n = len(m.engine_stats["spans"])
    line = [ln for ln in capsys.readouterr().err.splitlines()
            if ln.startswith("lz-ani-torch engine: ")]
    assert n > 0 and len(line) == 1
    assert json.loads(line[0].split(": ", 1)[1])["spans"] == n
    m = Matcher(tcli.parse_args(argv[:-3] + ["0", "--backend", "cuda"]),
                device=CPU)
    assert m.run_all2all() and "spans" not in m.engine_stats


def test_a_traced_harness_run_reports_the_span_metrics(tmp_path):
    cell = harness.load_cell(tiny.make_root(tmp_path), "tiny")
    out = harness.run(cell, 2**31 + 7, 0.01, True, time.perf_counter(),
                      device="cpu")
    assert out["correct"], out["checks"]
    got = out["metrics"]
    # every pair of the tiny cell is folded: the pool gets no unit, so
    # replay.queue_s has nothing to read
    for m in HOST_METRICS:
        if m != "replay.queue_s":
            assert got[m]["unit"] == "s" and got[m]["value"] >= 0, m
    assert "replay.queue_s" not in got
    assert got["engine.fold_share"] == {"value": 100.0, "unit": "%"}
    assert not set(DEVICE_METRICS) & set(got)
    assert got["engine.sync_ahead_s"]["value"] == pytest.approx(
        got["engine.download_sync_s"]["value"], rel=1e-6)


class _Job:
    def __init__(self, stats, start=0.0, end=0.0, times=()):
        self.stats, self.start, self.end = stats, start, end
        self.times, self.error = list(times), None

    def phase_spans(self):
        return harness.Job.phase_spans(self)


class _Run:
    def __init__(self, jobs, trace=None):
        self.jobs, self.trace = jobs, trace

    ok_jobs = property(lambda self: self.jobs)


def _reader(name):
    return harness.load_reader(harness.ROOT, name)


def test_the_readers_find_nothing_without_spans():
    """A program without spans (the parent of this change) reads None in
    every new metric that reads spans, traced or not; engine.setup_s
    reads the engine's counter ``setup_s``, which that program has."""
    tr = Trace([0.5], [0.6], ["k"], 0.0, 2.0)
    for trace in (None, tr):
        run = _Run([_Job({"dispatch_s": 1.0, "setup_s": 0.25}),
                    _Job({"dispatch_s": 1.0, "setup_s": 0.75})], trace)
        for m in SPAN_METRICS + DEVICE_METRICS:
            assert _reader(m)(run) is None, m
        assert _reader("engine.setup_s")(run) == pytest.approx(0.5)
    assert _reader("engine.setup_s")(_Run([_Job({})])) is None


def test_the_device_readers_split_the_idle_time(capsys):
    """Two jobs on a made-up trace: each loop [1, 3) is busy 0.5 s, each
    set-up [0.8, 1) and replay tail [3, 3.2) idle, the rest of the job
    (load, store and the 0.1 s after its last mark) idle, and the window
    0-8 s."""
    def job(t, k):
        sp = [("engine.setup", None, t + 0.8, t + 1.0, "MainThread"),
              ("engine.loop", None, t + 1.0, t + 3.0, "MainThread"),
              ("engine.replay_tail", None, t + 3.0, t + 3.2, "MainThread"),
              ("dev.kernel", 0, t + 1.2, t + 1.5, "cuda:0"),
              ("dev.kernel", 1, t + 2.0, t + 2.2, "cuda:0"),
              ("unit.queue", 0, t + 1.6, t + 1.7, "pool"),
              ("unit.queue", 1, t + 2.3, t + 2.6, "pool")]
        marks = [(t, "Start"), (t + 0.5, "Loading sequences"),
                 (t + 3.5, "LZ matching"), (t + 3.9, "Storing results")]
        return _Job({"spans": sp}, start=t, end=t + 4.0, times=marks)

    tr = Trace([1.2, 2.0, 5.2, 6.0], [1.5, 2.2, 5.5, 6.2], ["k"] * 4,
               0.0, 8.0)
    run = _Run([job(0.0, 0), job(4.0, 1)], tr)
    assert _reader("device.idle_in_loop_s")(run) == pytest.approx(1.5)
    # window idle 7 s, 3 s of it in the loops: 2 s a job outside
    assert _reader("device.idle_outside_loop_s")(run) == pytest.approx(2.0)
    err = capsys.readouterr().err
    assert "unit.index 0, " in err and "other 1.5;" in err
    assert "dev.kernel 0.5 / 0.5" in err
    assert "engine.setup 0.2," in err and "engine.replay_tail 0.2," in err
    assert "after_last_mark 0.1," in err
    busy_out = re.search(r"busy outside the engine's spans (\S+) s", err)
    assert float(busy_out.group(1)) == pytest.approx(0.0, abs=1e-9)
    assert _reader("kernels.parse_device_s")(run) == pytest.approx(0.5)
    assert _reader("replay.queue_s")(run) == pytest.approx(0.2)


#: the long-genome path's readers of spans, and the span each one sums
BIG_SPAN_METRICS = {"big.kmers_device_s": "dev.kmers",
                    "big.sort_device_s": "dev.sort",
                    "big.search_device_s": "dev.search",
                    "big.next_hit_device_s": "dev.next_hit",
                    "replay.big_wall_s": "unit.replay"}
H100 = "NVIDIA H100 80GB HBM3"


class _BigRun(_Run):
    def __init__(self, jobs, trace=None, lengths=(), kind=H100):
        super().__init__(jobs, trace)
        self.lengths, self.device_kind = [list(x) for x in lengths], kind


def _big_job(t, coll, big_pairs, spans=None):
    """A job over [t, t + 4) whose matching phase is [t + 0.5, t + 3.5)."""
    marks = [(t, "Start"), (t + 0.5, "Loading sequences"),
             (t + 3.5, "LZ matching"), (t + 3.9, "Storing results")]
    st = {"big_pairs": big_pairs}
    if spans is not None:
        st["spans"] = spans
    job = _Job(st, start=t, end=t + 4.0, times=marks)
    job.coll = coll
    return job


def test_the_long_genome_readers_find_nothing_without_their_spans():
    """A program without the long-genome path's spans (the parent of this
    change), or a run of the group path, reads None in each of them; the
    roofline of the long-genome kernel reads None without a trace, without
    a peak for the device or without an interval of that kernel."""
    group = [("dev.join", 0, 0.1, 0.2, "cuda:0"),
             ("dev.prep", 0, 0.3, 0.4, "cuda:0"),
             ("unit.queue", 0, 0.5, 0.6, "pool")]
    tr = Trace([1.0], [1.5], ["parse_group_kernel"], 0.0, 8.0)
    for spans in (None, group):
        run = _BigRun([_big_job(0.0, 0, 0, spans)], tr, [[1000, 2000]])
        for m in BIG_SPAN_METRICS:
            assert _reader(m)(run) is None, m
    read = _reader("kernels.big_roofline")
    lengths = [[3_000_000, 5_000_000]]
    for trace, kind, pairs in ((None, H100, 2), (tr, H100, 2),
                               (Trace([1.0], [1.5], ["parse_big_kernel"],
                                      0.0, 8.0), "cpu", 2),
                               (Trace([1.0], [1.5], ["parse_big_kernel"],
                                      0.0, 8.0), H100, 0)):
        run = _BigRun([_big_job(0.0, 0, pairs)], trace, lengths, kind)
        assert read(run) is None


def test_the_long_genome_readers_sum_their_spans(capsys):
    """Two jobs: each reader sums its spans a job and takes the mean over
    the jobs; ``kernels.big_roofline`` counts ``all_pairs_work`` scaled by
    ``big_pairs`` over the time of the intervals named
    ``parse_big_kernel`` inside the matching phases, and nothing else."""
    def spans(t, scale):
        return [(name, k, t + 0.6 + 0.1 * k, t + 0.6 + 0.1 * k
                 + scale * 0.01 * (i + 1) * (k + 1), dev)
                for i, (name, dev) in enumerate(
                    [("dev.kmers", "cuda:0"), ("dev.sort", "cuda:0"),
                     ("dev.search", "cuda:0"), ("dev.next_hit", "cuda:0"),
                     ("unit.replay", "pool")])
                for k in range(2)] + [("dev.kernel", 0, t + 1, t + 2,
                                       "cuda:0")]

    lengths = [[3_000_000, 3_100_000, 5_000_000, 5_200_000],
               [2_900_000, 5_100_000, 5_050_000]]
    jobs = [_big_job(0.0, 0, 10, spans(0.0, 1)),
            _big_job(4.0, 1, 6, spans(4.0, 3))]
    name = "void parse_big_kernel(unsigned int const*, int)"
    # kernel time inside matching: 0.2 (two overlapping intervals) + 0.3
    # (job 0), 0.4 (job 1); the interval at 3.6 lies in job 0's store,
    # and the other two are other operations
    tr = Trace([1.0, 1.1, 2.0, 3.6, 5.0, 5.0, 6.0],
               [1.2, 1.2, 2.3, 3.8, 5.4, 5.9, 6.5],
               [name, name, name, name, name, "parse_group_kernel",
                "Memcpy DtoH"], 0.0, 8.0)
    run = _BigRun(jobs, tr, lengths)
    for i, m in enumerate(BIG_SPAN_METRICS):
        # (0.01 + 0.02) * (i + 1) a job at scale 1, three times at 3
        assert _reader(m)(run) == pytest.approx(0.06 * (i + 1)), m
    compares = nbytes = 0.0
    for job in jobs:
        c, b, pairs = work.all_pairs_work(lengths[job.coll])
        big = job.stats["big_pairs"]
        compares += c * big / pairs
        nbytes += b - 12 * (pairs - big)
    least, _ = work.least_seconds(compares, nbytes, work.peaks(H100))
    got = _reader("kernels.big_roofline")(run)
    assert got == pytest.approx(100.0 * least / 0.9)
    err = capsys.readouterr().err
    assert f"{compares:.6g} compares, {nbytes:.6g} bytes" in err
    assert "parse_big_kernel 0.9 s" in err


#: the automaton backend's host spans, once a batch under the row's index
ROW_SPANS = ("row.index", "row.args", "row.launch", "row.download")
#: the automaton cell's readers of spans, and the span each one sums
AUTOMATON_SPAN_METRICS = {"automaton.index_s": "row.index",
                          "automaton.download_s": "row.download",
                          "kernels.row_parse_device_s": "dev.kernel",
                          "kernels.fold_device_s": "dev.fold"}


def _no_spans(*a, **kw):
    raise AssertionError("a span list was made with spans off")


def test_automaton_spans_are_off_by_default(monkeypatch):
    """Without a profiler ``all2all_jax`` makes no CUDA event, no span
    list and no ``spans`` key."""
    monkeypatch.setattr(torch.cuda, "Event", _NoEvent)
    monkeypatch.setattr(tej, "Spans", _no_spans)
    monkeypatch.setattr(tej, "UnitSpans", _no_spans)
    st = {}
    codes = synth.small_family()
    tej.all2all_jax(codes, Params(), device=CPU, stats=st)
    assert "spans" not in st and st["rows"] == len(codes)


def _traced_jax(codes, p, **kw):
    st = {}
    with profile(activities=[ProfilerActivity.CPU]):
        out = tej.all2all_jax(codes, p, device=CPU, stats=st, **kw)
    return out, st


@pytest.mark.parametrize("device", [CPU, [CPU, CPU]])
def test_each_row_has_its_automaton_spans_in_order(device):
    """Under a profiler, each row with a query records ``row.index`` once
    and ``row.args``, ``row.launch``, ``row.download`` once a shard (two
    shards a batch over two entries), in that order on the main thread,
    under the row's index; on the CPU no device span and, with no
    capacity fallback, no ``row.fallback``. The triples equal an untraced
    run's."""
    codes = synth.small_family()
    p = Params()
    off = tej.all2all_jax(codes, p, device=CPU)
    st = {}
    with profile(activities=[ProfilerActivity.CPU]):
        on = tej.all2all_jax(codes, p, device=device, stats=st)
    assert np.array_equal(on, off)
    sp = st["spans"]
    shards = 1 if device is CPU else 2
    assert st["rows"] == len(codes) and st["cap_fallbacks"] == 0
    assert {s[1] for s in sp} == set(range(len(codes)))
    assert all(len(s) == 5 and s[2] <= s[3] and s[4] == "MainThread"
               for s in sp)
    assert not [s for s in sp if s[0].startswith("dev.")
                or s[0] == "row.fallback"]
    for r in range(len(codes)):
        row = [s for s in sp if s[1] == r]
        names = [s[0] for s in row]
        assert names == ["row.index"] + ["row.args", "row.launch"] * shards \
            + ["row.download"] * shards, (r, names)
        assert all(a[3] <= b[2] for a, b in zip(row, row[1:])), r
    rows = sorted(sp, key=lambda s: s[2])
    assert [s[1] for s in rows] == sorted(s[1] for s in rows)


def test_automaton_fallbacks_have_their_span(monkeypatch):
    """Logs over the event cap are parsed natively after the download:
    one ``row.fallback`` for each row that has a fallback, after the
    row's ``row.download``."""
    monkeypatch.setattr(tej.CudaRefIndex, "MAXEV", 18)
    codes = synth.small_family()
    out, st = _traced_jax(codes, Params())
    assert np.array_equal(out, tej.all2all_jax(codes, Params(), device=CPU))
    assert st["cap_fallbacks"] > 0
    fb = [s for s in st["spans"] if s[0] == "row.fallback"]
    assert 0 < len(fb) <= st["cap_fallbacks"]
    assert len({s[1] for s in fb}) == len(fb)
    for s in fb:
        down = next(d for d in st["spans"]
                    if d[0] == "row.download" and d[1] == s[1])
        assert down[3] <= s[2], s


def test_the_automaton_readers_sum_their_spans():
    """Each reader sums its spans a job and takes the mean over the jobs
    that have spans; a program whose automaton backend records none
    reads None."""
    def spans(t, scale):
        return [(name, r, t + 0.1 * r, t + 0.1 * r
                 + scale * 0.01 * (i + 1), "cuda:0")
                for i, name in enumerate(AUTOMATON_SPAN_METRICS.values())
                for r in range(3)]

    run = _Run([_Job({"spans": spans(0.0, 1)}), _Job({"spans": spans(4.0, 3)}),
                _Job({"fold_pairs": 10})])
    for i, m in enumerate(AUTOMATON_SPAN_METRICS):
        # 3 spans of 0.01 * (i + 1) a job at scale 1, three times at 3
        assert _reader(m)(run) == pytest.approx(0.06 * (i + 1)), m
        assert _reader(m)(_Run([_Job({"fold_pairs": 10})])) is None, m


def test_the_automaton_roofline_reads_its_two_kernels(capsys):
    """``kernels.automaton_roofline`` counts ``all_pairs_work`` scaled by
    ``fold_pairs`` over the union of the intervals named
    ``parse_group_kernel`` or ``fold_kernel`` inside the matching phases;
    None without a trace, without folded pairs, without a peak for the
    device or without an interval of those kernels."""
    lengths = [[20_000, 35_000, 58_000, 41_000], [22_000, 57_000, 30_000]]
    jobs = [_big_job(0.0, 0, 0), _big_job(4.0, 1, 0)]
    jobs[0].stats = {"fold_pairs": 10}
    jobs[1].stats = {"fold_pairs": 6}
    parse = "void parse_group_kernel<true>(unsigned int const*, int)"
    fold = "void fold_kernel(unsigned int const*, int)"
    # job 0's matching [0.5, 3.5): parse [1.0, 1.2), fold [1.1, 1.4)
    # (overlapping: 0.4 s), fold [2.0, 2.3); the fold at 3.6 is in its
    # store, the long-genome kernel and the copy are other operations;
    # job 1's matching [4.5, 7.5): parse [5.0, 5.4), fold [5.4, 5.5)
    tr = Trace([1.0, 1.1, 2.0, 3.6, 5.0, 5.4, 5.0, 6.0],
               [1.2, 1.4, 2.3, 3.8, 5.4, 5.5, 5.9, 6.5],
               [parse, fold, fold, fold, parse, fold, "parse_big_kernel",
                "Memcpy DtoH"], 0.0, 8.0)
    read = _reader("kernels.automaton_roofline")
    compares = nbytes = 0.0
    for job in jobs:
        c, b, pairs = work.all_pairs_work(lengths[job.coll])
        folded = job.stats["fold_pairs"]
        compares += c * folded / pairs
        nbytes += b - 12 * (pairs - folded)
    least, _ = work.least_seconds(compares, nbytes, work.peaks(H100))
    assert read(_BigRun(jobs, tr, lengths)) == pytest.approx(
        100.0 * least / 1.2)
    err = capsys.readouterr().err
    assert f"{compares:.6g} compares, {nbytes:.6g} bytes" in err
    assert "parse_group_kernel + fold_kernel 1.2 s" in err
    unfolded = [_big_job(0.0, 0, 0)]
    unfolded[0].stats = {"fold_pairs": 0}
    other = Trace([1.0], [1.5], ["parse_big_kernel"], 0.0, 8.0)
    for run in (_BigRun(jobs, None, lengths), _BigRun(unfolded, tr, lengths),
                _BigRun(jobs, tr, lengths, "cpu"),
                _BigRun(jobs, other, lengths)):
        assert read(run) is None


# --- on a card -------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("path", ["group", "fold"])
def test_device_spans_share_the_hosts_clock(path, monkeypatch, tmp_path):
    """Each unit's kernel (``dev.kernel``) starts after its launch began
    on the host and ends before the host's wait for it ended, to 0.2 ms;
    a folded unit's ``dev.fold`` follows its kernel, inside the same
    wait; with spans off no CUDA event is made."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    _, codes = synth.viral_set(seed=5, n=24)
    p = Params()
    st = {}
    kw = _regions(path, tmp_path)
    with profile():
        ref = tce.all2all_cuda(codes, p, device=dev, stats=st, **kw)
    by = {}
    for s in st["spans"]:
        by.setdefault(s[1], {})[s[0]] = s
    n = st["dispatches"]
    assert n >= 2
    want = ("dev.prep", "dev.kernel", "unit.sync_own") + (
        ("dev.fold",) + tuple(x for x in UNIT_SPANS if x not in POOL_SPANS)
        if path == "fold" else ("dev.compact",) + UNIT_SPANS)
    for k in range(n):
        u = by[k]
        for name in want:
            assert name in u, (k, name)
        assert u["dev.kernel"][4] == str(dev)
        assert u["dev.kernel"][2] >= u["unit.launch"][2] - 2e-4, k
        assert u["dev.kernel"][3] <= u["unit.sync_own"][3] + 2e-4, k
        if path == "fold":
            assert u["dev.fold"][2] >= u["dev.kernel"][3] - 2e-4, k
            assert u["dev.fold"][3] <= u["unit.sync_own"][3] + 2e-4, k
            assert "dev.compact" not in u, k
    sync = sum(s[3] - s[2] for s in st["spans"]
               if s[0] in ("unit.sync_own", "unit.sync_ahead"))
    assert sync == pytest.approx(st["download_sync_s"], abs=1e-9)
    assert any(s[0] == "dev.join" for s in st["spans"])
    monkeypatch.setattr(torch.cuda, "Event", _NoEvent)
    st2 = {}
    if kw:
        kw = {"region_path": str(tmp_path / "off.bin")}
    out = tce.all2all_cuda(codes, p, device=dev, stats=st2, **kw)
    assert "spans" not in st2 and np.array_equal(out, ref)


@pytest.mark.cuda
def test_automaton_device_spans_share_the_hosts_clock(monkeypatch):
    """On a card each row's parse (``dev.kernel``) and fold (``dev.fold``)
    lie, in that order, inside the row's host interval from the start of
    its ``row.launch`` to the end of its ``row.download``, to 0.2 ms; with
    spans off no CUDA event is made and the triples are the same."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    _, codes = synth.viral_set(seed=5, n=24)
    p = Params()
    st = {}
    with profile():
        ref = tej.all2all_jax(codes, p, device=dev, stats=st)
    assert st["rows"] == len(codes)
    for r in range(len(codes)):
        u = {}
        for s in st["spans"]:
            if s[1] == r:
                u.setdefault(s[0], []).append(s)
        for name in ROW_SPANS + ("dev.kernel", "dev.fold"):
            assert len(u.get(name, ())) == 1, (r, name)
        (kern,), (fold,) = u["dev.kernel"], u["dev.fold"]
        assert kern[4] == fold[4] == str(dev)
        assert kern[2] >= u["row.launch"][0][2] - 2e-4, r
        assert kern[3] <= fold[2] + 2e-4, r
        assert fold[3] <= u["row.download"][0][3] + 2e-4, r
    monkeypatch.setattr(torch.cuda, "Event", _NoEvent)
    st2 = {}
    out = tej.all2all_jax(codes, p, device=dev, stats=st2)
    assert "spans" not in st2 and np.array_equal(out, ref)
