"""The port's hybrid scheduler (``lzani_tpu_torch.ops.hybrid``) on the CPU:
the native pool and the CUDA engine's plain version (``device="cpu"``)
take rows from one shared two-ended queue. Mirrors every behaviour that
``tests/test_hybrid.py`` pins for the JAX function, and holds the port's
result equal to the JAX function's (interpret mode) and to the native
engine: triples exactly, region records as a map."""
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from lzani_tpu.ops.hybrid import all2all_hybrid as jax_all2all_hybrid
from lzani_tpu.params import Params as JParams
from lzani_tpu_torch import cli as tcli
from lzani_tpu_torch.core import native_engine as tne
from lzani_tpu_torch.ops import cuda_engine as tce
from lzani_tpu_torch.ops import hybrid as hyb
from lzani_tpu_torch.params import Params
from lzani_tpu_torch.synth import write_fasta
from lzani_tpu_torch.utils import cudadev

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _codes(n, rng, lo=250, hi=700):
    """`n` relatives of one random base (10% substitutions), longest
    first, as the store's reorder leaves them (tests/test_hybrid.py)."""
    out = []
    base = rng.randint(0, 4, hi).astype(np.uint8)
    for _ in range(n):
        L = int(rng.randint(lo, hi))
        c = base[:L].copy()
        m = rng.rand(L) < 0.1
        c[m] = (c[m] + rng.randint(1, 4, m.sum())) % 4
        out.append(c)
    out.sort(key=len, reverse=True)
    return out


def _filter(n, rng):
    indptr = np.zeros(n + 1, np.int64)
    ids = []
    for r in range(n):
        ids.extend(sorted(set(int(q) for q in rng.choice(n, 4) if q != r)))
        indptr[r + 1] = len(ids)
    return indptr, np.array(ids, np.int32)


def _region_map(path):
    return {(r, q): regs.tobytes()
            for r, q, regs in tne.read_region_dump(str(path))}


@pytest.fixture()
def greedy_claims(monkeypatch):
    # lift the claim gates so the device side claims rows in small runs
    monkeypatch.setenv("LZANI_TPU_HYBRID_GREEDY", "1")


@pytest.fixture()
def slow_cpu(monkeypatch):
    """Hold the native pool back until the warm-up's dummy group has been
    collected, so the device side provably claims rows."""
    warm_done = threading.Event()
    real_cg = tce.CudaAll2All.collect_group

    def cg(self, handles):
        out = real_cg(self, handles)
        warm_done.set()
        return out

    monkeypatch.setattr(tce.CudaAll2All, "collect_group", cg)
    real = tne.all2all

    def delayed(codes, params, **kw):
        if kw.get("ext_counter") is not None:
            warm_done.wait(120.0)
            time.sleep(0.5)   # give the claim loop a beat to win rows
        return real(codes, params, **kw)

    monkeypatch.setattr(tne, "all2all", delayed)


def test_hybrid_matches_native_dense(greedy_claims, slow_cpu):
    p = Params()
    codes = _codes(10, np.random.RandomState(11))
    ref = tne.all2all(codes, p)
    st = {}
    out = hyb.all2all_hybrid(codes, p, device="cpu", cpu_threads=1,
                             stats=st)
    assert np.array_equal(ref, out)
    # the device side really claimed rows, and the split is a partition
    assert st["device_pairs"] > 0
    assert st["device_pairs"] + st["cpu_pairs"] == 10 * 9
    assert st["warm_why"] is None and st["failed_rows"] == 0
    assert st["replay_mismatches"] == 0 and st["native_rows"] == 0
    assert st["launches"] == 0          # the plain version never counts


def test_hybrid_matches_native_filter(greedy_claims, slow_cpu):
    p = Params()
    rng = np.random.RandomState(12)
    codes = _codes(9, rng)
    csr = _filter(len(codes), rng)
    ref = tne.all2all(codes, p, filter_csr=csr)
    st = {}
    out = hyb.all2all_hybrid(codes, p, filter_csr=csr, device="cpu",
                             cpu_threads=1, stats=st)
    assert np.array_equal(ref, out)
    assert st["device_pairs"] > 0
    assert st["device_pairs"] + st["cpu_pairs"] == len(csr[1])


def test_hybrid_regions_merge(tmp_path, greedy_claims, slow_cpu):
    """Regions from both executors land in one dump: the native pool
    writes the file, the device side's records are appended."""
    p = Params()
    codes = _codes(8, np.random.RandomState(13))
    ref = tne.all2all(codes, p, region_path=str(tmp_path / "native"))
    st = {}
    out = hyb.all2all_hybrid(codes, p, region_path=str(tmp_path / "hybrid"),
                             device="cpu", cpu_threads=1, stats=st)
    assert np.array_equal(ref, out)
    assert st["device_pairs"] > 0
    assert not os.path.exists(str(tmp_path / "hybrid") + ".device")
    assert _region_map(tmp_path / "native") == _region_map(
        tmp_path / "hybrid")


def test_hybrid_recovers_from_device_failure(greedy_claims, slow_cpu,
                                             monkeypatch, capsys):
    """A device that dies after the warm-up loses no claimed row: the
    rows are re-run on the host, the result stays exact, and the run
    says so at -V 1 and in its stats."""
    p = Params()
    codes = _codes(10, np.random.RandomState(21))
    ref = tne.all2all(codes, p)
    calls = {"n": 0}
    real = tce.CudaAll2All.collect_group

    def dying(self, handles):
        calls["n"] += 1
        if calls["n"] > 1:  # the first call is the warm-up's
            raise RuntimeError("injected device crash")
        return real(self, handles)

    monkeypatch.setattr(tce.CudaAll2All, "collect_group", dying)
    st = {}
    out = hyb.all2all_hybrid(codes, p, device="cpu", cpu_threads=1,
                             stats=st)
    assert calls["n"] > 1  # the device really claimed and then died
    assert np.array_equal(ref, out)
    assert st["failed_rows"] > 0 and st["device_pairs"] == 0
    assert "recovered on the host" in capsys.readouterr().err


def _hold_native_until(monkeypatch, event):
    """Hold the hybrid's native pool until `event` is set."""
    real = tne.all2all

    def delayed(codes, params, **kw):
        if kw.get("ext_counter") is not None:
            event.wait(60.0)
            time.sleep(0.2)
        return real(codes, params, **kw)

    monkeypatch.setattr(tne, "all2all", delayed)


def test_hybrid_survives_dead_device_at_warmup(greedy_claims, monkeypatch,
                                               capsys):
    """A warm-up failure leaves the run to the native pool, with a
    warning and the reason in the stats."""
    tried = threading.Event()

    def dead(self, gidx, lo, device=None, qrows=None):
        tried.set()
        raise RuntimeError("injected: device unreachable")

    monkeypatch.setattr(tce.CudaAll2All, "dispatch_group", dead)
    _hold_native_until(monkeypatch, tried)
    p = Params()
    codes = _codes(8, np.random.RandomState(22))
    ref = tne.all2all(codes, p)
    st = {}
    out = hyb.all2all_hybrid(codes, p, device="cpu", cpu_threads=2,
                             stats=st)
    assert np.array_equal(ref, out)
    assert st["device_pairs"] == 0
    assert st["cpu_pairs"] == 8 * 7
    assert "injected" in st["warm_why"]
    assert "device warm-up failed" in capsys.readouterr().err


def test_hybrid_small_run_never_warms(monkeypatch):
    """A run the native pool finishes before the lazy-warm threshold never
    pays for the device: the engine is not even constructed."""
    def boom(*a, **k):
        raise AssertionError("engine must not be constructed")

    monkeypatch.setattr(tce.CudaAll2All, "__init__", boom)
    p = Params()
    codes = _codes(8, np.random.RandomState(33))
    ref = tne.all2all(codes, p)
    st = {}
    out = hyb.all2all_hybrid(codes, p, device="cpu", cpu_threads=2,
                             stats=st)
    assert np.array_equal(ref, out)
    assert st["warm_started"] is False
    assert st["device_pairs"] == 0 and st["warm_why"] is None


def test_hybrid_cpu0_delegates_to_all2all_cuda(monkeypatch):
    """cpu_threads=0 is the pure device path."""
    called = {}

    def fake(codes, params, **kw):
        called.update(kw)
        return "sentinel"

    monkeypatch.setattr(tce, "all2all_cuda", fake)
    r = hyb.all2all_hybrid([np.zeros(10, np.uint8)], Params(),
                           cpu_threads=0, device="cpu")
    assert r == "sentinel" and called["device"] == "cpu"


def test_two_ended_claims_are_atomic_across_engines():
    """Head poppers (the native workers) and tail claimers (the device
    scheduler) share one packed {tail:32|head:32} word of the port's
    native engine: every row is claimed exactly once."""
    import ctypes as ct

    N = 5000
    lib = tne.get_lib()
    ctr = np.array([N << 32], np.int64)
    ptr = ctr.ctypes.data_as(ct.POINTER(ct.c_int64))
    claimed = []
    lock = threading.Lock()

    def head_popper():
        got = []
        while (r := int(lib.lza_claim_head(ptr))) >= 0:
            got.append(r)
        with lock:
            claimed.extend(got)

    def tail_claimer(k):
        got = []
        while True:
            cnt = ct.c_int64(0)
            s = int(lib.lza_claim_tail(ptr, k, ct.byref(cnt)))
            if s < 0:
                break
            got.extend(range(s, s + cnt.value))
        with lock:
            claimed.extend(got)

    ts = ([threading.Thread(target=head_popper) for _ in range(2)]
          + [threading.Thread(target=tail_claimer, args=(k,))
             for k in (4, 7)])
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
        assert not t.is_alive()
    assert sorted(claimed) == list(range(N))


def _fresh(code, *args, timeout=120):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code, *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_hybrid_module_is_torch_free_at_import():
    """A run too short for the device never pays torch's import: importing
    the module (and the CLI that selects it) loads neither torch nor the
    CUDA engine."""
    r = _fresh("import sys\n"
               "import lzani_tpu_torch.ops.hybrid, lzani_tpu_torch.cli\n"
               "bad = [m for m in ('torch', 'lzani_tpu_torch.ops.cuda_engine',"
               " 'lzani_tpu_torch.ops.parse_kernel') if m in sys.modules]\n"
               "assert not bad, bad\n"
               "print('clean')\n")
    assert r.returncode == 0 and "clean" in r.stdout, r.stderr[-1000:]


TEARDOWN = """
import os, sys, threading, time
import numpy as np
from lzani_tpu_torch.core import native_engine
from lzani_tpu_torch.ops.hybrid import all2all_hybrid
from lzani_tpu_torch.params import Params
real = native_engine.all2all

def held(codes, params, **kw):
    # the pool starts once the warm thread exists, and then drains the
    # queue in milliseconds, while that thread is still importing torch
    t0 = time.perf_counter()
    while kw.get('ext_counter') is not None and not any(
            t.name == 'lzani-hybrid-warm' for t in threading.enumerate()):
        assert time.perf_counter() - t0 < 60
        time.sleep(0.01)
    return real(codes, params, **kw)

native_engine.all2all = held
params = Params()
rng = np.random.RandomState(3)
base = rng.randint(0, 4, 300).astype(np.uint8)
codes = []
for i in range(9):
    s = base.copy()
    s[::(i + 4)] = (s[::(i + 4)] + 1) % 4
    codes.append(s[:300 - 9 * i])
want = real(codes, params)
os.environ['LZANI_TPU_HYBRID_GREEDY'] = '1'
st = {}
got = all2all_hybrid(codes, params, device='cpu', cpu_threads=2, stats=st)
assert np.array_equal(got, want)
print('teardown-ok', st['warm_started'], st['warm_pending'], st['warm_why'])
"""


def test_hybrid_warm_thread_clean_teardown():
    """A greedy run whose queue drains while the warm thread is still
    importing torch or building the engine exits 0: the thread is joined
    for a bounded time, then parked for the atexit join (no abort at
    interpreter teardown, no os._exit)."""
    r = _fresh(TEARDOWN)
    assert r.returncode == 0 and "teardown-ok True" in r.stdout, (
        f"rc={r.returncode}\n{r.stderr[-2000:]}")


def test_hybrid_small_run_joins_warm_thread_quickly(greedy_claims):
    """When the queue drains before the warm thread reaches a cancel
    point, all2all_hybrid returns after a bounded join and parks the
    thread instead of waiting for it."""
    codes = _codes(4, np.random.RandomState(0), lo=120, hi=200)
    params = Params()
    t0 = time.perf_counter()
    got = hyb.all2all_hybrid(codes, params, device="cpu", cpu_threads=2)
    el = time.perf_counter() - t0
    assert np.array_equal(got, tne.all2all(codes, params))
    assert el < 8.0
    # a live warm thread must be tracked for the atexit join
    for t in threading.enumerate():
        if t.name == "lzani-hybrid-warm":
            assert any(pt is t for pt, _ in hyb._parked_warm), \
                "live warm thread not parked for the atexit join"


def test_hybrid_equals_jax_hybrid(tmp_path, greedy_claims, slow_cpu):
    """The same seeded codes through the JAX function (interpret mode) and
    the port's (the plain version): equal triples, equal region maps, and
    the port's device side took part."""
    rng = np.random.RandomState(41)
    codes = _codes(9, rng)
    jout = jax_all2all_hybrid(codes, JParams(), interpret=True,
                              cpu_threads=1,
                              region_path=str(tmp_path / "jax"))
    st = {}
    tout = hyb.all2all_hybrid(codes, Params(), device="cpu", cpu_threads=1,
                              region_path=str(tmp_path / "port"), stats=st)
    assert np.array_equal(jout, tout)
    assert _region_map(tmp_path / "jax") == _region_map(tmp_path / "port")
    assert st["device_pairs"] > 0
    assert st["device_pairs"] + st["cpu_pairs"] == 9 * 8


def test_hybrid_raises_on_a_rejected_log(greedy_claims, slow_cpu,
                                         monkeypatch):
    """A log the replay rejects is counted and fails the run (the JAX
    function would re-parse the pair and hide the kernel's fault)."""
    real = tce.parse_events

    def wrong_ext(*args, **kw):
        ev, nev = real(*args, **kw)
        ev[:, :, 0, 4] += 1             # every pair's first extension
        return ev, nev

    monkeypatch.setattr(tce, "parse_events", wrong_ext)
    st = {}
    with pytest.raises(RuntimeError, match="replay cross-check"):
        hyb.all2all_hybrid(_codes(8, np.random.RandomState(5)), Params(),
                           device="cpu", cpu_threads=1, stats=st)
    assert 0 < st["replay_mismatches"] <= st["device_pairs"]


def test_hybrid_long_genome_parameters_stay_native(greedy_claims,
                                                   monkeypatch, capsys):
    """mal > 13 sends every row to the long-genome path, which the hybrid
    does not use: the warm-up stops on the envelope, silently, and the
    native pool owns the run (the JAX function's warm-up fails there)."""
    decided = threading.Event()
    real = tce.CudaAll2All.big_only_reason.__func__

    def reason(cls, LqP, mal):
        why = real(cls, LqP, mal)
        decided.set()
        return why

    monkeypatch.setattr(tce.CudaAll2All, "big_only_reason",
                        classmethod(reason))
    _hold_native_until(monkeypatch, decided)
    p = Params(min_anchor_len=20, min_seed_len=11, min_region_len=80)
    codes = _codes(8, np.random.RandomState(7))
    ref = tne.all2all(codes, p)
    st = {}
    out = hyb.all2all_hybrid(codes, p, device="cpu", cpu_threads=1,
                             stats=st)
    assert np.array_equal(out, ref)
    assert st["device_pairs"] == 0 and st["cpu_pairs"] == 8 * 7
    assert st["warm_why"].startswith("envelope: min anchor length 20 > 13")
    assert "warm-up failed" not in capsys.readouterr().err


@pytest.mark.parametrize("when", ["warm-up", "mid-run"])
def test_hybrid_on_a_card_fails_after_migration(when, greedy_claims,
                                                monkeypatch, request,
                                                capsys):
    """On a CUDA device a failed warm-up or drain still migrates its work
    to the host, and the run then raises once it has ended: it never
    succeeds without the card it was asked to use."""
    monkeypatch.setattr(hyb, "_on_card", lambda device: True)
    if when == "warm-up":
        tried = threading.Event()

        def dead(self, gidx, lo, device=None, qrows=None):
            tried.set()
            raise RuntimeError("injected: device unreachable")

        monkeypatch.setattr(tce.CudaAll2All, "dispatch_group", dead)
        _hold_native_until(monkeypatch, tried)
    else:
        request.getfixturevalue("slow_cpu")
        calls = {"n": 0}
        real = tce.CudaAll2All.collect_group

        def dying(self, handles):
            calls["n"] += 1
            if calls["n"] > 1:  # the first call is the warm-up's
                raise RuntimeError("injected device crash")
            return real(self, handles)

        monkeypatch.setattr(tce.CudaAll2All, "collect_group", dying)
    st = {}
    with pytest.raises(RuntimeError, match="the CUDA device failed"):
        hyb.all2all_hybrid(_codes(8, np.random.RandomState(23)), Params(),
                           device="cpu", cpu_threads=1, stats=st)
    if when == "warm-up":
        assert "injected" in st["warm_why"] and st["cpu_pairs"] == 8 * 7
        assert "device warm-up failed" in capsys.readouterr().err
    else:
        assert st["failed_rows"] > 0
        assert "recovered on the host" in capsys.readouterr().err


def test_hybrid_envelope_on_a_card_is_not_a_failure(greedy_claims,
                                                    monkeypatch):
    """A warm-up that stops on the envelope is policy: on a CUDA device the
    native pool owns the run and the run succeeds."""
    monkeypatch.setattr(hyb, "_on_card", lambda device: True)
    decided = threading.Event()
    real = tce.CudaAll2All.big_only_reason.__func__

    def reason(cls, LqP, mal):
        why = real(cls, LqP, mal)
        decided.set()
        return why

    monkeypatch.setattr(tce.CudaAll2All, "big_only_reason",
                        classmethod(reason))
    _hold_native_until(monkeypatch, decided)
    p = Params(min_anchor_len=20, min_seed_len=11, min_region_len=80)
    codes = _codes(6, np.random.RandomState(8))
    st = {}
    out = hyb.all2all_hybrid(codes, p, device="cpu", cpu_threads=1,
                             stats=st)
    assert np.array_equal(out, tne.all2all(codes, p))
    assert st["warm_why"].startswith("envelope:")


def test_on_card_reads_the_device_type():
    import torch

    assert hyb._on_card("cuda") and hyb._on_card("cuda:1")
    assert hyb._on_card(torch.device("cuda", 0))
    assert not hyb._on_card("cpu") and not hyb._on_card(torch.device("cpu"))


def test_hybrid_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(cudadev, "cuda_device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hyb.all2all_hybrid([np.zeros(10, np.uint8)] * 2, Params())


@pytest.mark.parametrize("backend", ["hybrid", "auto", None])
def test_cli_hybrid_and_auto_without_a_card_exit_1(backend, tmp_path,
                                                   monkeypatch, capsys):
    monkeypatch.setattr(cudadev, "cuda_device_count", lambda: 0)
    fa = str(tmp_path / "in.fna")
    write_fasta(fa, ["a", "b"], _codes(2, np.random.RandomState(1)))
    argv = ["all2all", "--in-fasta", fa, "--out", str(tmp_path / "o.tsv")]
    rc = tcli.main(argv + (["--backend", backend] if backend else []))
    assert rc == 1
    assert "--backend hybrid needs a CUDA device" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "o.tsv")


def test_cli_hybrid_matches_native_cli(tmp_path, greedy_claims, slow_cpu,
                                       capsys):
    """The slice end to end: the port's CLI with --backend hybrid (the
    Matcher's hybrid branch, on the CPU device) writes TSV and ids files
    byte-equal to the JAX package's native CLI, the aln file equal as a
    set, and prints its engine line at -V 2."""
    from lzani_tpu import cli as jcli
    from lzani_tpu_torch.utils.runinfo import engine_stats

    fa = str(tmp_path / "in.fna")
    codes = _codes(8, np.random.RandomState(17))
    write_fasta(fa, [f"s{k}" for k in range(len(codes))], codes)
    a, b = str(tmp_path / "a.tsv"), str(tmp_path / "b.tsv")
    assert jcli.main(["all2all", "--in-fasta", fa, "--out", a,
                      "--out-alignment", a + ".aln", "-t", "2", "-V", "0",
                      "--backend", "native"]) == 0
    rc, m = tcli.run(["all2all", "--in-fasta", fa, "--out", b,
                      "--out-alignment", b + ".aln", "-t", "2", "-V", "2",
                      "--backend", "hybrid"], device="cpu")
    assert rc == 0 and m.params.backend == "hybrid"
    for suffix in (".tsv", ".ids.tsv"):
        with open(a[:-4] + suffix, "rb") as fa_, \
                open(b[:-4] + suffix, "rb") as fb_:
            assert fa_.read() == fb_.read()
    with open(a + ".aln", "rb") as fa_, open(b + ".aln", "rb") as fb_:
        la, lb = fa_.read().splitlines(), fb_.read().splitlines()
    assert la[0] == lb[0] and sorted(la[1:]) == sorted(lb[1:])
    st = m.engine_stats
    assert st["device_pairs"] > 0 and st["warm_why"] is None
    assert st["device_pairs"] + st["cpu_pairs"] == 8 * 7
    assert engine_stats(capsys.readouterr().err) == st
    assert not os.path.exists(b + ".aln.regions.tmp")
