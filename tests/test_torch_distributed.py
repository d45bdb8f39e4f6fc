"""The port's multi-process layer (``lzani_tpu_torch.parallel.distributed``)
and its multi-device engines on the CPU.

Held against the JAX package's ``lzani_tpu.parallel.distributed``: the
numpy helpers equal, a simulated two-process run of ``all2all_multihost``
equal to the native oracle and to the JAX function (interpret mode, the
v7 kernel the port's kernel replaces). ``gather_merge`` runs across two
real gloo processes on 127.0.0.1. ``all2all_cuda`` and
``all2all_hybrid`` round-robin over repeated device entries
(``["cpu", "cpu"]``) equal the native engine. Every comparison is exact.
"""
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from lzani_tpu.core import native_engine as jne
from lzani_tpu.parallel import distributed as jd
from lzani_tpu.params import Params as JParams
from lzani_tpu_torch.core import native_engine as tne
from lzani_tpu_torch.ops import cuda_engine as tce
from lzani_tpu_torch.ops import hybrid as hyb
from lzani_tpu_torch.parallel import distributed as td
from lzani_tpu_torch.params import Params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _codes(n, seed=41):
    """tests/test_distributed.py's fixture."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 4, 380).astype(np.uint8)
    out = []
    for i in range(n):
        s = base.copy()
        s[:: (i + 4)] = (s[:: (i + 4)] + 1) % 4
        out.append(s[: 380 - 7 * i])
    return out


def _csr(rows):
    indptr = np.zeros(len(rows) + 1, np.int64)
    indptr[1:] = np.cumsum([len(r) for r in rows])
    return indptr, np.array(sum(rows, []), np.int32)


def _random_csr(n, rng):
    return _csr([sorted(set(int(q) for q in rng.choice(n, 3) if q != r))
                 for r in range(n)])


@pytest.mark.parametrize("n_hosts", [1, 2, 3, 5])
def test_partition_and_local_csr_equal_jax(n_hosts):
    rng = np.random.RandomState(n_hosts)
    n = 13
    csr = _random_csr(n, rng)
    for h in range(n_hosts):
        rows = td.partition_refs(n, n_hosts, h)
        assert np.array_equal(rows, jd.partition_refs(n, n_hosts, h))
        for flt in (None, csr):
            got = td.local_filter_csr(rows, n, flt)
            want = jd.local_filter_csr(rows, n, flt)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("n_hosts", [1, 2, 3, 5])
def test_merge_host_triples_equals_jax(n_hosts):
    rng = np.random.RandomState(10 + n_hosts)
    n = 11
    per_host = []
    for h in range(n_hosts):
        _, _, slots = td.local_filter_csr(td.partition_refs(n, n_hosts, h), n)
        per_host.append((slots, rng.randint(0, 1 << 30, (len(slots), 3))
                         .astype(np.int32)))
    got = td.merge_host_triples(n * (n - 1), per_host)
    assert np.array_equal(got, jd.merge_host_triples(n * (n - 1), per_host))
    assert (got != 0).all()          # the shares cover every slot


@pytest.mark.parametrize("fixture", ["dense", "filter"])
def test_two_simulated_hosts_equal_oracle_and_jax(fixture, monkeypatch):
    """The fixtures of tests/test_distributed.py: each host's share
    through the port's all2all_multihost (all2all_cuda, plain version),
    merged, equals the native oracle and the JAX function's merge."""
    if fixture == "dense":
        codes, csr = _codes(5), None
    else:
        codes = _codes(6)
        csr = _csr([[1, 2], [0], [0, 5], [4], [3], [2]])
    # the JAX engine's v7 kernel (pallas_v7.make_parse_kernel_sim)
    monkeypatch.setenv("LZANI_TPU_ILV", "2")
    monkeypatch.setenv("LZANI_TPU_SIM", "1")
    port, jax_ = [], []
    for h in range(2):
        slots, triples, total = td.all2all_multihost(
            codes, Params(), filter_csr=csr, devices=["cpu"], process_id=h,
            num_processes=2)
        port.append((slots, triples))
        j = jd.all2all_multihost(codes, JParams(), filter_csr=csr,
                                 interpret=True, process_id=h,
                                 num_processes=2)
        jax_.append(j[:2])
        assert j[2] == total and np.array_equal(j[0], slots)
    merged = td.merge_host_triples(total, port)
    want = jne.all2all(codes, JParams(), filter_csr=csr).reshape(-1, 3)
    assert np.array_equal(merged, want)
    assert np.array_equal(merged, jd.merge_host_triples(total, jax_))


# ---- two real gloo processes ------------------------------------------------

WORKER = r"""
import sys
import numpy as np
from lzani_tpu_torch.parallel import distributed as td

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
assert td.init_distributed(f"127.0.0.1:{port}", 2, rank) == (rank, 2)
# the fixture of tests/test_distributed.py's gather test: disjoint slot
# sets of unequal sizes, unequal region blobs
rng = np.random.RandomState(7)
total = 1560
perm = rng.permutation(total)
sizes = [900, 660]
blobs = [b"host0-regions|" * 33, b"h1|" * 5]
slots = [perm[:sizes[0]], perm[sizes[0]:]]
triples = [rng.randint(0, 1 << 20, (s, 3)).astype(np.int32) for s in sizes]
table, blob = td.gather_merge(slots[rank], triples[rank], total,
                              region_blob=blobs[rank], chunk=13)
# slots past 2^31 cross the exchange as they are (no table that size)
big = (np.int64(1) << 40) + rank * 1000 + np.arange(3 + 4 * rank,
                                                  dtype=np.int64)
seen = []
td.gather_chunks(np.stack([big, big * 3], 1), 2,
                 lambda h, rows: seen.append((h, rows.copy())))
assert td.card_share("cpu") == 2
td.shutdown()
if rank == 0:
    np.savez(out, table=table, blob=np.frombuffer(blob, np.uint8),
             want=td.merge_host_triples(total, list(zip(slots, triples))),
             want_blob=np.frombuffer(blobs[0] + blobs[1], np.uint8),
             hosts=np.array([h for h, _ in seen]),
             rows=np.concatenate([r for _, r in seen]))
else:
    assert table is None and blob == b"" and seen == []
print("ok", rank)
"""


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("gloo") / "rank0.npz")
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), port,
                               out], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    res = [p.communicate(timeout=120) for p in procs]
    for p, (o, e) in zip(procs, res):
        assert p.returncode == 0, e[-2000:]
    assert [o.split() for o, _ in res] == [["ok", "0"], ["ok", "1"]]
    return np.load(out)


def test_gather_merge_to_rank_0_only(gloo_run):
    """Rank 0 rebuilds the exact table and the blobs in rank order, in
    chunk-13 rounds; rank 1 gets (None, b"") (asserted in the worker)."""
    assert np.array_equal(gloo_run["table"], gloo_run["want"])
    assert gloo_run["blob"].tobytes() == gloo_run["want_blob"].tobytes()


def test_gather_chunks_carry_int64_past_2_31(gloo_run):
    big = (np.int64(1) << 40) + np.concatenate(
        [np.arange(3), 1000 + np.arange(7)]).astype(np.int64)
    rows = gloo_run["rows"]
    assert rows.dtype == np.int64
    # rounds of 2 rows, hosts in order within a round
    assert gloo_run["hosts"].tolist() == [0, 1, 0, 1, 1, 1]
    assert sorted(rows[:, 0].tolist()) == big.tolist()
    assert np.array_equal(rows[:, 1], rows[:, 0] * 3)


def test_distributed_module_loads_no_torch():
    code = ("import sys\n"
            "import lzani_tpu_torch.parallel.distributed as d\n"
            "d.partition_refs(5, 2, 0); d.local_filter_csr([0, 2], 5)\n"
            "assert d.init_distributed() == (0, 1)\n"
            "t, b = d.gather_merge([0, 1], [[1, 2, 3], [4, 5, 6]], 2, b'x')\n"
            "assert t.tolist() == [[1, 2, 3], [4, 5, 6]] and b == b'x'\n"
            "assert 'torch' not in sys.modules, 'torch loaded'\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", td.ENV_ADDRESS)}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_init_distributed_needs_count_and_id(monkeypatch):
    monkeypatch.delenv(td.ENV_NUM_PROCESSES, raising=False)
    monkeypatch.delenv(td.ENV_PROCESS_ID, raising=False)
    with pytest.raises(ValueError, match="JAX_NUM_PROCESSES"):
        td.init_distributed("127.0.0.1:1")
    with pytest.raises(ValueError, match="outside"):
        td.init_distributed("127.0.0.1:1", 2, 2)


# ---- several device entries -------------------------------------------------

def _family(seed, n=8, length=700):
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 4, length).astype(np.uint8)
    out = []
    for k in range(n):
        c = base[: length - 30 * k].copy()
        m = rng.rand(len(c)) < 0.02 * (k + 1)
        c[m] = (c[m] + rng.randint(1, 4, m.sum())) % 4
        out.append(c)
    return out


def _tandem_set():
    """tests/test_torch_big.py's fixture (a 13-mer x 150 inside 900 bp, a
    5% mutant, the base, an unrelated sequence)."""
    rng = np.random.RandomState(11)
    unit = rng.randint(0, 4, 13).astype(np.uint8)
    base = rng.randint(0, 4, 900).astype(np.uint8)
    g1 = np.concatenate([base[:300], np.tile(unit, 150), base[300:]])
    q1 = g1.copy()
    m = rng.rand(len(q1)) < 0.05
    q1[m] = (q1[m] + rng.randint(1, 4, m.sum())) % 4
    return [g1, q1, base, rng.randint(0, 4, 700).astype(np.uint8)]


def _regions(path):
    return sorted((r, q, tuple(map(tuple, regs)))
                  for r, q, regs in tne.read_region_dump(path))


@pytest.mark.parametrize("path", ["group", "big", "share"])
def test_all2all_cuda_round_robin_equals_native(path, tmp_path, monkeypatch):
    """Units go round-robin over two entries on one device; each entry
    runs some. 'big': every row on the long-genome path (mal 16), one
    reference per launch, so the four references make four units.
    'share': process 0's rows of two (half the rows have no pair)."""
    p, csr = Params(), None
    if path == "big":
        codes = _tandem_set()
        p.min_anchor_len, p.min_seed_len = 16, 9
        real = tce.CudaAll2All.big_launch_shape

        def one_ref(self, n_big, device=None, share=1):
            real(self, n_big, device, share)
            self.G_big = 1
            return self.G_big, self.B_big

        monkeypatch.setattr(tce.CudaAll2All, "big_launch_shape", one_ref)
    else:
        codes = _family(3, n=12)
        if path == "share":
            rows = td.partition_refs(len(codes), 2, 0)
            csr = td.local_filter_csr(rows, len(codes))[:2]
    rp_n, rp_t = str(tmp_path / "n.regions"), str(tmp_path / "t.regions")
    want = tne.all2all(codes, p, filter_csr=csr, region_path=rp_n)
    st = {}
    got = tce.all2all_cuda(codes, p, filter_csr=csr, devices=["cpu", "cpu"],
                           region_path=rp_t, stats=st)
    assert np.array_equal(got, want)
    assert _regions(rp_t) == _regions(rp_n)
    assert len(st["device_units"]) == 2 and min(st["device_units"]) > 0
    assert sum(st["device_units"]) == st["dispatches"]
    assert st["replay_mismatches"] == 0 and st["native_rows"] == 0
    if path == "big":
        assert st["big_rows"] == 4 and st["G_big"] == 1
        assert st["big_pairs"] + st["big_cap_fallbacks"] == 12


def test_all2all_cuda_takes_device_or_devices():
    with pytest.raises(ValueError, match="not both"):
        tce.all2all_cuda(_family(1, n=2), Params(), device="cpu",
                         devices=["cpu"])
    with pytest.raises(ValueError, match="not both"):
        hyb.all2all_hybrid(_family(1, n=2), Params(), devices=[])


def test_big_launch_shape_splits_a_shared_device(monkeypatch):
    """Two entries on one device, or two processes on one card, halve
    each launch's memory budget."""
    codes = _tandem_set()
    p = Params()
    p.min_anchor_len, p.min_seed_len = 16, 9
    one = tce.CudaAll2All(codes, p, devices=["cpu"])
    two = tce.CudaAll2All(codes, p, devices=["cpu", "cpu"])
    # the launch's bytes, the kernel's bit planes (3/8 byte a symbol) too
    per_ref = 13 * one.LrP_big + 4 * one.KaP_big + 3 * one.LrP_big // 8
    per_query = 48 * one.LqP + 4 + 3 * one.LqP // 8
    per_pair = 12 * one.LqP + 32 * (one.EV_CAP_BIG + 1) + 4
    # a budget that holds two references x one query, and no more
    monkeypatch.setattr(tce.CudaAll2All, "CPU_BIG_BUDGET",
                        2 * (per_ref + per_pair) + per_query + 1)
    one.B = two.B = 1
    assert one.big_launch_shape(4) == (2, 1)
    assert two.big_launch_shape(4) == (1, 1)
    assert one.big_launch_shape(4, share=2) == (1, 1)
    assert one.big_launch_shape(4, "cpu") == (2, 1)


@pytest.fixture()
def held_native(monkeypatch):
    """Greedy claims, and the native pool held back until the warm-up's
    dummy group has been collected, so the device side claims rows."""
    monkeypatch.setenv("LZANI_TPU_HYBRID_GREEDY", "1")
    warm_done = threading.Event()
    real_cg = tce.GroupRoute.collect

    def cg(self, handles):
        out = real_cg(self, handles)
        warm_done.set()
        return out

    monkeypatch.setattr(tce.GroupRoute, "collect", cg)
    real = tne.all2all

    def delayed(codes, params, **kw):
        if kw.get("ext_counter") is not None:
            warm_done.wait(120.0)
            time.sleep(0.5)
        return real(codes, params, **kw)

    monkeypatch.setattr(tne, "all2all", delayed)


@pytest.mark.parametrize("share", ["dense", "share"])
def test_all2all_hybrid_round_robin_equals_native(share, held_native,
                                                   tmp_path):
    """Claimed groups go round-robin over two entries; with one process's
    share the rows without pairs ride along in the claims."""
    p = Params()
    codes = _family(4, n=12)
    codes.sort(key=len, reverse=True)
    csr = None
    if share != "dense":
        csr = td.local_filter_csr(td.partition_refs(len(codes), 2, 0),
                                  len(codes))[:2]
    rp_n, rp_t = str(tmp_path / "n.regions"), str(tmp_path / "t.regions")
    want = tne.all2all(codes, p, filter_csr=csr, region_path=rp_n)
    st = {}
    got = hyb.all2all_hybrid(codes, p, filter_csr=csr, region_path=rp_t,
                             devices=["cpu", "cpu"], cpu_threads=1, stats=st)
    assert np.array_equal(got, want)
    assert _regions(rp_t) == _regions(rp_n)
    assert st["warm_why"] is None and st["failed_rows"] == 0
    assert st["device_pairs"] > 0 and min(st["device_units"]) > 0
    total = len(codes) * (len(codes) - 1) if csr is None else len(csr[1])
    assert st["device_pairs"] + st["cpu_pairs"] == total
