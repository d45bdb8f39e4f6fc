"""The port's automaton backend on the CPU (the kernels' plain versions):
the fold of an event log equals the native replay and the JAX automaton
(stats and factors), a corrupted log is rejected and fails the run, and
``all2all_jax`` equals ``native_engine.all2all``. Inputs come from seeded
numpy generators; everything is integer, so every comparison is exact."""
import numpy as np
import pytest
import torch

from lzani_tpu.core import native_engine as ne
from lzani_tpu.ops import engine_jax as jej
from lzani_tpu.params import Params
from lzani_tpu_torch.ops import engine_jax as tej
from lzani_tpu_torch.ops.fold_stats import fold_stats, fold_stats_plain
from lzani_tpu_torch.ops.parse import ParseCfg
from lzani_tpu_torch.ops.prep import query_buffer_np, ref_buffer_np
from lzani_tpu_torch.synth import rand_params, small_family

CPU = torch.device("cpu")


# the generator of tests/test_jax_engine.py
def mutate(rng, seq, sub=0.0, indel=0.0):
    out = []
    for c in seq:
        r = rng.random()
        if r < sub:
            out.append(rng.integers(0, 4))
        elif r < sub + indel:
            continue
        elif r < sub + 2 * indel:
            out.extend([c, rng.integers(0, 4)])
        else:
            out.append(c)
    return np.array(out, dtype=np.uint8)


def rc(seq):
    out = seq[::-1].copy()
    acgt = out < 4
    out[acgt] = 3 - out[acgt]
    return out


def cases():
    rng = np.random.default_rng(7)
    ref = rng.integers(0, 4, 900).astype(np.uint8)
    yield "identical", ref, ref.copy()
    yield "subs2pct", ref, mutate(rng, ref, sub=0.02)
    yield "subs10pct", ref, mutate(rng, ref, sub=0.10)
    yield "indels", ref, mutate(rng, ref, sub=0.02, indel=0.01)
    inv = ref.copy()
    inv[300:600] = rc(ref[300:600])
    yield "inversion", ref, inv
    yield "translocation", ref, np.concatenate([ref[450:], ref[:450]])
    yield "duplication", ref, np.concatenate([ref[:450], ref[200:400],
                                              ref[450:]])
    n_ref = ref.copy()
    n_ref[100:140] = 5
    n_q = mutate(rng, ref, sub=0.01)
    n_q[400:460] = 5
    yield "n_runs", n_ref, n_q
    yield "unrelated", ref, rng.integers(0, 4, 700).astype(np.uint8)
    yield "short", ref[:60], ref[10:55]
    yield "tiny", ref[:10], ref[:8]
    yield "q_longer", ref[:300], np.concatenate([ref, ref[:200]])


CASES = {name: (ref, q) for name, ref, q in cases()}


def fold_args(refs, qs, p, logs=None):
    """A fold launch's inputs over refs x qs: buffers with 1,024 N of
    padding, the oracle's event logs (or `logs[g][b]`)."""
    mrd = p.max_dist_in_ref
    rbs = [ref_buffer_np(r, mrd) for r in refs]
    qbs = [query_buffer_np(q, mrd) for q in qs]
    R = np.full((len(refs), max(map(len, rbs)) + 1024), 4, np.uint8)
    Q = np.full((len(qs), max(map(len, qbs)) + 1024), 5, np.uint8)
    for g, rb in enumerate(rbs):
        R[g, :len(rb)] = rb
    for b, qb in enumerate(qbs):
        Q[b, :len(qb)] = qb
    if logs is None:
        logs = [[ne.parse_event_log(r, q, p) for q in qs] for r in refs]
    evc = max(len(x) for row in logs for x in row) + 1
    E = np.zeros((len(refs), len(qs), evc, 8), np.int32)
    N = np.zeros((len(refs), len(qs)), np.int32)
    for g, row in enumerate(logs):
        for b, x in enumerate(row):
            E[g, b, :len(x)] = x
            N[g, b] = len(x)
    return [torch.from_numpy(a) for a in (
        R, Q, E, N, np.array([len(x) for x in qbs], np.int32),
        np.array([len(x) for x in rbs], np.int32))]


@pytest.mark.parametrize("name", list(CASES))
def test_fold_plain_equals_the_native_replay(name):
    ref, q = CASES[name]
    p = Params()
    stats, status, fac, nfac = fold_stats_plain(
        *fold_args([ref], [q], p), ParseCfg.from_params(p), want_factors=True)
    assert status.tolist() == [[0]]
    assert tuple(stats[0, 0].tolist()) == ne.parse_pair(ref, q, p)[0]
    assert np.array_equal(fac[0, 0, :int(nfac[0, 0])].numpy(),
                          ne.parse_factors(ref, q, p))


def test_fold_plain_on_random_parameters():
    """Every ordered pair of small_family at three random parameter sets,
    in one launch each (G = B = 6)."""
    rng = np.random.RandomState(23)
    codes = small_family()
    for _ in range(3):
        p = rand_params(rng)
        stats, status = fold_stats(*fold_args(codes, codes, p),
                                   ParseCfg.from_params(p))
        assert (status == 0).all()
        for g, r in enumerate(codes):
            for b, q in enumerate(codes):
                assert tuple(stats[g, b].tolist()) == ne.parse_pair(
                    r, q, p)[0], (g, b)


@pytest.mark.parametrize("name", ["inversion", "translocation", "n_runs",
                                  "unrelated"])
def test_parse_pair_equals_the_jax_automaton(name):
    ref, q = CASES[name]
    p = Params()
    got_stats, got_fac = tej.parse_pair_jax(ref, q, p, want_factors=True,
                                            device=CPU)
    want_stats, want_fac = jej.parse_pair_jax(ref, q, p, want_factors=True)
    assert got_stats == want_stats
    assert np.array_equal(got_fac, want_fac)
    assert tej.parse_pair_jax(ref, q, p, device=CPU) == want_stats


@pytest.mark.parametrize("field,delta", [(3, 1), (4, 1), (4, -1), (0, 10**6)],
                         ids=["bwd", "ext_up", "ext_down", "order"])
def test_a_corrupted_log_is_rejected(field, delta):
    """One altered record per log: every pair's status is -1 and it has
    no stats; a pair without a log (nev -1) is skipped (status 1)."""
    p = Params()
    refs = [CASES["subs2pct"][0], CASES["translocation"][0]]
    qs = [CASES[k][1] for k in ("subs2pct", "indels", "translocation")]
    args = fold_args(refs, qs, p)
    ev, nev = args[2], args[3]
    assert (nev > 0).all()
    for g in range(nev.shape[0]):
        for b in range(nev.shape[1]):
            ev[g, b, int(nev[g, b]) // 2, field] += delta
    nev[1, 2] = -1
    stats, status = fold_stats(*args, ParseCfg.from_params(p))
    assert status.tolist() == [[-1, -1, -1], [-1, -1, 1]]
    assert not stats.any()


def test_a_rejected_log_fails_the_run(monkeypatch):
    codes = small_family()
    real = tej.parse_events

    def corrupt(*args):
        ev, nev = real(*args)
        ev[:, :, 0, 4] += 1                    # the ext of each first event
        return ev, nev

    monkeypatch.setattr(tej, "parse_events", corrupt)
    p = Params()
    st = {}
    with pytest.raises(RuntimeError, match="fold's cross-check"):
        tej.all2all_jax(codes, p, device=CPU, stats=st)
    with_events = sum(len(ne.parse_event_log(r, q, p)) > 0 for r in codes
                      for q in codes if q is not r)
    assert st["replay_mismatches"] == with_events > 0
    assert st["fold_pairs"] == 30 - with_events


def _csr(rows):
    indptr = np.zeros(len(rows) + 1, np.int64)
    ids = []
    for r, qs in enumerate(rows):
        ids.extend(qs)
        indptr[r + 1] = len(ids)
    return indptr, np.array(ids, np.int32)


def test_all2all_equals_native_dense_and_filtered():
    codes = small_family()
    p = Params()
    st = {}
    got = tej.all2all_jax(codes, p, device=CPU, stats=st, batch_size=3)
    assert np.array_equal(got, ne.all2all(codes, p))
    n = len(codes)
    assert st["rows"] == n and st["batches"] == 2 * n
    assert st["fold_pairs"] == n * (n - 1) and st["replay_mismatches"] == 0
    assert st["launches"] == st["fold_launches"] == 0   # plain versions
    csr = _csr([[1, 3, 5], [0], [], [2, 4], [0, 1, 2, 3, 5], [4]])
    seen = []
    got = tej.all2all_jax(codes, p, filter_csr=csr, device=CPU,
                          progress=lambda *a: seen.append(a))
    assert np.array_equal(got, ne.all2all(codes, p, filter_csr=csr))
    assert seen[-1] == (12, 12, n, n) and len(seen) == n


def test_a_normal_set_takes_no_capacity_fallback():
    """The native route is for capacity cases only: on a set within the
    kernels' capacities every pair is folded from a kernel log, on one
    device and split over three entries."""
    codes = small_family()
    p = Params()
    n = len(codes)
    for device in (CPU, [CPU] * 3):
        st = {}
        got = tej.all2all_jax(codes, p, device=device, stats=st)
        assert np.array_equal(got, ne.all2all(codes, p))
        assert st["cap_fallbacks"] == 0 and st["replay_mismatches"] == 0
        assert st["fold_pairs"] == n * (n - 1)


def test_capacity_fallbacks_run_natively(monkeypatch):
    """Logs over the event cap go to the native engine and are counted."""
    codes = small_family()
    p = Params()
    monkeypatch.setattr(tej.CudaRefIndex, "MAXEV", 18)
    st = {}
    got = tej.all2all_jax(codes, p, device=CPU, stats=st)
    assert np.array_equal(got, ne.all2all(codes, p))
    assert st["cap_fallbacks"] > 0
    assert st["fold_pairs"] + st["cap_fallbacks"] == 30


def test_long_genome_rows_raise(monkeypatch):
    monkeypatch.setattr(tej.CudaAll2All, "MAX_REF_SYMS", 1000)
    with pytest.raises(RuntimeError, match="--backend cuda"):
        tej.all2all_jax(small_family(), Params(), device=CPU)
    p = Params()
    p.min_anchor_len, p.min_seed_len = 20, 11
    with pytest.raises(RuntimeError, match="long-genome"):
        tej.all2all_jax(small_family(), p, device=CPU)


def test_ref_index_from_jax_equals_the_index_from_codes():
    p = Params()
    codes = CASES["n_runs"][0]
    jidx = jej.RefIndexJax(codes, p)
    got = tej.ref_index_from_jax(np.asarray(jidx.refbuf),
                                 np.asarray(jidx.ref_true), p, CPU)
    want = tej.RefIndexJax(codes, p, CPU)
    for name in ("refbuf", "nrs", "win", "ptab", "poslist"):
        assert torch.equal(getattr(got.index.gidx, name),
                           getattr(want.index.gidx, name)), name
    q = CASES["n_runs"][1]
    assert np.array_equal(got.parse_batch([q], p), want.parse_batch([q], p))
    with pytest.raises(ValueError):
        tej.ref_index_from_jax(np.asarray(jidx.refbuf), 17, p, CPU)


def test_all2all_reads_each_sequence_a_bounded_number_of_times(monkeypatch):
    """The CLI hands the engine a PackedCodes view, which unpacks a
    sequence on each access: a run reads each sequence for the resident
    query matrix and once more as a reference, never once per pair."""
    from lzani_tpu_torch.io.fasta import SequenceStore
    from lzani_tpu_torch.io.packing import PackedCodes

    store = SequenceStore()
    codes = small_family()
    for k, c in enumerate(codes):
        store.add(f"s{k}", c)
    reads = []
    real = PackedCodes.__getitem__
    monkeypatch.setattr(PackedCodes, "__getitem__",
                        lambda self, i: reads.append(i) or real(self, i))
    got = tej.all2all_jax(store.codes, Params(), device=CPU)
    assert np.array_equal(got, ne.all2all(codes, Params()))
    assert len(reads) <= 2 * len(codes)
