"""The batched replay of the device path (``native_engine.replay_unit``,
``finalize.UnitReplay``: one native call per downloaded unit) against the
per-pair replay (``finalize.Finalizer`` over ``native_engine.replay_events``
/ ``parse_pair``) and the JAX package's ``_make_finalize``: the triples and
the region records (as a set), on ``synth.small_family`` logs of the
native parse under random parameters. Cases: related and unrelated pairs,
pairs without a log (parsed natively), a reference whose pairs come in
two runs of the unit, the runs on one native thread or several, a
corrupted log (rejected, the unit's other pairs
still right), an empty unit, packed sequences, and output-filter
thresholds set exactly at a pair's gani / ani / qcov; and the download's
compaction of a dispatch's kept logs."""
import threading

import numpy as np
import pytest
import torch

from lzani_tpu.ops.hybrid import _make_finalize
from lzani_tpu.params import Params as JParams
from lzani_tpu_torch.core import native_engine as ne
from lzani_tpu_torch.io.packing import pack_items
from lzani_tpu_torch.ops import cuda_engine as tce
from lzani_tpu_torch.ops.finalize import Finalizer, UnitReplay
from lzani_tpu_torch.params import Params
from lzani_tpu_torch.synth import mutate, rand_params, small_family


def _family(seed):
    rng = np.random.RandomState(seed)
    codes = small_family(seed)
    codes.append(mutate(rng, codes[0], 0.08, n_ns=2, indels=3))
    return codes, rand_params(rng)


def _pairs(n):
    """Every ordered pair, by reference, with reference 0's split into two
    runs (its first half first, its second half last)."""
    pairs = [(r, q) for r in range(n) for q in range(n) if q != r]
    first = [pq for pq in pairs if pq[0] == 0]
    h = len(first) // 2
    return first[:h] + [pq for pq in pairs if pq[0] != 0] + first[h:]


def _unit(codes, p, pairs, no_log=(), corrupt=()):
    """The unit's arrays (r, q, slot, nev, off) and record block, with the
    pairs of `no_log` left without a log and the first ext of those of
    `corrupt` raised by one; and each pair's log (None without one)."""
    logs, blocks, off, k0 = [], [], [], 0
    for i, (r, q) in enumerate(pairs):
        if i in no_log:
            logs.append(None)
            off.append(0)
            continue
        ev = ne.parse_event_log(codes[r], codes[q], p).copy()
        if i in corrupt:
            ev[0, 4] += 1
        logs.append(ev)
        blocks.append(ev)
        off.append(k0)
        k0 += len(ev)
    r, q = (np.array(x, np.int32) for x in zip(*pairs))
    nev = np.array([-1 if ev is None else len(ev) for ev in logs], np.int32)
    ev = np.concatenate(blocks) if blocks else np.zeros((0, 8), np.int32)
    return (r, q, np.arange(len(pairs), dtype=np.int64), nev,
            np.array(off, np.int64), ev), logs


def _records(path):
    return sorted((r, q, regs.tobytes())
                  for r, q, regs in ne.read_region_dump(path))


def _batched(codes, p, unit, path, seqs=None, threads=1):
    out = np.zeros((len(unit[0]), 3), np.int32)
    with open(path, "wb") as rf:
        rep = UnitReplay(codes if seqs is None else seqs, p, out, rf)
        assert rep(*unit, threads=threads) == len(unit[0])
    return out, _records(path), rep


def _per_pair(codes, p, pairs, logs, path):
    out = np.zeros((len(pairs), 3), np.int32)
    with open(path, "wb") as rf:
        fin = Finalizer(codes, p, out, rf)
        for k, ((r, q), ev) in enumerate(zip(pairs, logs)):
            fin(r, q, ev, k)
    return out, _records(path), fin


def _jax(codes, p, pairs, logs, path):
    jp = JParams()
    for k, v in vars(p).items():
        setattr(jp, k, v)
    out = np.zeros((len(pairs), 3), np.int32)
    with open(path, "wb") as rf:
        fin = _make_finalize(codes, jp, out, rf, threading.Lock())
        for k, ((r, q), ev) in enumerate(zip(pairs, logs)):
            fin(r, q, ev, k)
    return out, _records(path)


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_unit_equals_per_pair_and_jax(seed, packed, threads, tmp_path):
    codes, p = _family(seed)
    pairs = _pairs(len(codes))
    no_log = {1, 9, len(pairs) - 1}          # capacity fallbacks
    unit, logs = _unit(codes, p, pairs, no_log=no_log)
    seqs = pack_items(codes) if packed else None
    out, recs, rep = _batched(codes, p, unit, tmp_path / "u", seqs, threads)
    want, want_recs, fin = _per_pair(codes, p, pairs, logs, tmp_path / "f")
    assert np.array_equal(out, want) and recs == want_recs
    jout, jrecs = _jax(codes, p, pairs, logs, tmp_path / "j")
    assert np.array_equal(out, jout) and recs == jrecs
    assert rep.replay_mismatches == fin.replay_mismatches == 0
    assert rep.pairs == len(pairs) and len(recs) > 0
    # related pairs match, and unrelated ones are in the unit too
    assert out[:, 0].max() > 1000 and (out[:, 0] < 100).any()
    status, _ = ne.replay_unit(rep.seqs, rep.cfg, *unit,
                               np.zeros_like(out))
    assert [k for k in range(len(pairs)) if status[k] == 1] == sorted(no_log)
    assert (status[[k for k in range(len(pairs)) if k not in no_log]]
            == 0).all()


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("seed", [4, 5])
def test_rejected_log_leaves_the_rest_right(seed, threads, tmp_path):
    codes, p = _family(seed)
    pairs = _pairs(len(codes))
    bad = {3, 20}
    unit, logs = _unit(codes, p, pairs, no_log={7}, corrupt=bad)
    out, recs, rep = _batched(codes, p, unit, tmp_path / "u",
                              threads=threads)
    want, want_recs, fin = _per_pair(codes, p, pairs, logs, tmp_path / "f")
    assert np.array_equal(out, want) and recs == want_recs
    assert sorted(rep.mismatched) == sorted(fin.mismatched) == sorted(
        pairs[k] for k in bad)
    assert not out[sorted(bad)].any()          # their slots stay unset
    # the JAX finalizer re-parses a rejected log: equal on the others
    jout, jrecs = _jax(codes, p, pairs, logs, tmp_path / "j")
    keep = [k for k in range(len(pairs)) if k not in bad]
    assert np.array_equal(out[keep], jout[keep])
    assert recs == [x for x in jrecs if (x[0], x[1]) not in rep.mismatched]
    status, _ = ne.replay_unit(rep.seqs, rep.cfg, *unit, np.zeros_like(out))
    assert sorted(np.flatnonzero(status == -1)) == sorted(bad)


def test_empty_unit(tmp_path):
    codes, p = _family(1)
    out = np.full((4, 3), 7, np.int32)
    with open(tmp_path / "u", "wb") as rf:
        rep = UnitReplay(codes, p, out, rf)
        empty_i, empty_l = np.zeros(0, np.int32), np.zeros(0, np.int64)
        assert rep(empty_i, empty_i, empty_l, empty_i, empty_l) == 0
    assert (out == 7).all() and _records(tmp_path / "u") == []
    assert rep.pairs == 0 and rep.replay_mismatches == 0


def test_unit_out_of_bounds_raises():
    codes, p = _family(1)
    unit, _ = _unit(codes, p, [(0, 1), (1, 0)])
    r, q, slot, nev, off, ev = unit
    seqs, cfg = ne.SeqTable(codes), ne.make_cfg(p)
    out = np.zeros((2, 3), np.int32)
    for bad in ((r, q + len(codes), slot, nev, off, ev),
                (r, q, slot + 1, nev, off, ev),
                (r, q, slot, nev, off + 1, ev)):
        with pytest.raises(ValueError, match="out of bounds"):
            ne.replay_unit(seqs, cfg, *bad, out)


def _filter_values(codes, p, r, q):
    """(gani, ani, qcov) of pair (r, q) as ``Finalizer`` computes them."""
    _, regs = ne.parse_pair(codes[r], codes[q], p, want_regions=True)
    m, lit = int(regs[:, 4].sum()), int(regs[:, 5].sum())
    return {"gani": m / len(codes[q]), "ani": m / (m + lit),
            "qcov": (m + lit) / len(codes[q])}


@pytest.mark.parametrize("key", ["gani", "ani", "qcov"])
@pytest.mark.parametrize("above", [False, True])
def test_filter_threshold_at_a_pairs_value(key, above, tmp_path):
    codes, _ = _family(2)
    p = Params()
    pairs = _pairs(len(codes))
    r, q = 0, 1                     # a 5% substituted copy: regions
    at = _filter_values(codes, p, r, q)[key]
    p.output_filter = {key: float(np.nextafter(at, 2.0)) if above else at}
    unit, logs = _unit(codes, p, pairs)
    out, recs, _ = _batched(codes, p, unit, tmp_path / "u")
    want, want_recs, _ = _per_pair(codes, p, pairs, logs, tmp_path / "f")
    assert np.array_equal(out, want) and recs == want_recs
    assert ((r, q) in {(a, b) for a, b, _ in recs}) is not above
    _, jrecs = _jax(codes, p, pairs, logs, tmp_path / "j")
    assert recs == jrecs


def test_download_compacts_the_kept_logs():
    """``_download_logs`` moves only the kept records, back to back: a
    pair with nev < 0, nev > cap or its overflow flag set has no log, and
    every kept log equals the first nev records of its dispatch row."""
    rng = np.random.RandomState(0)
    G, B, cap = 3, 5, 6
    ev = torch.from_numpy(rng.randint(-9, 9, (G, B, cap + 1, 8))
                          .astype(np.int32))
    nev = torch.from_numpy(rng.randint(-1, cap + 2, (G, B)).astype(np.int32))
    nev[0, 0], nev[1, 1], nev[2, 2] = -1, cap + 1, 0
    overflow = torch.zeros((G, B), dtype=torch.bool)
    overflow[2, 3] = True
    logs = tce._download_logs(ev, nev, cap, overflow)
    kept = [(g, b) for g in range(G) for b in range(B)
            if 0 <= nev[g, b] <= cap and not overflow[g, b]]
    assert len(logs.ev) == sum(int(nev[g, b]) for g, b in kept)
    for g in range(G):
        for b in range(B):
            got = logs[g][b]
            if (g, b) in kept:
                assert np.array_equal(got, ev[g, b, :nev[g, b]].numpy())
                o = int(logs.offsets(g, b))
                assert np.array_equal(logs.ev[o:o + len(got)], got)
            else:
                assert got is None and logs.nev[g, b] == -1
    empty = tce._download_logs(
        ev, torch.full((G, B), -1, dtype=torch.int32), cap)
    assert empty.ev.shape == (0, 8) and empty[1] == [None] * B


def test_concurrent_units_lose_nothing(tmp_path):
    """Units replayed at once on more threads than cores (the native calls
    run without the interpreter lock): every pair's triple, record and
    count arrives once."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    codes, p = _family(6)
    pairs = _pairs(len(codes))
    unit, _ = _unit(codes, p, pairs, no_log={2})
    r, q, slot, nev, off, ev = unit
    n_units, k = 48, len(pairs)
    out = np.zeros((n_units * k, 3), np.int32)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with open(tmp_path / "u", "wb") as rf:
            rep = UnitReplay(codes, p, out, rf)
            with ThreadPoolExecutor(max_workers=16) as pool:
                futs = [rep.submit(pool, r, q, slot + u * k, nev, off, ev,
                                   threads=2) for u in range(n_units)]
                assert sum(f.result(timeout=120) is None for f in futs) \
                    == n_units
    finally:
        sys.setswitchinterval(old)
    assert rep.pairs == n_units * k and rep.replay_mismatches == 0
    assert (out.reshape(n_units, k, 3) == out[:k]).all()
    recs = _records(tmp_path / "u")
    assert len(recs) == n_units * k
    assert rep.t_first <= rep.t_last and rep.c_s > 0
