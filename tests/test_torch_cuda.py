"""The CUDA kernels on a card. The parse kernels (group and long-genome
paths): their event logs equal their plain PyTorch versions' and the
native oracle's, the group kernel's capacity semantics match. The fold
kernel: stats, status and factors equal to its plain version on the
edge inputs of test_torch_fold_kernel.py, on corrupted logs and on
blocks of several warps, with its planes in shared or device memory and
with a small ring. The wrappers count launches. The cuda engine's
group route folds its logs on the card where no aln file is asked.
Every test here is marked ``cuda`` and skips
without a card. On a card:

    python -m pytest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from lzani_tpu.core import native_engine as ne
from lzani_tpu.params import Params
from lzani_tpu_torch import synth
from lzani_tpu_torch.ops import cuda_engine as tce
from lzani_tpu_torch.ops import parse_kernel as pk
from lzani_tpu_torch.ops.parse_kernel import (parse_events,
                                              parse_events_big,
                                              parse_events_big_plain,
                                              parse_events_plain)
from lzani_tpu_torch.synth import mutate, rand_params, small_family
from test_torch_big_kernel import EDGES as BIG_EDGES
from test_torch_big_kernel import assert_oracle, big_launch
from test_torch_fold_kernel import EDGES, kernel_args

pytestmark = pytest.mark.cuda


def pytest_generate_tests(metafunc):
    """Every test_kernel_* test runs on both instantiations of the group
    kernel: "shared" (the reference in shared memory, as these shapes
    choose) and "device" (a shared-memory limit of 0: read from device
    memory)."""
    if metafunc.function.__name__.startswith("test_kernel_"):
        metafunc.parametrize("kernel_words", ["shared", "device"],
                             indirect=True)


@pytest.fixture(autouse=True)
def kernel_words(request, monkeypatch):
    """The instantiation a test_kernel_* test runs on ("device": the
    card's shared-memory limit, which every launch's plan reads, taken as
    0); on a card, every group launch of the test went through it."""
    mode = getattr(request, "param", None)
    if mode == "device":
        monkeypatch.setattr(pk, "smem_limit", lambda dev: 0)
    n0 = (parse_events.launches_shared, parse_events.launches_device)
    yield mode
    if mode is not None and torch.cuda.is_available():
        ran = (parse_events.launches_shared - n0[0],
               parse_events.launches_device - n0[1])
        assert (ran[0] > 0, ran[1] > 0) == (mode == "shared",
                                            mode == "device"), ran


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _group_args(codes, params, r_list, dev):
    eng = tce.CudaAll2All(codes, params, devices=[dev])
    gi = eng.routes["group"].build(r_list, dev)
    q_rows, dsz = eng.Q[dev][:eng.B], eng.DSZ[dev][:eng.B]
    qbuf, cand, nh, ovf = tce.query_prep(q_rows, dsz, gi.ptab, eng.LqP,
                                         params.min_anchor_len,
                                         params.min_seed_len, eng.CNT_CAP)
    return eng, (gi.refbuf, qbuf, gi.poslist, cand, nh, gi.win,
                 dsz.contiguous(), gi.nrs, eng.cfg), ovf


def _assert_same_logs(a, b):
    (ev, nev), (ev2, nev2) = a, b
    assert torch.equal(nev, nev2)
    for g in range(nev.shape[0]):
        for b_ in range(nev.shape[1]):
            k = max(int(nev[g, b_]), 0)
            assert torch.equal(ev[g, b_, :k], ev2[g, b_, :k]), (g, b_)


@pytest.mark.parametrize("params", ["default", "narrow"])
def test_kernel_matches_plain_and_oracle(dev, params):
    p = Params()
    if params == "narrow":
        (p.min_anchor_len, p.min_seed_len, p.max_dist_in_ref,
         p.max_dist_in_query, p.min_region_len, p.approx_window,
         p.approx_mismatches, p.approx_run_len) = (9, 5, 17, 23, 20, 9, 3, 2)
    codes = small_family()
    eng, args, ovf = _group_args(codes, p, [0, 1, 2, 3], dev)
    out = parse_events(*args, ev_cap=eng.EV_CAP)
    _assert_same_logs(out, parse_events_plain(*args, ev_cap=eng.EV_CAP))
    logs = eng.routes["group"].collect((*out, ovf))
    for r in range(4):
        for q in range(len(codes)):
            if q != r:
                want = ne.parse_event_log(codes[r], codes[q], p)
                assert np.array_equal(logs[r][q], want), (r, q)


def test_kernel_event_capacity(dev):
    p = Params()
    rng = np.random.RandomState(33)
    ref = rng.randint(0, 4, 800).astype(np.uint8)
    q = np.concatenate([ref[j:j + 12] for j in rng.randint(0, 700, 40)])
    want = ne.parse_event_log(ref, q, p)
    n = len(want)
    _, args, _ = _group_args([ref, q], p, [0], dev)
    ev, nev = parse_events(*args, ev_cap=n - 2)
    assert int(nev[0, 1]) == -1
    _assert_same_logs((ev, nev), parse_events_plain(*args, ev_cap=n - 2))
    ev, nev = parse_events(*args, ev_cap=n)
    assert int(nev[0, 1]) == n
    assert np.array_equal(ev[0, 1, :n].cpu().numpy(), want)


def test_kernel_mutated_pairs(dev):
    rng = np.random.RandomState(3)
    base = rng.randint(0, 4, 6000).astype(np.uint8)
    unit = rng.randint(0, 4, 37).astype(np.uint8)
    codes = [mutate(rng, base, r, n_ns=k, indels=k % 4)
             for k, r in enumerate((0.0, 0.01, 0.05, 0.12, 0.3))]
    codes.append(np.concatenate([base[:2000], np.tile(unit, 40)]))
    p = Params()
    eng, args, ovf = _group_args(codes, p, [0, 2, 4, 5], dev)
    out = parse_events(*args, ev_cap=eng.EV_CAP)
    _assert_same_logs(out, parse_events_plain(*args, ev_cap=eng.EV_CAP))
    logs = eng.routes["group"].collect((*out, ovf))
    for g, r in enumerate([0, 2, 4, 5]):
        for q in range(len(codes)):
            if q != r:
                want = ne.parse_event_log(codes[r], codes[q], p)
                assert np.array_equal(logs[g][q], want), (r, q)


def test_kernel_query_bucket_above_2_18(dev):
    """~260 kb queries (2^18 < LqP <= 2^19, the JAX engine's v3 group
    route): kernel = plain = oracle."""
    rng = np.random.RandomState(19)
    ref = rng.randint(0, 4, 261_200).astype(np.uint8)
    q = mutate(rng, ref, 0.01, n_ns=3, indels=10)
    q[100_000:101_500] = rng.randint(0, 4, 1500)
    codes, p = [ref, q], Params()
    eng, args, ovf = _group_args(codes, p, [0, 1], dev)
    assert 1 << 18 < eng.LqP <= tce.CudaAll2All.MAX_Q
    out = parse_events(*args, ev_cap=eng.EV_CAP)
    _assert_same_logs(out, parse_events_plain(*args, ev_cap=eng.EV_CAP))
    logs = eng.routes["group"].collect((*out, ovf))
    for g, q_ in ((0, 1), (1, 0)):
        want = ne.parse_event_log(codes[g], codes[q_], p)
        assert np.array_equal(logs[g][q_], want), (g, q_)


def _stress_set(rng):
    """Eight 1-40 kb sequences of mixed relation: mutated copies of a base
    (tandem-repeat bases on some trials), N runs, spliced unrelated
    middles and unrelated sequences."""
    L = int(rng.randint(1000, 40_000))
    if rng.rand() < 0.25:
        unit = rng.randint(0, 4, rng.randint(15, 120)).astype(np.uint8)
        base = np.tile(unit, L // len(unit) + 1)[:L]
    else:
        base = rng.randint(0, 4, L).astype(np.uint8)
    codes = []
    for k in range(8):
        if k >= 6:
            codes.append(rng.randint(0, 4, rng.randint(1000, 40_000))
                         .astype(np.uint8))
            continue
        c = mutate(rng, base, rng.choice([0.0, 0.01, 0.04, 0.1, 0.25]),
                   n_ns=int(rng.randint(0, 6)), indels=int(rng.randint(0, 8)))
        if rng.rand() < 0.3:
            a = int(rng.randint(0, len(c) // 2))
            c[a:a + len(c) // 4] = rng.randint(0, 4, len(c[a:a + len(c) // 4]))
        if rng.rand() < 0.3:
            a = int(rng.randint(0, len(c) - 60))
            c[a:a + int(rng.randint(1, 50))] = 4
        codes.append(c)
    return codes


@pytest.mark.parametrize("block", range(8))
def test_kernel_random_stress(dev, block):
    """Randomised sets and parameters (every other trial), ten trials per
    block: every kernel log that is not a capacity fallback equals the
    oracle, pair for pair (8 x 7 ordered pairs per trial)."""
    checked = 0
    for trial in range(10):
        rng = np.random.RandomState(1000 + 10 * block + trial)
        codes = _stress_set(rng)
        p = rand_params(rng) if trial % 2 else Params()
        eng = tce.CudaAll2All(codes, p, devices=[dev])
        route = eng.routes["group"]
        for r_list in ([0, 1, 2, 3], [4, 5, 6, 7]):
            gi = route.build(r_list, dev)
            logs = route.collect(route.dispatch(gi, r_list, 0, dev))
            for g, r in enumerate(r_list):
                for q in range(len(codes)):
                    if q == r or logs[g][q] is None:
                        continue
                    want = ne.parse_event_log(codes[r], codes[q], p)
                    assert np.array_equal(logs[g][q], want), (trial, r, q)
                    checked += 1
    assert checked > 0


@pytest.mark.parametrize("block", range(2))
def test_kernel_tie_break_stress(dev, block):
    """Tandem repeats of short units (seed positions one period either side
    of pred tie on length and distance; anchors tie on length), mutated
    queries, aw above 32 on every trial: group kernel = plain = oracle, and
    the big kernel (mal 14-20) = plain = oracle, ten trials per block."""
    checked = 0
    for trial in range(10):
        rng = np.random.RandomState(9000 + 10 * block + trial)
        unit = rng.randint(0, 4, rng.randint(2, 13)).astype(np.uint8)
        L = int(rng.randint(800, 6000))
        flank = rng.randint(0, 4, 200).astype(np.uint8)
        ref = np.concatenate([flank, np.tile(unit, L // len(unit) + 1)[:L],
                              flank[::-1]])
        codes = [ref] + [mutate(rng, ref, rate, n_ns=k, indels=k)
                         for k, rate in enumerate((0.005, 0.02, 0.06))]
        p = rand_params(rng)
        p.approx_window = int(rng.randint(33, 90))
        p.approx_mismatches = int(rng.randint(1, p.approx_window))
        p.max_dist_in_ref = int(rng.randint(2 * len(unit) + 2, 64))
        eng, args, ovf = _group_args(codes, p, [0, 1, 2, 3], dev)
        out = parse_events(*args, ev_cap=eng.EV_CAP)
        _assert_same_logs(out, parse_events_plain(*args, ev_cap=eng.EV_CAP))
        logs = eng.routes["group"].collect((*out, ovf))
        for r in range(4):
            for q in range(4):
                if q != r and logs[r][q] is not None:
                    want = ne.parse_event_log(codes[r], codes[q], p)
                    assert np.array_equal(logs[r][q], want), (trial, r, q)
                    checked += 1
        p.min_anchor_len = int(rng.randint(14, 21))
        p.min_seed_len = min(p.min_seed_len, p.min_anchor_len - 1)
        beng, r_list, bargs = _big_args(codes, p, dev, force=True)
        bout = parse_events_big(*bargs)
        _assert_same_logs(bout, parse_events_big_plain(*bargs))
        checked += _assert_oracle(beng, bout, codes, p, r_list)
    assert checked > 0


def _tie_set(rng):
    """The group half of test_kernel_tie_break_stress's trial: a tandem
    repeat reference, three mutated copies and parameters with aw > 32."""
    unit = rng.randint(0, 4, rng.randint(2, 13)).astype(np.uint8)
    L = int(rng.randint(800, 6000))
    flank = rng.randint(0, 4, 200).astype(np.uint8)
    ref = np.concatenate([flank, np.tile(unit, L // len(unit) + 1)[:L],
                          flank[::-1]])
    codes = [ref] + [mutate(rng, ref, rate, n_ns=k, indels=k)
                     for k, rate in enumerate((0.005, 0.02, 0.06))]
    p = rand_params(rng)
    p.approx_window = int(rng.randint(33, 90))
    p.approx_mismatches = int(rng.randint(1, p.approx_window))
    p.max_dist_in_ref = int(rng.randint(2 * len(unit) + 2, 64))
    return codes, p


def _row_logs(codes, r, p, dev, plain=False):
    """One launch of reference r x every other sequence (G = 1, the
    automaton backend's row shape, through CudaRefIndex): {q: log or
    None}; with `plain`, kernel = plain on the launch's inputs too."""
    qids = [q for q in range(len(codes)) if q != r]
    idx = tce.CudaRefIndex(codes[r], p, device=dev)
    if plain:
        args, _ = idx.batch_args([codes[q] for q in qids])
        _assert_same_logs(parse_events(*args), parse_events_plain(*args))
    return dict(zip(qids, idx.parse_events_batch([codes[q] for q in qids])))


@pytest.mark.parametrize("block", range(8))
def test_kernel_random_stress_row_shape(dev, block):
    """test_kernel_random_stress's sets and parameters at the row shape:
    each sequence as the one reference of a launch over the other seven;
    every log that is not a capacity fallback equals the oracle."""
    checked = 0
    for trial in range(10):
        rng = np.random.RandomState(1000 + 10 * block + trial)
        codes = _stress_set(rng)
        p = rand_params(rng) if trial % 2 else Params()
        for r in range(len(codes)):
            for q, ev in _row_logs(codes, r, p, dev).items():
                if ev is not None:
                    want = ne.parse_event_log(codes[r], codes[q], p)
                    assert np.array_equal(ev, want), (trial, r, q)
                    checked += 1
    assert checked > 0


@pytest.mark.parametrize("block", range(2))
def test_kernel_tie_break_stress_row_shape(dev, block):
    """test_kernel_tie_break_stress's group sets at the row shape: kernel
    = plain for every pair of each reference's launch, and = oracle for
    every pair that is not a capacity fallback (tandem repeats put many
    rows over CNT_CAP)."""
    checked = 0
    for trial in range(10):
        codes, p = _tie_set(np.random.RandomState(9000 + 10 * block + trial))
        for r in range(len(codes)):
            logs = _row_logs(codes, r, p, dev, plain=True)
            checked += len(logs)
            for q, ev in logs.items():
                if ev is not None:
                    want = ne.parse_event_log(codes[r], codes[q], p)
                    assert np.array_equal(ev, want), (trial, r, q)
    assert checked > 0


@pytest.mark.parametrize("msl", [5, 11, 20, 27])
def test_kernel_seed_lengths(dev, msl):
    """Seed lengths 5 and 11: kernel = plain = oracle. Above 16 (20 and
    27, the WIN table's saturation): kernel = plain only, at mal 13 (the
    group path needs mal <= 13, and the native oracle msl <= mal)."""
    rng = np.random.RandomState(77)
    base = rng.randint(0, 4, 5000).astype(np.uint8)
    codes = [mutate(rng, base, rate, n_ns=2, indels=3)
             for rate in (0.0, 0.02, 0.05, 0.1)]
    p = Params()
    p.min_seed_len = msl
    p.min_anchor_len = 11 if msl <= 11 else 13
    eng, args, ovf = _group_args(codes, p, [0, 1, 2, 3], dev)
    out = parse_events(*args, ev_cap=eng.EV_CAP)
    _assert_same_logs(out, parse_events_plain(*args, ev_cap=eng.EV_CAP))
    if msl > p.min_anchor_len:
        return
    logs = eng.routes["group"].collect((*out, ovf))
    for r in range(4):
        for q in range(4):
            if q != r:
                want = ne.parse_event_log(codes[r], codes[q], p)
                assert np.array_equal(logs[r][q], want), (r, q)


def test_large_reference_takes_the_device_instantiation(dev):
    """A 300 kb genome and a 1% relative: the composite of 600,120
    symbols needs LrP 2^20, whose planes (384 KiB) do not fit in shared
    memory, so the launch takes the device-memory instantiation (its
    counter moves, the other's does not); kernel = plain = oracle."""
    rng = np.random.RandomState(23)
    ref = rng.randint(0, 4, 300_000).astype(np.uint8)
    q = mutate(rng, ref, 0.01, n_ns=3, indels=10)
    q[150_000:151_500] = rng.randint(0, 4, 1500)
    codes, p = [ref, q], Params()
    eng, args, ovf = _group_args(codes, p, [0, 1], dev)
    assert eng.paths == ["group", "group"] and eng.LrP_ref == 1 << 20
    n0 = (parse_events.launches_shared, parse_events.launches_device)
    out = parse_events(*args, ev_cap=eng.EV_CAP)
    assert (parse_events.launches_shared,
            parse_events.launches_device) == (n0[0], n0[1] + 1)
    _assert_same_logs(out, parse_events_plain(*args, ev_cap=eng.EV_CAP))
    logs = eng.routes["group"].collect((*out, ovf))
    for g, q_ in ((0, 1), (1, 0)):
        want = ne.parse_event_log(codes[g], codes[q_], p)
        assert np.array_equal(logs[g][q_], want), (g, q_)


def test_ref_index_batch_on_card(dev):
    """CudaRefIndex.parse_events_batch on the card: one launch, kernel =
    plain on the same inputs, logs = oracle, the over-CNT_CAP query None."""
    rng = np.random.RandomState(5)
    unit = rng.randint(0, 4, 13).astype(np.uint8)
    ref = np.concatenate([rng.randint(0, 4, 9000).astype(np.uint8),
                          np.tile(unit, 140)])
    qs = [mutate(rng, ref[:8000], rate, n_ns=2, indels=3)
          for rate in (0.0, 0.01, 0.05, 0.12)]
    qs += [rng.randint(0, 4, 5000).astype(np.uint8), ref[8500:].copy()]
    p = Params()
    idx = tce.CudaRefIndex(ref, p, device=dev)
    args, overflow = idx.batch_args(qs)
    assert overflow.cpu().tolist() == [[False] * 5 + [True]]
    _assert_same_logs(parse_events(*args), parse_events_plain(*args))
    n0 = parse_events.launches
    logs = idx.parse_events_batch(qs)
    assert parse_events.launches == n0 + 1
    assert logs[-1] is None
    for q, ev in zip(qs[:-1], logs[:-1]):
        assert np.array_equal(ev, ne.parse_event_log(ref, q, p))


def test_dispatch_range_on_card(dev):
    """CudaAll2All.dispatch_range / collect / run_range on the card for
    every reference of the small family: kernel = plain = oracle."""
    codes = small_family()
    p = Params()
    eng = tce.CudaAll2All(codes, p, devices=[dev])
    for r in range(len(codes)):
        idx = eng.build_index(r, dev)
        args, _ = eng.routes["group"].args(idx, 0, dev)
        _assert_same_logs(parse_events(*args), parse_events_plain(*args))
        logs = eng.collect(eng.dispatch_range(r, 0, dev, idx))
        assert len(logs) == eng.B
        for q in range(len(codes)):
            want = ne.parse_event_log(codes[r], codes[q], p)
            assert np.array_equal(logs[q], want), (r, q)
        assert all(np.array_equal(a, b) for a, b in
                   zip(eng.run_range(r, 0)[:len(codes)], logs))


def test_launch_counter(dev):
    codes = small_family()
    p = Params()
    eng, args, _ = _group_args(codes, p, [0, 1], dev)
    n0 = parse_events.launches
    parse_events(*args, ev_cap=eng.EV_CAP)
    parse_events_plain(*args, ev_cap=eng.EV_CAP)
    torch.cuda.synchronize()
    assert parse_events.launches == n0 + 1


# ---------------------------------------------------------------------------
# long-genome kernel
# ---------------------------------------------------------------------------

def _big_args(codes, params, dev, r_list=None, force=False):
    """One long-genome launch: `r_list` (default: every reference) x the
    first B_big queries. `force` sends group-sized rows big."""
    old = tce.CudaAll2All.MAX_REF_SYMS
    if force:
        tce.CudaAll2All.MAX_REF_SYMS = 0
    try:
        eng = tce.CudaAll2All(codes, params, devices=[dev])
    finally:
        tce.CudaAll2All.MAX_REF_SYMS = old
    r_list = list(range(len(codes))) if r_list is None else r_list
    eng.big_launch_shape(len(r_list), dev)
    bidx = eng.routes["big"].build(r_list, dev)
    return eng, r_list, eng.routes["big"].args(bidx, r_list, 0, dev)


def _assert_oracle(eng, out, codes, p, r_list):
    logs = eng.routes["big"].collect(out)
    checked = 0
    for g, r in enumerate(r_list):
        for q in range(min(len(codes), eng.B_big)):
            if q == r:
                assert len(logs[g][q]) == 0                # no-op self pair
            elif logs[g][q] is not None:
                want = ne.parse_event_log(codes[r], codes[q], p)
                assert np.array_equal(logs[g][q], want), (r, q)
                checked += 1
    return checked


def _tandem_set():
    rng = np.random.RandomState(11)
    unit = rng.randint(0, 4, 13).astype(np.uint8)
    base = rng.randint(0, 4, 900).astype(np.uint8)
    g1 = np.concatenate([base[:300], np.tile(unit, 150), base[300:]])
    q1 = g1.copy()
    m = rng.rand(len(q1)) < 0.05
    q1[m] = (q1[m] + rng.randint(1, 4, m.sum())) % 4
    return [g1, q1, base, rng.randint(0, 4, 700).astype(np.uint8)]


@pytest.mark.parametrize("mal,msl", [(11, 7), (20, 11)])
def test_big_kernel_matches_plain_and_oracle_on_tandem_repeats(dev, mal,
                                                               msl):
    codes = _tandem_set()
    p = Params()
    p.min_anchor_len, p.min_seed_len = mal, msl
    eng, r_list, args = _big_args(codes, p, dev, force=True)
    out = parse_events_big(*args)
    _assert_same_logs(out, parse_events_big_plain(*args))
    assert _assert_oracle(eng, out, codes, p, r_list) == 12


def test_big_kernel_on_a_2mb_related_pair(dev):
    """A 2 Mb bacterial-shaped genome and a 3% relative with structural
    indels, both ways, at the tuned parameters: kernel = plain = oracle."""
    rng = np.random.RandomState(23)
    g = synth.bacterial_genome(rng, 2_000_000)
    codes = [g, synth.bacterial_relative(rng, g, 0.03)]
    p = synth.bacterial_params()
    eng, r_list, args = _big_args(codes, p, dev)
    assert eng.LqP >= 1 << 21 and eng.G_big == 2
    out = parse_events_big(*args)
    _assert_same_logs(out, parse_events_big_plain(*args))
    assert _assert_oracle(eng, out, codes, p, r_list) == 2


def test_big_kernel_on_a_9mb_related_pair(dev):
    """The top of the bacterial band: a 9 Mb genome and a 3% relative with
    structural indels, both ways, at the tuned parameters: kernel = plain
    = oracle."""
    rng = np.random.RandomState(29)
    g = synth.bacterial_genome(rng, 9_000_000)
    codes = [g, synth.bacterial_relative(rng, g, 0.03)]
    p = synth.bacterial_params()
    eng, r_list, args = _big_args(codes, p, dev)
    assert eng.LqP == 1 << 24 and eng.G_big == 2
    out = parse_events_big(*args)
    _assert_same_logs(out, parse_events_big_plain(*args))
    assert _assert_oracle(eng, out, codes, p, r_list) == 2


@pytest.mark.parametrize("block", range(4))
def test_big_kernel_random_stress(dev, block):
    """Randomised sets (as test_kernel_random_stress) with a random mal in
    [14, 26] on odd trials and the default parameters sent big on even
    ones, ten trials per block: every log that is not a capacity fallback
    equals the oracle (8 x 7 ordered pairs per trial)."""
    checked = 0
    for trial in range(10):
        rng = np.random.RandomState(5000 + 10 * block + trial)
        codes = _stress_set(rng)
        p = Params()
        if trial % 2:
            p = rand_params(rng)
            p.min_anchor_len = int(rng.randint(14, 27))
        eng, r_list, args = _big_args(codes, p, dev, force=True)
        checked += _assert_oracle(eng, parse_events_big(*args), codes, p,
                                  r_list)
    assert checked > 0


@pytest.mark.parametrize("name", BIG_EDGES)
def test_big_kernel_on_an_edge_input(dev, name):
    """The edge inputs of test_torch_big_kernel.py (anchor positions of 59
    and 149 candidates, a literal run to the desync, lengths at word
    edges, self pairs and padding rows whose tables are garbage): kernel
    = plain = oracle."""
    codes, p, r_list, args = big_launch(name, dev)
    out = parse_events_big(*args)
    _assert_same_logs(out, parse_events_big_plain(*args))
    assert assert_oracle(codes, p, r_list, *out) > 0


def test_big_kernel_parses_a_pair_shorter_than_its_query_planes(dev):
    """A query's planes are packed to its longest pair: pair (2, 0) (the
    900 bp base inside the tandem genome at 2250) given a length that cuts
    its 600-symbol exact match at 2250 in half reads the query as N from
    there, and every pair's log equals the plain version's."""
    _, _, args = _big_args(_tandem_set(), Params(), dev, force=True)
    dsz = args[6].clone()
    assert int(dsz[2, 0]) == int(dsz[:, 0].max()) == 2890
    dsz[2, 0] = 2250 + 300
    cut = (*args[:6], dsz, *args[7:])
    ev, nev = parse_events_big(*cut)
    _assert_same_logs((ev, nev), parse_events_big_plain(*cut))
    assert ev[2, 0, :int(nev[2, 0]), :3].tolist() == [[0, 0, 300],
                                                      [2250, 300, 300]]


def test_big_kernel_probe_build(dev):
    """The probe build's logs equal the kernel's; it counts every pair
    that parses (steps > 0 exactly where dsz > msl) and is not a
    launch."""
    _, _, args = _big_args(_tandem_set(), Params(), dev, force=True)
    n0 = parse_events_big.launches
    ev, nev, counts = pk.parse_events_big_probe(*args)
    assert parse_events_big.launches == n0
    _assert_same_logs((ev, nev), parse_events_big(*args))
    steps = counts[..., pk.PROBE_FIELDS.index("steps")]
    assert torch.equal(steps > 0, args[6] > args[8].msl)


def test_big_launch_counter(dev):
    codes = _tandem_set()
    _, _, args = _big_args(codes, Params(), dev, force=True)
    n0, g0 = parse_events_big.launches, parse_events.launches
    parse_events_big(*args)
    parse_events_big_plain(*args)
    torch.cuda.synchronize()
    assert parse_events_big.launches == n0 + 1
    assert parse_events.launches == g0


def test_hybrid_on_card_matches_native(dev, monkeypatch):
    """The hybrid backend on the card, its claim gates lifted: equal to
    the native engine, the device side took rows, and every group launch
    (the warm-up's dummy group included) is on the wrapper's counter."""
    from lzani_tpu_torch.core import native_engine as tne
    from lzani_tpu_torch.ops.hybrid import all2all_hybrid
    from lzani_tpu_torch.params import Params as TParams

    monkeypatch.setenv("LZANI_TPU_HYBRID_GREEDY", "1")
    _, codes = synth.viral_set(seed=7, n=96)
    codes.sort(key=len, reverse=True)
    p = TParams()
    n0 = parse_events.launches
    st = {}
    out = all2all_hybrid(codes, p, cpu_threads=1, stats=st)
    assert np.array_equal(out, tne.all2all(codes, p))
    assert st["warm_why"] is None and st["device_pairs"] > 0
    assert st["device_pairs"] + st["cpu_pairs"] == 96 * 95
    assert st["launches"] == parse_events.launches - n0 > 0
    assert st["replay_mismatches"] == 0 and st["failed_rows"] == 0


def test_hybrid_cli_drains_while_the_kernels_build(dev, tmp_path):
    """A checkout with nothing built: the greedy hybrid's warm-up imports
    torch and builds the kernels with nvcc while the native pool runs.
    When the pool drains first the CLI still exits 0, with outputs equal
    to the native backend's: the warm thread is parked and joined at
    exit, never killed mid-build."""
    import os
    import shutil
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    shutil.copytree(os.path.join(root, "lzani_tpu_torch"),
                    tmp_path / "lzani_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    names, codes = synth.viral_set(seed=9, n=128)
    fa = str(tmp_path / "in.fna")
    synth.write_fasta(fa, names, codes)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    outs = {}
    for backend, cwd in (("native", root), ("hybrid", str(tmp_path))):
        out = str(tmp_path / f"{backend}.tsv")
        res = subprocess.run(
            [sys.executable, "-m", "lzani_tpu_torch", "all2all", "--in-fasta",
             fa, "--out", out, "-t", "2", "-V", "2", "--backend", backend],
            cwd=cwd, capture_output=True, text=True, timeout=900,
            env=dict(env, LZANI_TPU_HYBRID_GREEDY="1"))
        assert res.returncode == 0, res.stderr[-2000:]
        with open(out, "rb") as f1, open(out[:-4] + ".ids.tsv", "rb") as f2:
            outs[backend] = f1.read() + f2.read()
        print(backend, [ln for ln in res.stderr.splitlines()
                        if ln.startswith(("lz-ani-torch engine", "Total"))])
    assert outs["hybrid"] == outs["native"]


def test_hybrid_on_card_fails_after_a_warm_failure(dev, monkeypatch):
    """On the card a warm-up that fails leaves the rows to the native pool
    and then fails the run: no run asked to use the card succeeds
    without it."""
    import threading
    import time

    from lzani_tpu_torch.core import native_engine as tne
    from lzani_tpu_torch.ops.hybrid import all2all_hybrid
    from lzani_tpu_torch.params import Params as TParams

    tried = threading.Event()

    def dead(self, idx, r_list, lo, device=None, qidx=None, spans=None):
        tried.set()
        raise RuntimeError("injected: device unreachable")

    real = tne.all2all

    def held(codes, params, **kw):
        if kw.get("ext_counter") is not None:
            tried.wait(120.0)
            time.sleep(0.2)
        return real(codes, params, **kw)

    monkeypatch.setenv("LZANI_TPU_HYBRID_GREEDY", "1")
    monkeypatch.setattr(tce.GroupRoute, "dispatch", dead)
    monkeypatch.setattr(tne, "all2all", held)
    _, codes = synth.viral_set(seed=7, n=24)
    codes.sort(key=len, reverse=True)
    st = {}
    with pytest.raises(RuntimeError, match="the CUDA device failed"):
        all2all_hybrid(codes, TParams(), cpu_threads=1, stats=st)
    assert "injected" in st["warm_why"] and st["cpu_pairs"] == 24 * 23


def test_all2all_cuda_two_entries_on_one_card(dev):
    """Units round-robin over two entries on the one card
    (devices=[cuda:0, cuda:0]): triples equal to the native engine's on 48
    viral genomes, both entries ran units and every launch is counted."""
    from lzani_tpu_torch.core import native_engine as tne
    from lzani_tpu_torch.params import Params as TParams

    _, codes = synth.viral_set(seed=7, n=48)
    p = TParams()
    n0 = parse_events.launches
    st = {}
    out = tce.all2all_cuda(codes, p, devices=[dev, dev], stats=st)
    assert np.array_equal(out, tne.all2all(codes, p))
    assert len(st["device_units"]) == 2 and min(st["device_units"]) > 0
    assert st["launches"] == parse_events.launches - n0 == st["dispatches"]
    assert st["replay_mismatches"] == 0


def test_the_fold_route_on_card_equals_native(dev, tmp_path):
    """Without an aln file the CLI's cuda run folds every group unit on
    the card: TSV and ids byte-equal to --backend native on 48 viral
    genomes, every kernel pair folded and the host replaying only the
    capacity fallbacks; with an aln file the same set is replayed on the
    host (no pair folded), its aln rows equal to native's as a set."""
    from lzani_tpu_torch import cli as tcli
    from lzani_tpu_torch.ops import fold_stats as fk

    names, codes = synth.viral_set(seed=7, n=48)
    fa = str(tmp_path / "in.fna")
    synth.write_fasta(fa, names, codes)

    def run(backend, aln):
        out = str(tmp_path / f"{backend}{int(aln)}.tsv")
        argv = ["all2all", "--in-fasta", fa, "--out", out, "-t", "4",
                "-V", "0", "--backend", backend]
        if aln:
            argv += ["--out-alignment", out + ".aln"]
        rc, m = tcli.run(argv)
        assert rc == 0
        with open(out, "rb") as f1, open(out[:-4] + ".ids.tsv", "rb") as f2:
            got = f1.read() + f2.read()
        rows = None
        if aln:
            with open(out + ".aln") as fh:
                rows = fh.read().splitlines()
            rows = (rows[0], sorted(rows[1:]))
        return got, rows, m.engine_stats

    native = run("native", False)[0]
    n0 = fk.fold_stats.launches
    got, _, st = run("cuda", False)
    assert got == native
    assert st["fold_pairs"] == st["kernel_pairs"] > 0
    assert st["replay_pairs"] == st["cap_fallbacks"]
    assert fk.fold_stats.launches - n0 == st["dispatches"]
    assert st["replay_mismatches"] == 0
    native, native_aln, _ = run("native", True)
    n0 = fk.fold_stats.launches
    got, aln, st = run("cuda", True)
    assert got == native and aln == native_aln
    assert st["fold_pairs"] == 0 and fk.fold_stats.launches == n0
    assert st["replay_pairs"] == st["kernel_pairs"] + st["cap_fallbacks"]


#: the long-genome path's device stages and the span each one nests in
BIG_STAGES = {"dev.kmers": ("dev.join", "dev.prep"), "dev.sort": ("dev.join",),
              "dev.search": ("dev.prep",), "dev.next_hit": ("dev.prep",)}


def test_reference_buffers_derived_on_card(dev):
    """On the card, the buffers an index derives from the query matrix's
    rows equal ``ref_buffer_np``: a long-genome index of a 5 Mb genome
    (with N runs) and a relative at LrP 2^24, and a viral group of 4."""
    from lzani_tpu_torch.ops.prep import ref_buffer_np

    rng = np.random.RandomState(41)
    g = synth.bacterial_genome(rng, 5_000_000)
    g[1000:1100], g[2000:2050] = 4, 5
    codes = [g, synth.bacterial_relative(rng, g, 0.04)]
    p = synth.bacterial_params()
    mrd = p.max_dist_in_ref
    eng = tce.CudaAll2All(codes, p, devices=[dev])
    eng.big_launch_shape(2, dev)
    bidx = eng.routes["big"].build([0, 1], dev)
    assert bidx.LrP == 1 << 24
    for k, c in enumerate(codes):
        assert np.array_equal(bidx.refbuf[k].cpu().numpy(),
                              ref_buffer_np(c, mrd, pad_to=bidx.LrP)), k
    _, viral = synth.viral_set(seed=7, n=8)
    eng = tce.CudaAll2All(viral, Params(), devices=[dev])
    gi = eng.routes["group"].build([0, 1, 2, 3], dev)
    want = np.stack([ref_buffer_np(viral[r], Params().max_dist_in_ref,
                                   pad_to=gi.LrP) for r in range(4)])
    assert np.array_equal(gi.refbuf.cpu().numpy(), want)


def test_long_genome_spans_record_the_device_stages(dev, monkeypatch):
    """Under a profiler a long-genome run records its four device stages,
    each inside its unit's ``dev.join`` or ``dev.prep`` and together no
    longer than they; a group-path run records none of them. With spans
    off no CUDA event is made and the triples are the same."""
    from torch.profiler import profile

    from lzani_tpu_torch.params import Params as TParams

    rng = np.random.RandomState(31)
    codes = []
    for L in (400_000, 300_000):
        g = synth.bacterial_genome(rng, L)
        codes += [g, synth.bacterial_relative(rng, g, 0.04)]
    p = synth.bacterial_params()
    st = {}
    with profile():
        ref = tce.all2all_cuda(codes, p, device=dev, stats=st)
    assert st["big_rows"] == 4 and st["big_pairs"] == 12
    by = {}
    for s in st["spans"]:
        by.setdefault(s[0], []).append(s)
    assert all(by.get(n) for n in BIG_STAGES), sorted(by)
    for name, outer in BIG_STAGES.items():
        for s in by[name]:
            assert s[4] == str(dev)
            assert any(o[1] == s[1] and o[2] <= s[2] + 1e-6
                       and s[3] <= o[3] + 1e-6
                       for n in outer for o in by[n]), (name, s)

    def total(names):
        return sum(s[3] - s[2] for n in names for s in by[n])
    assert total(BIG_STAGES) <= total(("dev.join", "dev.prep")) + 1e-6
    # one buffer derivation per index build, each before its join
    assert len(by["dev.refs"]) == len(by["unit.index"])
    for s in by["dev.refs"]:
        assert s[4] == str(dev)
        assert any(j[1] == s[1] and s[3] <= j[2] + 1e-6
                   for j in by["dev.join"]), s
    assert len(by["unit.replay"]) == st["dispatches"]

    class _NoEvent:
        def __init__(self, *a, **kw):
            raise AssertionError("a CUDA event was made with spans off")

    with monkeypatch.context() as mp:
        mp.setattr(torch.cuda, "Event", _NoEvent)
        st_off = {}
        out = tce.all2all_cuda(codes, p, device=dev, stats=st_off)
    assert "spans" not in st_off and np.array_equal(out, ref)

    _, viral = synth.viral_set(seed=5, n=24)
    st = {}
    with profile():
        tce.all2all_cuda(viral, TParams(), device=dev, stats=st)
    names = {s[0] for s in st["spans"]}
    assert {"dev.refs", "dev.join", "dev.prep"} <= names
    assert not names & set(BIG_STAGES)


# ---------------------------------------------------------------------------
# the automaton backend: the fold kernel
# ---------------------------------------------------------------------------

def test_fold_kernel_matches_plain_and_all2all_jax_matches_native(dev):
    """The fold kernel on the parse kernel's logs of the 12 pairs of
    test_torch_engine_jax.py (one launch each, with and without factors)
    equals its plain version and the native engine, every status 0; then
    all2all_jax on the card equals native_engine.all2all on 32 viral
    genomes, every launch counted."""
    from test_torch_engine_jax import CASES

    from lzani_tpu_torch.core import native_engine as tne
    from lzani_tpu_torch.ops import engine_jax as tej
    from lzani_tpu_torch.ops.fold_stats import fold_stats, fold_stats_plain
    from lzani_tpu_torch.params import Params as TParams

    p = Params()
    for name, (ref, q) in CASES.items():
        args, _ = tce.CudaRefIndex(ref, p, device=dev).batch_args([q])
        ev, nev = parse_events(*args)
        fargs = (args[0], args[1], ev, nev, args[6], args[7], args[8])
        cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in fargs]
        n0 = fold_stats.launches
        st, status = fold_stats(*fargs)
        st_f, status_f, fac, nfac = fold_stats(*fargs, want_factors=True)
        assert fold_stats.launches == n0 + 2
        pst, pstatus, pfac, pnfac = fold_stats_plain(*cpu, want_factors=True)
        assert status.tolist() == status_f.tolist() == pstatus.tolist() == [
            [0]], name
        assert torch.equal(st.cpu(), pst) and torch.equal(st_f.cpu(), pst)
        assert tuple(pst[0, 0].tolist()) == ne.parse_pair(ref, q, p)[0]
        assert torch.equal(nfac.cpu(), pnfac), name
        k = int(pnfac[0, 0])
        assert torch.equal(fac[0, 0, :k].cpu(), pfac[0, 0, :k]), name
    _, codes = synth.viral_set(seed=7, n=32)
    tp = TParams()
    st = {}
    out = tej.all2all_jax(codes, tp, stats=st)
    assert np.array_equal(out, tne.all2all(codes, tp))
    assert st["launches"] == st["fold_launches"] == st["batches"] == 32
    assert st["replay_mismatches"] == 0
    assert st["fold_pairs"] + st["cap_fallbacks"] == 32 * 31
    assert st["cap_fallbacks"] < 0.01 * 32 * 31
    st2 = {}
    out = tej.all2all_jax(codes, tp, device=[dev, dev], stats=st2)
    assert np.array_equal(out, tne.all2all(codes, tp))
    assert st2["launches"] == st2["fold_launches"] == 2 * 32


def _same_fold(got, want, tag):
    """Stats, status, factor counts and each pair's defined factors of two
    fold launches (got on the card, want on the CPU) equal."""
    stats, status, fac, nfac = (t.cpu() for t in got)
    w_stats, w_status, w_fac, w_nfac = want
    assert torch.equal(status, w_status), tag
    assert torch.equal(stats, w_stats), tag
    assert torch.equal(nfac, w_nfac), tag
    for g in range(nfac.shape[0]):
        for b in range(nfac.shape[1]):
            k = int(w_nfac[g, b])
            assert torch.equal(fac[g, b, :k], w_fac[g, b, :k]), (tag, g, b)


def _fold_placements(dev, cpu_args, cfg, tag):
    """The fold kernel with the launch plan the shapes choose, with its
    planes read from device memory (a shared-memory limit that only the
    ring fits) and with a ring of 32 entries (the stack's bottom in device
    memory), with and without factors, each equal to the plain version."""
    from lzani_tpu_torch.ops import fold_stats as fs

    want = fs.fold_stats_plain(*cpu_args, cfg, want_factors=True)
    args = [a.to(dev) for a in cpu_args]
    n0 = fs.fold_stats.launches
    G, LrP = args[0].shape
    B, LqP = args[1].shape
    warps = fs.launch_plan(G, B, LrP, LqP, pk.sm_count(dev),
                           fs.smem_limit(dev))[3]
    placements = ({}, {"smem_max": warps * fs.RING * 8}, {"ring": 32})
    for kw in placements:
        _same_fold(fs.fold_stats(*args, cfg, want_factors=True, **kw), want,
                   f"{tag} {kw}")
        stats, status = fs.fold_stats(*args, cfg, **kw)
        assert torch.equal(status.cpu(), want[1]), (tag, kw)
        assert torch.equal(stats.cpu(), want[0]), (tag, kw)
    assert fs.fold_stats.launches == n0 + 2 * len(placements)
    return want


@pytest.mark.parametrize("name", list(EDGES))
def test_fold_kernel_on_an_edge_input(dev, name):
    """The fold kernel on each edge input of test_torch_fold_kernel.py (the
    oracle's event log) equals its plain version in every placement
    (``_fold_placements``), status 0."""
    from lzani_tpu_torch.ops.parse import ParseCfg

    ref, q, p = EDGES[name]
    want = _fold_placements(dev, kernel_args(ref, q, p),
                            ParseCfg.from_params(p), name)
    assert want[1].tolist() == [[0]]


@pytest.mark.parametrize("field,delta", [(3, 1), (4, 1), (4, -1),
                                         (0, 10**6)],
                         ids=["bwd", "ext_up", "ext_down", "order"])
def test_fold_kernel_rejects_a_corrupted_log(dev, field, delta):
    """The corrupted logs of test_torch_engine_jax.py's
    test_a_corrupted_log_is_rejected on the card: every pair with a log
    has status -1 and no stats, the pair without one status 1, in every
    placement, equal to the plain version."""
    from test_torch_engine_jax import CASES, fold_args

    from lzani_tpu_torch.ops.parse import ParseCfg

    p = Params()
    refs = [CASES["subs2pct"][0], CASES["translocation"][0]]
    qs = [CASES[k][1] for k in ("subs2pct", "indels", "translocation")]
    R, Q, E, N, D, NR = fold_args(refs, qs, p)
    R = torch.nn.functional.pad(R, (0, -R.shape[1] % 128), value=4)
    Q = torch.nn.functional.pad(Q, (0, -Q.shape[1] % 128), value=5)
    for g in range(N.shape[0]):
        for b in range(N.shape[1]):
            E[g, b, int(N[g, b]) // 2, field] += delta
    N[1, 2] = -1
    want = _fold_placements(dev, (R, Q, E, N, D, NR),
                            ParseCfg.from_params(p), f"{field} {delta}")
    assert want[1].tolist() == [[-1, -1, -1], [-1, -1, 1]]
    assert not want[0].any()


def test_fold_kernel_with_several_warps_a_block(dev):
    """A launch whose blocks hold several warps (three references x 280
    random-parameter queries: the plan gives each block two warps, which
    share the reference's planes and take queries from one counter) equals
    the plain version in every placement."""
    from test_torch_engine_jax import fold_args

    from lzani_tpu_torch.ops import fold_stats as fs
    from lzani_tpu_torch.ops.parse import ParseCfg

    rng = np.random.RandomState(31)
    p = rand_params(rng)
    fam = small_family()
    qs = [mutate(rng, fam[k % 3], 0.05, n_ns=1, indels=2)[:300 + k]
          for k in range(280)]
    R, Q, E, N, D, NR = fold_args(fam[:3], qs, p)
    R = torch.nn.functional.pad(R, (0, -R.shape[1] % 128), value=4)
    Q = torch.nn.functional.pad(Q, (0, -Q.shape[1] % 128), value=5)
    warps = fs.launch_plan(3, 280, R.shape[1], Q.shape[1],
                           pk.sm_count(dev), fs.smem_limit(dev))[3]
    assert warps >= 2
    want = _fold_placements(dev, (R, Q, E, N, D, NR),
                            ParseCfg.from_params(p), "several warps")
    assert (want[1] == 0).all()
