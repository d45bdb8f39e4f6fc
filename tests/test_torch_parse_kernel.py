"""The event-log parse of the port, through its plain PyTorch version on
the CPU, equals the native oracle (``native_engine.parse_event_log``)
pair for pair and the JAX v7 kernel in interpret mode on a shared group.
The CUDA kernel itself is held against the plain version and the oracle
by tests/test_torch_cuda.py on a card. Event logs are integers: every
comparison is exact."""
import numpy as np
import pytest
import torch

from lzani_tpu.core import native_engine as ne
from lzani_tpu.ops.pallas_engine import PallasAll2All
from lzani_tpu.params import Params
from lzani_tpu_torch.ops import cuda_engine as tce
from lzani_tpu_torch.ops.parse_kernel import parse_events
from lzani_tpu_torch.synth import mutate, rand_params, small_family

CPU = torch.device("cpu")


def _group_logs(eng, r_list, device=CPU):
    """{(r, q): event log or None} for every real pair of one group."""
    gi = eng.build_group_index(r_list, device)
    out = {}
    n = len(eng.codes)
    for lo in range(0, eng.n_pad, eng.B):
        evs = eng.collect_group(eng.dispatch_group(gi, lo, device))
        for g, r in enumerate(r_list):
            for b in range(eng.B):
                q = lo + b
                if r >= 0 and q < n and q != r:
                    out[(r, q)] = evs[g][b]
    return out


@pytest.fixture(scope="module")
def family_logs():
    codes = small_family()
    eng = tce.CudaAll2All(codes, Params(), devices=[CPU])
    logs = {}
    for rl in ([0, 1, 2, 3], [4, 5, -1, -1]):
        logs.update(_group_logs(eng, rl))
    return codes, logs


@pytest.mark.parametrize("r,q", [(r, q) for r in range(6) for q in range(6)
                                 if r != q])
def test_family_pair_matches_oracle(family_logs, r, q):
    codes, logs = family_logs
    want = ne.parse_event_log(codes[r], codes[q], Params())
    assert logs[(r, q)] is not None
    assert np.array_equal(logs[(r, q)], want)


def test_group_matches_jax_v7_interpret():
    rng = np.random.RandomState(7)
    base = rng.randint(0, 4, 500).astype(np.uint8)
    codes = [base, mutate(rng, base, 0.06, n_ns=2, indels=1),
             mutate(rng, base[40:], 0.15, n_ns=0, indels=2),
             rng.randint(0, 4, 300).astype(np.uint8)]
    p = Params()
    r_list = [0, 1, 2, 3]
    v7 = PallasAll2All(codes, p, interpret=True, sim=True, ilv=2)
    gi = v7.build_group_index(r_list, v7.devices[0])
    jev = v7.collect_group(v7.dispatch_group(gi, 0, v7.devices[0]))
    mine = _group_logs(tce.CudaAll2All(codes, p, devices=[CPU]), r_list)
    for (r, q), ev in mine.items():
        oracle = ne.parse_event_log(codes[r], codes[q], p)
        assert ev is not None and np.array_equal(ev, oracle), (r, q)
        assert np.array_equal(ev, jev[r][q]), (r, q)


@pytest.mark.parametrize("trial", range(10))
def test_random_params_and_mutations(trial):
    rng = np.random.RandomState(100 + trial)
    L = int(rng.randint(250, 1500))
    if trial % 5 == 0:       # tandem repeats: arbitration and long LCEs
        unit = rng.randint(0, 4, rng.randint(20, 90)).astype(np.uint8)
        ref = np.tile(unit, L // len(unit) + 1)[:L]
    else:
        ref = rng.randint(0, 4, L).astype(np.uint8)
    rate = [0.0, 0.02, 0.08, 0.18, 0.35][trial % 5]
    q = mutate(rng, ref, rate, n_ns=trial % 4, indels=trial % 3)
    if trial % 5 == 2:       # unrelated middle: desync and next_hit jumps
        mid = rng.randint(0, 4, L // 3).astype(np.uint8)
        q = np.concatenate([q[:L // 3], mid, q[-L // 3:]])
    p = rand_params(rng) if trial % 2 else Params()
    codes = [ref, q]
    logs = _group_logs(tce.CudaAll2All(codes, p, devices=[CPU]), [0, 1])
    for (r, qq), ev in logs.items():
        assert ev is not None
        assert np.array_equal(ev, ne.parse_event_log(codes[r], codes[qq], p))


@pytest.mark.parametrize("aw,am", [(11, 5), (15, 7), (32, 9), (33, 9),
                                   (40, 12)])
def test_approx_window_matches_oracle(aw, am):
    """Extension windows below, at and above the 32 positions of one warp
    step (the kernel takes the misses leaving the window from the last
    64 positions' mask up to aw = 32, and re-reads them above)."""
    rng = np.random.RandomState(aw)
    base = rng.randint(0, 4, 1200).astype(np.uint8)
    codes = [base, mutate(rng, base, 0.08, n_ns=2, indels=2),
             mutate(rng, base, 0.2, n_ns=0, indels=1),
             rng.randint(0, 4, 500).astype(np.uint8)]
    p = Params()
    p.approx_window, p.approx_mismatches = aw, am
    logs = _group_logs(tce.CudaAll2All(codes, p, devices=[CPU]),
                       [0, 1, 2, 3])
    for (r, q), ev in logs.items():
        assert ev is not None
        assert np.array_equal(ev, ne.parse_event_log(codes[r], codes[q], p))


def test_query_bucket_above_2_18_matches_oracle():
    """Queries of ~260 kb (2^18 < LqP <= 2^19: the JAX engine's v3 group
    route) stay on the port's group path and match the oracle."""
    rng = np.random.RandomState(19)
    ref = rng.randint(0, 4, 261_200).astype(np.uint8)
    q = mutate(rng, ref, 0.01, n_ns=3, indels=10)
    q[100_000:101_500] = rng.randint(0, 4, 1500)    # an unrelated stretch
    codes, p = [ref, q], Params()
    eng = tce.CudaAll2All(codes, p, devices=[CPU])
    assert 1 << 18 < eng.LqP <= tce.CudaAll2All.MAX_Q
    for (r, qq), ev in _group_logs(eng, [0, 1]).items():
        assert ev is not None
        assert np.array_equal(ev, ne.parse_event_log(codes[r], codes[qq], p))


def _one_pair_inputs(ref, q, p):
    eng = tce.CudaAll2All([ref, q], p, devices=[CPU])
    gi = eng.build_group_index([0], CPU)
    qrows = (eng.Q[CPU][:eng.B], eng.DSZ[CPU][:eng.B])
    qbuf, cand, nh, ovf = tce.query_prep(*qrows, gi.ptab, eng.LqP,
                                         p.min_anchor_len, p.min_seed_len,
                                         eng.CNT_CAP)
    return eng, (gi.refbuf, qbuf, gi.poslist, cand, nh, gi.win,
                 qrows[1].contiguous(), gi.nrs, eng.cfg), ovf


def test_event_capacity_overflow():
    """A parse that needs more than ev_cap + 1 records ends with nev = -1
    (collect -> None, native fallback); with room it logs them all."""
    p = Params()
    rng = np.random.RandomState(33)
    ref = rng.randint(0, 4, 800).astype(np.uint8)
    q = np.concatenate([ref[j:j + 12] for j in rng.randint(0, 700, 40)])
    want = ne.parse_event_log(ref, q, p)
    n = len(want)
    assert n > 10
    eng, args, ovf = _one_pair_inputs(ref, q, p)
    ev, nev = parse_events(*args, ev_cap=n - 2)
    assert int(nev[0, 1]) == -1
    assert eng.collect_group((ev, nev, ovf))[0][1] is None
    ev, nev = parse_events(*args, ev_cap=n)
    assert int(nev[0, 1]) == n
    assert np.array_equal(ev[0, 1, :n].numpy(), want)
    eng.EV_CAP = n - 1          # the download gate: nev > EV_CAP -> None
    assert eng.collect_group((ev, nev, ovf))[0][1] is None


def test_anchor_bucket_over_cnt_cap_falls_back():
    """A query row with an anchor bucket over CNT_CAP (112) is flagged and
    collected as None, even though the kernel still ran it."""
    p = Params()
    rng = np.random.RandomState(5)
    unit = rng.randint(0, 4, 13).astype(np.uint8)
    ref = np.concatenate([rng.randint(0, 4, 300).astype(np.uint8),
                          np.tile(unit, 140)])
    q = mutate(rng, ref, 0.02, n_ns=0, indels=0)
    eng, args, ovf = _one_pair_inputs(ref, q, p)
    assert bool(ovf[0, 1])
    ev, nev = parse_events(*args, ev_cap=eng.EV_CAP)
    assert int(nev[0, 1]) >= 0
    assert eng.collect_group((ev, nev, ovf))[0][1] is None


def test_wrapper_rejects_bad_inputs():
    p = Params()
    rng = np.random.RandomState(1)
    ref = rng.randint(0, 4, 300).astype(np.uint8)
    _, args, _ = _one_pair_inputs(ref, ref.copy(), p)
    bad = list(args)
    bad[3] = args[3].to(torch.int64)          # cand dtype
    with pytest.raises(ValueError):
        parse_events(*bad, ev_cap=16)
    bad = list(args)
    bad[1] = args[1][:, ::2]                  # qbuf shape / contiguity
    with pytest.raises(ValueError):
        parse_events(*bad, ev_cap=16)
