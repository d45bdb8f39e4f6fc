"""The port's per-reference routes on the CPU (the kernel's plain
version): ``CudaRefIndex.parse_events_batch`` equals the JAX package's
``PallasRefIndex.parse_events_batch`` in interpret mode and the native
oracle, with the same None set, on the fixtures of
tests/test_pallas_kernel.py; ``CudaAll2All.dispatch_range`` / ``collect``
equal ``PallasAll2All``'s for every reference of a small set; and the
group path's logs equal the JAX v5 kernel's stream (``ilv = 2``,
``sim = 0``). Event logs are integers: every comparison is exact."""
import numpy as np
import pytest
import torch

from lzani_tpu.core import native_engine as ne
from lzani_tpu.ops.pallas_engine import PallasAll2All, PallasRefIndex
from lzani_tpu.params import Params
from lzani_tpu_torch.ops import cuda_engine as tce
from lzani_tpu_torch.synth import small_family

CPU = torch.device("cpu")


def _mixed_paths():
    """Close matches, kills and a desync: 12% substitutions and a spliced
    unrelated gap (test_kernel_matches_oracle_mixed_paths)."""
    rng = np.random.RandomState(3)
    ref = rng.randint(0, 4, 600).astype(np.uint8)
    q = ref.copy()
    m = rng.rand(600) < 0.12
    q[m] = (q[m] + rng.randint(1, 4, m.sum())) % 4
    q = np.concatenate([q[:200], rng.randint(0, 4, 150).astype(np.uint8),
                        q[350:]])
    return ref, [q], Params()


def _repeats():
    rng = np.random.RandomState(4)
    ref = np.tile(rng.randint(0, 4, 37).astype(np.uint8), 12)
    q = ref.copy()
    q[::41] = (q[::41] + 1) % 4
    return ref, [q[:400]], Params()


def _batch_and_fallback():
    """A batch of three: a prefix of the reference, an unrelated query,
    and a query through a 13-mer x 140 tandem block of the reference (an
    anchor bucket over CNT_CAP: None)."""
    rng = np.random.RandomState(5)
    unit = rng.randint(0, 4, 13).astype(np.uint8)
    ref = np.concatenate([rng.randint(0, 4, 500).astype(np.uint8),
                          np.tile(unit, 140)])
    qs = [ref[:450].copy(), rng.randint(0, 4, 300).astype(np.uint8),
          ref[400:].copy()]
    return ref, qs, Params()


def _nondefault_params():
    p = Params()
    (p.min_anchor_len, p.min_seed_len, p.max_dist_in_ref,
     p.max_dist_in_query, p.min_region_len, p.approx_window,
     p.approx_mismatches, p.approx_run_len) = (9, 5, 24, 30, 20, 11, 5, 2)
    rng = np.random.RandomState(13)
    ref = rng.randint(0, 4, 700).astype(np.uint8)
    q = ref.copy()
    m = rng.rand(700) < 0.08
    q[m] = (q[m] + rng.randint(1, 4, m.sum())) % 4
    return ref, [q[:650]], p


CASES = {"mixed_paths": _mixed_paths, "repeats": _repeats,
         "batch_and_fallback": _batch_and_fallback,
         "nondefault_params": _nondefault_params}


def _scattered_12mers():
    """A reference and a query of 40 scattered 12-mers of it (about 40
    events: over a small MAXEV), plus a prefix (a few events)."""
    rng = np.random.RandomState(33)
    ref = rng.randint(0, 4, 800).astype(np.uint8)
    q = np.concatenate([ref[j:j + 12] for j in rng.randint(0, 700, 40)])
    return ref, [q, ref[:500].copy()]


def _same(got, want):
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(got, want)):
        assert (a is None) == (b is None), k
        if a is not None:
            assert np.array_equal(a, b), k


@pytest.mark.parametrize("case", sorted(CASES))
def test_parse_events_batch_matches_jax_and_oracle(case):
    ref, qs, p = CASES[case]()
    mine = tce.CudaRefIndex(ref, p, device=CPU).parse_events_batch(qs)
    jax_ = PallasRefIndex(ref, p, interpret=True).parse_events_batch(qs)
    _same(mine, jax_)
    for q, ev in zip(qs, mine):
        if ev is not None:
            assert np.array_equal(ev, ne.parse_event_log(ref, q, p))
    assert (mine[-1] is None) == (case == "batch_and_fallback")


def test_parse_events_batch_event_overflow(monkeypatch):
    """With MAXEV = 32 the 40-event query falls back (None) in both
    packages and the short one does not."""
    ref, qs = _scattered_12mers()
    p = Params()
    monkeypatch.setattr(PallasRefIndex, "MAXEV", 32)
    monkeypatch.setattr(tce.CudaRefIndex, "MAXEV", 32)
    mine = tce.CudaRefIndex(ref, p, device=CPU).parse_events_batch(qs)
    _same(mine, PallasRefIndex(ref, p, interpret=True)
          .parse_events_batch(qs))
    assert mine[0] is None and len(ne.parse_event_log(ref, qs[0], p)) > 16
    assert np.array_equal(mine[1], ne.parse_event_log(ref, qs[1], p))


def test_parse_events_single_query_and_fallback_raises():
    ref, qs, p = _batch_and_fallback()
    idx = tce.CudaRefIndex(ref, p, device=CPU)
    assert np.array_equal(idx.parse_events(qs[0]),
                          ne.parse_event_log(ref, qs[0], p))
    with pytest.raises(RuntimeError):
        idx.parse_events(qs[2])


def _range_set():
    """Five genomes of the v5 fixture family and the scattered-12-mer
    pair's reference and query (a pair of about 40 events)."""
    ref, (q, _) = _scattered_12mers()
    return small_family()[:4] + [ref, q]


@pytest.fixture(scope="module")
def range_engines():
    codes = _range_set()
    p = Params()
    return (codes, p, PallasAll2All(codes, p, interpret=True),
            tce.CudaAll2All(codes, p, devices=[CPU]))


@pytest.mark.parametrize("r", range(6))
def test_dispatch_range_matches_jax_and_oracle(range_engines, r):
    codes, p, jeng, meng = range_engines
    n = len(codes)
    mine = meng.collect(meng.dispatch_range(r, 0))
    _same(mine[:n], jeng.collect(jeng.dispatch_range(r, 0))[:n])
    _same(meng.run_range(r, 0)[:n], mine[:n])
    for q in range(n):
        assert np.array_equal(mine[q],
                              ne.parse_event_log(codes[r], codes[q], p))


def test_batch_and_range_launch_equal_arguments():
    """One reference x the queries of an engine over the same genomes:
    ``CudaRefIndex.batch_args`` and ``dispatch_range``'s ``GroupRoute.args``
    give the kernel equal tensors (one prep path), and differ only in
    the event cap of each API."""
    codes = _range_set()
    p = Params()
    args_b, ovf = tce.CudaRefIndex(codes[2], p, device=CPU).batch_args(codes)
    eng = tce.CudaAll2All(codes, p, devices=[CPU])
    args_r, ovf_r = eng.routes["group"].args(eng.build_index(2, CPU), 0, CPU)
    assert eng.B == 8 and len(codes) == 6
    assert args_b[-2:] == (args_r[-2], tce.CudaRefIndex.MAXEV - 16)
    assert args_r[-1] == tce.CudaAll2All.EV_CAP
    n = len(codes)
    for x, y in zip(args_b[:-2], args_r[:-2]):
        if x.shape == y.shape:
            assert torch.equal(x, y)
        else:      # the engine pads its query block to B with no-op rows
            assert torch.equal(x, y[..., :n, :] if y.dim() == 3 else y[:n])
    assert torch.equal(ovf, ovf_r[:, :n])


def test_dispatch_range_event_overflow(monkeypatch):
    """EV_CAP = 8 in both packages: the same pairs fall back."""
    codes = _range_set()
    p = Params()
    monkeypatch.setattr(PallasAll2All, "EV_CAP", 8)
    monkeypatch.setattr(tce.CudaAll2All, "EV_CAP", 8)
    jeng = PallasAll2All(codes, p, interpret=True)
    meng = tce.CudaAll2All(codes, p, devices=[CPU])
    n = len(codes)
    mine = meng.run_range(4, 0)[:n]
    _same(mine, jeng.run_range(4, 0)[:n])
    assert mine[5] is None and mine[0] is not None


def test_group_path_matches_jax_v5_ilv2():
    """The v5 latency-interleaved kernel (pallas_v5.make_parse_kernel_ilv,
    selected by sim = 0 and ilv > 1) on tests/test_pallas_v5.py's family:
    its event streams equal the port's plain version's."""
    codes = small_family()
    p = Params()
    v5 = PallasAll2All(codes, p, interpret=True, ilv=2, sim=False)
    mine = tce.CudaAll2All(codes, p, devices=[CPU])
    checked = 0
    for r_list in ([0, 1, 2, 3], [4, 5, -1, -1]):
        jev = v5.collect_group(v5.dispatch_group(
            v5.build_group_index(r_list, v5.devices[0]), 0, v5.devices[0]))
        route = mine.routes["group"]
        mev = route.collect(route.dispatch(route.build(r_list, CPU), r_list,
                                           0, CPU))
        for g, r in enumerate(r_list):
            for q in range(len(codes)):
                if r < 0 or q == r:
                    continue
                assert mev[g][q] is not None and jev[g][q] is not None
                assert np.array_equal(mev[g][q], jev[g][q]), (r, q)
                checked += 1
    assert checked == 30
