"""The work plan of the cuda engine (``ops/plan.py``, ``CudaAll2All.plan``)
on the CPU: every wanted pair lands in exactly one unit, at its output
slot and dispatch column; units come group by group, each group's in
query order; the hybrid cuts each group it claims into the units the
engine's plan gives that group; and ``all2all_cuda``'s integer counters
on a set that takes the group route, the long-genome route and the
native engine at once."""
import threading

import numpy as np
import pytest
import torch

from lzani_tpu_torch.core import native_engine as tne
from lzani_tpu_torch.ops import cuda_engine as tce
from lzani_tpu_torch.ops import hybrid as hyb
from lzani_tpu_torch.ops.finalize import row_wanted
from lzani_tpu_torch.ops.plan import Plan
from lzani_tpu_torch.params import Params
from lzani_tpu_torch.synth import mutate

CPU = torch.device("cpu")


def _mixed_set():
    """Eight relatives of one 1.5 kb base (0-15% substitutions, N runs,
    indels), two sequences sharing a tandem repeat (their pair has an
    anchor bucket over CNT_CAP) and an unrelated one, longest first."""
    rng = np.random.RandomState(21)
    base = rng.randint(0, 4, 1500).astype(np.uint8)
    codes = [mutate(rng, base, r, n_ns=k % 3, indels=k % 3) for k, r in
             enumerate((0.0, 0.02, 0.06, 0.15, 0.04, 0.08, 0.1, 0.03))]
    unit = rng.randint(0, 4, 7).astype(np.uint8)
    codes.append(np.concatenate([base[:200], np.tile(unit, 130)]))
    codes.append(np.concatenate([base[600:800], np.tile(unit, 120)]))
    codes.append(rng.randint(0, 4, 600).astype(np.uint8))
    codes.sort(key=len, reverse=True)
    return codes


def _filter(n, seed):
    """A sparse filter CSR: up to three partners a row."""
    rng = np.random.RandomState(seed)
    indptr, ids = np.zeros(n + 1, np.int64), []
    for r in range(n):
        ids.extend(sorted(set(int(q) for q in rng.choice(n, 3) if q != r)))
        indptr[r + 1] = len(ids)
    return indptr, np.array(ids, np.int32)


def _route_mixed(monkeypatch, codes, p):
    """Routing limits that send the mixed set's longest composite to the
    native engine, the next four to the long-genome route and the rest
    to the group route."""
    nrs = sorted(2 * len(c) + 3 * p.max_dist_in_ref for c in codes)
    monkeypatch.setattr(tce.CudaAll2All, "MAX_REF_SYMS", nrs[-6])
    monkeypatch.setattr(tce.CudaAll2All, "MAX_BIG_SYMS", nrs[-2])


def _case(name, monkeypatch):
    """(codes, params, filter CSR or None) of a planner case."""
    codes, p = _mixed_set(), Params()
    if name == "mixed":
        _route_mixed(monkeypatch, codes, p)
    return codes, p, (_filter(len(codes), 5) if name == "sparse" else None)


CASES = ["dense", "sparse", "mixed"]


@pytest.mark.parametrize("case", CASES)
def test_plan_puts_every_wanted_pair_in_one_unit(case, monkeypatch):
    codes, p, csr = _case(case, monkeypatch)
    n = len(codes)
    eng = tce.CudaAll2All(codes, p, devices=[CPU])
    pl = eng.plan(csr)
    if case == "mixed":
        assert {g.route for g in pl.groups} == {"group", "big"}
        assert [r for r, _ in pl.native] == [0]
    else:
        assert not pl.native and {g.route for g in pl.groups} == {"group"}
    seen = {}
    for u in pl.units:
        grp = pl.groups[u.group]
        width = eng.routes[grp.route].width
        assert (u.lo is None) == (case == "sparse" and grp.route == "group")
        for g, r, q, slot, b in zip(*(a.tolist() for a in u.pairs)):
            assert grp.r_list[g] == r and eng.paths[r] == grp.route
            assert (r, q) not in seen
            seen[(r, q)] = slot
            assert 0 <= b < width
            assert (u.qidx[b] if u.lo is None else u.lo + b) == q
    want = {}
    native = {r for r, _ in pl.native}
    for r in range(n):
        qs, slots = row_wanted(r, n, csr)
        if r not in native:
            want.update(zip(zip([r] * len(qs), qs.tolist()), slots.tolist()))
    assert seen == want
    assert pl.total_pairs == len(seen) + sum(len(w[0]) for _, w in pl.native)


@pytest.mark.parametrize("case", CASES)
def test_plan_orders_units_by_group_then_query(case, monkeypatch):
    codes, p, csr = _case(case, monkeypatch)
    eng = tce.CudaAll2All(codes, p, devices=[CPU])
    pl = eng.plan(csr)
    order = list(eng.routes)
    assert [order.index(g.route) for g in pl.groups] == sorted(
        order.index(g.route) for g in pl.groups)
    n = len(codes)
    for name in order:
        real = [r for g in pl.groups if g.route == name
                for r in g.r_list if r >= 0]
        assert real == [r for r, path in enumerate(eng.paths) if path == name
                        and len(row_wanted(r, n, csr)[0])]
    keys = [(u.group, u.lo if u.lo is not None else int(u.qidx[0]))
            for u in pl.units]
    assert keys == sorted(set(keys))
    assert sorted(set(u.group for u in pl.units)) == list(
        range(len(pl.groups)))
    for g in pl.groups:
        G = (eng.GROUP if g.route == "group" else eng.G_big)
        assert len(g.r_list) == G or (g.route == "big"
                                      and g is pl.groups[-1])


@pytest.mark.parametrize("case", CASES)
def test_hybrid_cuts_a_group_as_the_engine_plans_it(case, monkeypatch):
    """Each group the hybrid claims (greedy claims, the native pool held
    until the first one is dispatched) goes out as the units that the
    engine's plan of those rows gives, in the same order."""
    codes, p, csr = _case(case, monkeypatch)
    monkeypatch.setenv("LZANI_TPU_HYBRID_GREEDY", "1")
    dispatched = {}
    first = threading.Event()
    real = tce.GroupRoute.dispatch

    def spy(self, idx, r_list, lo, device=None, qidx=None, spans=tce.OFF):
        if max(r_list) >= 0:            # not the warm-up's dummy group
            dispatched.setdefault(tuple(r_list), []).append(
                (lo, None if qidx is None else qidx.tolist()))
            first.set()
        return real(self, idx, r_list, lo, device, qidx, spans)

    real_native = tne.all2all

    def held(codes, params, **kw):
        if kw.get("ext_counter") is not None:
            first.wait(60.0)
        return real_native(codes, params, **kw)

    monkeypatch.setattr(tce.GroupRoute, "dispatch", spy)
    monkeypatch.setattr(tne, "all2all", held)
    out = hyb.all2all_hybrid(codes, p, filter_csr=csr, device="cpu",
                             cpu_threads=1)
    assert np.array_equal(out, real_native(codes, p, filter_csr=csr))
    assert dispatched
    eng = tce.CudaAll2All(codes, p, devices=[CPU])
    route = eng.routes["group"]
    for r_list, got in dispatched.items():
        rows = [(r, row_wanted(r, len(codes), csr)) for r in r_list if r >= 0]
        pl = Plan({"group": rows}, 0, {"group": route.layout(
            len(rows), 1, csr is not None)}, eng.n_pad)
        assert [tuple(g.r_list) for g in pl.groups] == [r_list]
        assert got == [(u.lo, None if u.qidx is None else u.qidx.tolist())
                       for u in pl.units]


#: all2all_cuda's integer counters and dispatches ((route, references,
#: first query or None where gathered), in order) on the mixed set over
#: two entries, as the engine gave them before its routes shared one
#: interface (EV_CAP 3, a long-genome budget of 2 MiB: 2 references x 2
#: queries a launch), with a region file: every unit is replayed on the
#: host
COUNTERS = {
    "dense": dict(dispatches=14, launches=0, big_launches=0, kernel_pairs=47,
                  big_pairs=40, cap_fallbacks=13, big_cap_fallbacks=0,
                  native_rows=1, native_row_pairs=10, big_rows=4, G_big=2,
                  B_big=2, device_units=[7, 7], replay_pairs=110),
    "sparse": dict(dispatches=9, launches=0, big_launches=0, kernel_pairs=13,
                   big_pairs=12, cap_fallbacks=2, big_cap_fallbacks=0,
                   native_rows=1, native_row_pairs=2, big_rows=4, G_big=2,
                   B_big=2, device_units=[5, 4], replay_pairs=29),
}


DISPATCHES = {
    "dense": [("group", (5, 6, 7, 8), 0), ("group", (9, 10, -1, -1), 0)]
    + [("big", (1, 2), lo) for lo in (0, 2, 4, 6, 8, 10)]
    + [("big", (3, 4), lo) for lo in (0, 2, 4, 6, 8, 10)],
    "sparse": [("group", (5, 6, 7, 8), None), ("group", (9, 10, -1, -1), None)]
    + [("big", (1, 2), lo) for lo in (0, 4, 6, 8)]
    + [("big", (3, 4), lo) for lo in (0, 4, 6)],
}


@pytest.mark.parametrize("case", sorted(COUNTERS))
def test_all2all_cuda_counters_on_a_mixed_set(case, monkeypatch, tmp_path):
    codes, p = _mixed_set(), Params()
    _route_mixed(monkeypatch, codes, p)
    monkeypatch.setattr(tce.CudaAll2All, "EV_CAP", 3)
    monkeypatch.setattr(tce.CudaAll2All, "CPU_BIG_BUDGET", 1 << 21)
    csr = _filter(len(codes), 5) if case == "sparse" else None
    dispatched = []
    for name, cls in (("group", tce.GroupRoute), ("big", tce.BigRoute)):
        def spy(self, idx, r_list, lo, *a, _name=name, _real=cls.dispatch,
                **kw):
            dispatched.append((_name, tuple(r_list), lo))
            return _real(self, idx, r_list, lo, *a, **kw)
        monkeypatch.setattr(cls, "dispatch", spy)
    st = {}
    out = tce.all2all_cuda(codes, p, filter_csr=csr, devices=[CPU, CPU],
                           stats=st, region_path=str(tmp_path / "r.bin"))
    assert np.array_equal(out, tne.all2all(codes, p, filter_csr=csr))
    assert {k: st[k] for k in COUNTERS[case]} == COUNTERS[case]
    assert st["fold_pairs"] == 0
    assert st["big_fallback_pairs"] == [] and st["replay_mismatches"] == 0
    assert dispatched == DISPATCHES[case]
