"""The port's long-genome path on the CPU (the big kernel's plain
version): its prep equals the JAX package's (``dev_kmer_stream2``,
``_lower_bound2``, ``_get_big_ref_build`` run under JAX on the CPU), its
event logs equal the native oracle and one ``_get_big_step`` dispatch of
the JAX big kernel in interpret mode, ``all2all_cuda`` routes rows by the
JAX package's rule with triples and regions equal to the native engine's,
and state carried from a JAX big index gives the same logs. The CUDA
kernel itself is held against the plain version and the oracle by
tests/test_torch_cuda.py on a card. All values are integers: every
comparison is exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lzani_tpu.core import native_engine as ne
from lzani_tpu.ops import pallas_engine as jpe
from lzani_tpu.params import Params
from lzani_tpu_torch.ops import big as tbig
from lzani_tpu_torch.ops import cuda_engine as tce
from lzani_tpu_torch.ops.parse_kernel import parse_events_big
from lzani_tpu_torch.synth import mutate

CPU = torch.device("cpu")


def _params(mal, msl):
    p = Params()
    p.min_anchor_len, p.min_seed_len = mal, msl
    return p


def _tandem_set():
    """The fixture of the JAX package's test_all2all_pallas_big_path: a
    13-mer x 150 inside a 900 bp base (its k-mers have ~150 candidates,
    past the group path's 7-bit count pack), a 5% mutant, the base and an
    unrelated sequence."""
    rng = np.random.RandomState(11)
    unit = rng.randint(0, 4, 13).astype(np.uint8)
    rep = np.tile(unit, 150)
    base = rng.randint(0, 4, 900).astype(np.uint8)
    g1 = np.concatenate([base[:300], rep, base[300:]])
    q1 = g1.copy()
    m = rng.rand(len(q1)) < 0.05
    q1[m] = (q1[m] + rng.randint(1, 4, m.sum())) % 4
    return [g1, q1, base, rng.randint(0, 4, 700).astype(np.uint8)]


def _family(seed, length=1500):
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 4, length).astype(np.uint8)
    codes = [mutate(rng, base, r, n_ns=k, indels=k % 3)
             for k, r in enumerate((0.0, 0.02, 0.06, 0.15))]
    codes.append(rng.randint(0, 4, length // 2).astype(np.uint8))
    return codes


def _big_logs(eng, r_list):
    """{(r, q): log or None} of every pair of one long-genome group."""
    bidx = eng.build_big_index(r_list, CPU)
    out = {}
    for lo in range(0, eng.n_pad, eng.B_big):
        logs = eng.collect_big(eng.dispatch_big(bidx, r_list, lo, CPU))
        for g, r in enumerate(r_list):
            for b in range(eng.B_big):
                if lo + b < len(eng.codes):
                    out[(r, lo + b)] = logs[g][b]
    return out


def _regions(path):
    return sorted((r, q, tuple(map(tuple, regs)))
                  for r, q, regs in ne.read_region_dump(path))


@pytest.mark.parametrize("mal", [14, 20, 30])
def test_prep_matches_jax(mal):
    """kmer stream, reference join and candidate planes against the JAX
    functions on the same buffers."""
    codes = _family(3)
    codes.append(np.tile(np.arange(4, dtype=np.uint8), 200))
    p = _params(mal, 11)
    eng = tce.CudaAll2All(codes, p, devices=[CPU])
    assert eng.all_big and set(eng.paths) == {"big"}
    eng.big_launch_shape(len(codes), CPU)
    r_list = [0, 5]
    bidx = eng.build_big_index(r_list, CPU)
    q = tce.dev_unpack3(eng.Q[CPU][:eng.B_big], eng.LqP)
    hi, lo, ok = tbig.dev_kmer_stream2(q, mal)
    jhi, jlo, jok = jpe.dev_kmer_stream2(jnp.asarray(q.numpy()), mal)
    assert np.array_equal(hi.numpy(), np.asarray(jhi))
    assert np.array_equal(lo.numpy(), np.asarray(jlo))
    assert np.array_equal(ok.numpy(), np.asarray(jok))
    build = jpe._get_big_ref_build(eng.LrP_big, eng.KaP_big, mal)
    dsz = eng.DSZ[CPU][:eng.B_big][None].repeat(len(r_list), 1)
    cand, nh = tbig.big_query_prep(q, dsz, bidx.keys, mal, p.min_seed_len)
    for g in range(len(r_list)):
        jref, khi, klo, jpos = build(jnp.asarray(bidx.refbuf_p[g:g + 1]
                                                 .numpy()))
        assert np.array_equal(bidx.refbuf[g].numpy(), np.asarray(jref)[0])
        key = (np.asarray(khi, np.int64) << 30) | np.asarray(klo, np.int64)
        assert np.array_equal(bidx.keys[g].numpy(), key)
        assert np.array_equal(bidx.poslist[g].numpy(), np.asarray(jpos)[0])
        s_l = np.asarray(jpe._lower_bound2(khi, klo, jhi, jlo, right=False))
        s_r = np.asarray(jpe._lower_bound2(khi, klo, jhi, jlo, right=True))
        d = dsz[g].numpy()[:, None]
        idx = np.arange(eng.LqP)[None]
        cnt = np.where(np.asarray(jok), s_r - s_l, 0)
        assert np.array_equal(cand[g, :, 0].numpy(), np.where(idx < d, s_l, 0))
        assert np.array_equal(cand[g, :, 1].numpy(), np.where(idx < d, cnt, 0))
        hit = (cnt > 0) & (idx < d - p.min_seed_len)
        want_nh = np.minimum.accumulate(
            np.where(hit, idx, d)[:, ::-1], axis=1)[:, ::-1]
        assert np.array_equal(nh[g].numpy(), np.where(idx < d, want_nh, d))


@pytest.mark.parametrize("mal,msl", [(11, 7), (20, 11)])
def test_big_plain_matches_oracle_on_tandem_repeats(mal, msl, monkeypatch):
    """Pair for pair against ``native_engine.parse_event_log``: the JAX
    package's test_all2all_pallas_big_path pins its big kernel
    (interpret mode) to that same oracle on this fixture."""
    monkeypatch.setattr(tce.CudaAll2All, "MAX_REF_SYMS", 100)
    codes = _tandem_set()
    p = _params(mal, msl)
    eng = tce.CudaAll2All(codes, p, devices=[CPU])
    eng.big_launch_shape(len(codes), CPU)
    logs = _big_logs(eng, [0, 1, 2, 3])
    for (r, q), log in logs.items():
        if q == r:
            assert log is not None and len(log) == 0    # no-op self pair
        else:
            assert np.array_equal(log, ne.parse_event_log(codes[r], codes[q],
                                                          p)), (r, q)


def test_big_plain_matches_jax_big_step_interpret():
    """One ``_get_big_step`` dispatch of the JAX big kernel (interpret
    mode): the same logs, query for query."""
    codes = _tandem_set()
    p = _params(20, 11)
    jeng = jpe.PallasAll2All(codes, p, interpret=True)
    jlogs = jeng.collect_big(jeng.dispatch_big(jeng.build_big_index(1), 0))
    eng = tce.CudaAll2All(codes, p, devices=[CPU])
    assert (eng.LqP, eng.LrP_big, eng.KaP_big) == (jeng.LqP, jeng.LrP_big,
                                                   jeng.KaP_big)
    eng.big_launch_shape(1, CPU)
    logs = _big_logs(eng, [1])
    for q in range(len(codes)):
        assert np.array_equal(logs[(1, q)], jlogs[q]), q


@pytest.mark.parametrize("why", ["mal", "query_bucket"])
def test_all2all_all_big_runs_every_row_big(why, tmp_path, monkeypatch):
    """mal > 13, or a query bucket above MAX_Q (2^19; patched down to the
    test's bucket), sends every row to the long-genome path."""
    codes = _family(5)
    if why == "mal":
        p = _params(16, 9)
    else:
        p = Params()
        monkeypatch.setattr(tce.CudaAll2All, "MAX_Q", 2048)
    rp_n, rp_t = str(tmp_path / "n.regions"), str(tmp_path / "t.regions")
    want = ne.all2all(codes, p, region_path=rp_n)
    st = {}
    got = tce.all2all_cuda(codes, p, device=CPU, region_path=rp_t, stats=st)
    assert np.array_equal(got, want)
    assert _regions(rp_t) == _regions(rp_n)
    n = len(codes)
    assert st["big_rows"] == n and st["native_rows"] == 0
    assert st["kernel_pairs"] == 0 and st["launches"] == 0
    assert st["big_pairs"] == n * (n - 1) and st["replay_mismatches"] == 0


def test_all2all_group_and_big_rows_share_a_run(tmp_path, monkeypatch):
    """Composites above MAX_REF_SYMS go big, the rest stay on the group
    path; a sparse filter CSR keeps its layout."""
    codes = _family(6)
    p = Params()
    nrs = [2 * len(c) + 3 * p.max_dist_in_ref for c in codes]
    monkeypatch.setattr(tce.CudaAll2All, "MAX_REF_SYMS", sorted(nrs)[2])
    n_big = sum(v > sorted(nrs)[2] for v in nrs)
    assert 0 < n_big < len(codes)
    rows = [[1, 2, 4], [0, 3], [4], [1], [0, 2]]
    indptr = np.zeros(len(rows) + 1, np.int64)
    indptr[1:] = np.cumsum([len(r) for r in rows])
    csr = (indptr, np.array(sum(rows, []), np.int32))
    rp_n, rp_t = str(tmp_path / "n.regions"), str(tmp_path / "t.regions")
    want = ne.all2all(codes, p, filter_csr=csr, region_path=rp_n)
    st = {}
    got = tce.all2all_cuda(codes, p, filter_csr=csr, region_path=rp_t,
                           device=CPU, stats=st)
    assert np.array_equal(got, want)
    assert _regions(rp_t) == _regions(rp_n)
    assert st["big_rows"] == n_big and st["native_rows"] == 0
    assert st["kernel_pairs"] + st["big_pairs"] == len(csr[1])
    assert st["kernel_pairs"] > 0 and st["big_pairs"] > 0


def test_all2all_row_over_max_big_syms_runs_native(tmp_path, monkeypatch,
                                                   capsys):
    codes = _family(7)
    p = _params(15, 8)
    nrs = [2 * len(c) + 3 * p.max_dist_in_ref for c in codes]
    monkeypatch.setattr(tce.CudaAll2All, "MAX_BIG_SYMS", max(nrs) - 1)
    rp_n, rp_t = str(tmp_path / "n.regions"), str(tmp_path / "t.regions")
    want = ne.all2all(codes, p, region_path=rp_n)
    st = {}
    got = tce.all2all_cuda(codes, p, device=CPU, region_path=rp_t, stats=st)
    assert np.array_equal(got, want)
    assert _regions(rp_t) == _regions(rp_n)
    n_nat = sum(v > max(nrs) - 1 for v in nrs)
    assert st["native_rows"] == n_nat and st["big_rows"] == len(codes) - n_nat
    assert st["native_row_pairs"] == n_nat * (len(codes) - 1)
    assert "row runs on the native engine" in capsys.readouterr().err


def test_big_launch_shape_fits_the_budget(monkeypatch):
    codes = _family(8)
    eng = tce.CudaAll2All(codes, _params(20, 11), devices=[CPU])
    assert eng.big_launch_shape(5, CPU) == (5, eng.B)
    monkeypatch.setattr(tce.CudaAll2All, "CPU_BIG_BUDGET", 1)
    assert eng.big_launch_shape(5, CPU) == (1, 1)


def test_state_from_jax_big_index_gives_the_same_logs():
    codes = _tandem_set()
    p = _params(20, 11)
    jeng = jpe.PallasAll2All(codes, p, interpret=True)
    big = []
    for r in (0, 2):
        d = jeng.build_big_index(r)
        big.append(dict(refbuf=np.asarray(d["refbuf"]),
                        khi=np.asarray(d["khi"]), klo=np.asarray(d["klo"]),
                        pos=np.asarray(d["pos"]),
                        win=np.asarray(d["gidx"].win), nr=d["nr"]))
    jg = jeng.build_group_index([0])
    st = tce.state_from_jax(np.asarray(jeng.Q[None]),
                            np.asarray(jeng.DSZ[None]),
                            np.asarray(jg.refbuf_p), np.asarray(jg.win),
                            np.asarray(jg.nrs), CPU, big=big)
    eng = tce.CudaAll2All(codes, p, devices=[CPU])
    eng.big_launch_shape(2, CPU)
    mine = eng.build_big_index([0, 2], CPU)
    for name in ("refbuf", "keys", "poslist", "win", "nrs"):
        assert torch.equal(getattr(st["big"], name), getattr(mine, name)), name
    a = eng.collect_big(eng.dispatch_big(st["big"], [0, 2], 0, CPU))
    b = eng.collect_big(eng.dispatch_big(mine, [0, 2], 0, CPU))
    for g in range(2):
        for q in range(len(codes)):
            assert np.array_equal(a[g][q], b[g][q]), (g, q)


def test_big_wrapper_rejects_bad_inputs():
    """The group path's packed table or per-query lengths do not pass as
    a long-genome launch's inputs."""
    codes = _tandem_set()
    p = _params(20, 11)
    eng = tce.CudaAll2All(codes, p, devices=[CPU])
    eng.big_launch_shape(2, CPU)
    args = list(eng.big_args(eng.build_big_index([0, 1], CPU), [0, 1], 0,
                             CPU))
    parse_events_big(*args)
    for k, bad in ((3, args[3][:, :, 0].contiguous()),
                   (6, args[6][0].contiguous()),
                   (2, args[2].to(torch.int64))):
        wrong = list(args)
        wrong[k] = bad
        with pytest.raises(ValueError):
            parse_events_big(*wrong)
