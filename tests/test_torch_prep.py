"""The port's torch prep (on the CPU) equals the JAX package's: the numpy
reference prep ``PallasRefIndex._prep_query_np`` + ``build_anchor_join``
for cand / next_hit / the CNT_CAP overflow flag, the jnp ``dev_unpack3``
and ``dev_kmer_stream``, and the resident state of ``PallasAll2All`` /
``PallasGroupIndex`` (carried over by ``jax_state.state_from_jax``). The
query matrix laid out from packed items and the reference buffers
derived from its rows equal the layouts built from unpacked codes
(``prep.query_buffer_np`` / ``ref_buffer_np``), with no item unpacked.
All values are integers: every comparison is exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lzani_tpu.ops import pallas_engine as jpe
from lzani_tpu.ops.anchor_tables import build_anchor_join
from lzani_tpu.params import Params
from lzani_tpu_torch.io.packing import PackedCodes, pack_items
from lzani_tpu_torch.ops import cuda_engine as tce
from lzani_tpu_torch.ops.anchor_tables import win_words
from lzani_tpu_torch.ops.big import big_ref_join
from lzani_tpu_torch.ops.prep import (SYM_N_REF, SYM_N_SEQ, query_buffer_np,
                                      ref_buffer_np)
from lzani_tpu_torch.synth import mutate

from jax_state import state_from_jax

CPU = torch.device("cpu")


def _set(seed):
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 4, 1200).astype(np.uint8)
    codes = [mutate(rng, base, r, n_ns=k, indels=k % 3)
             for k, r in enumerate((0.0, 0.03, 0.1))]
    codes.append(rng.randint(0, 4, 700).astype(np.uint8))
    # tandem repeat: its 11-mers occur > CNT_CAP times in its composite
    unit = rng.randint(0, 4, 13).astype(np.uint8)
    codes.append(np.concatenate([base[:200], np.tile(unit, 130)]))
    return codes


@pytest.mark.parametrize("seed", [1, 2])
def test_query_prep_matches_numpy_reference(seed):
    codes = _set(seed)
    p = Params()
    eng = tce.CudaAll2All(codes, p, devices=[CPU])
    r_list = [0, 3, 4, -1]
    gi = eng.routes["group"].build(r_list, CPU)
    qrows = (eng.Q[CPU][:eng.B], eng.DSZ[CPU][:eng.B])
    qbuf, cand, nh, ovf = tce.query_prep(*qrows, gi.ptab, eng.LqP,
                                         p.min_anchor_len, p.min_seed_len,
                                         eng.CNT_CAP)
    n_ovf = 0
    for g, r in enumerate(r_list):
        if r < 0:
            continue
        ref = jpe.PallasRefIndex(codes[r], p, interpret=True)
        for b, q in enumerate(codes):
            want = ref._prep_query_np(q, eng.LqP)
            if want is None:            # row overflow -> native fallback
                assert bool(ovf[g, b])
                n_ovf += 1
                continue
            qb, cd, nx, dsz = want
            assert not bool(ovf[g, b])
            assert int(eng.DSZ[CPU][b]) == dsz
            assert np.array_equal(qbuf[b].numpy(), qb.astype(np.uint8))
            assert np.array_equal(cand[g, b].numpy(), cd)
            assert np.array_equal(nh[g, b].numpy(), nx)
    assert n_ovf > 0   # the tandem repeat trips CNT_CAP


def test_group_join_matches_anchor_join():
    codes = _set(3)
    p = Params()
    gi = tce.GroupIndex.of_codes(codes[:4], p, CPU)
    for g, c in enumerate(codes[:4]):
        rb = ref_buffer_np(c, p.max_dist_in_ref)
        start, count, pos_s = build_anchor_join(rb, p.min_anchor_len)
        ptab = np.where(count > 0, (start << 7) | np.minimum(count, 127), 0)
        assert np.array_equal(gi.ptab[g].numpy(), ptab)
        assert np.array_equal(gi.poslist[g, :len(pos_s)].numpy(), pos_s)
        assert np.array_equal(gi.refbuf[g, :len(rb)].numpy(), rb)


@pytest.mark.parametrize("k", [7, 11])
def test_dev_unpack3_and_kmer_stream_match_jax(k):
    rng = np.random.RandomState(k)
    codes = rng.randint(0, 6, (3, 900)).astype(np.uint8)
    packed = jpe.pack3_rows(codes)
    got = tce.dev_unpack3(torch.from_numpy(packed), 900)
    want = np.asarray(jpe.dev_unpack3(jnp.asarray(packed), 900))
    assert np.array_equal(got.numpy(), want)
    km = tce.dev_kmer_stream(got, k)
    want_km = np.asarray(jpe.dev_kmer_stream(jnp.asarray(want, jnp.int32), k))
    assert km.dtype == torch.int32
    assert np.array_equal(km.numpy(), want_km)


def test_state_from_jax_round_trip():
    codes = _set(4)
    p = Params()
    jeng = jpe.PallasAll2All(codes, p, interpret=True, ilv=1)
    teng = tce.CudaAll2All(codes, p, devices=[CPU])
    r_list = [1, 2, 0, -1]
    jg = jeng.build_group_index(r_list)
    tg = teng.routes["group"].build(r_list, CPU)
    st = state_from_jax(np.asarray(jeng.Q[None]), np.asarray(jeng.DSZ[None]),
                        np.asarray(jg.refbuf_p), np.asarray(jg.win),
                        np.asarray(jg.nrs), CPU)
    st["refbuf"] = tce.dev_unpack3(st.pop("refbuf_p"), tg.LrP).to(torch.uint8)
    mine = {"Q": teng.Q[CPU], "DSZ": teng.DSZ[CPU], "refbuf": tg.refbuf,
            "win": tg.win, "nrs": tg.nrs}
    for name, t in mine.items():
        assert st[name].dtype == t.dtype, name
        assert torch.equal(st[name], t), name
    assert (teng.B, teng.LqP, teng.n_pad) == (jeng.B, jeng.LqP, jeng.n_pad)
    assert (tg.LrP, tg.KaP, tg.WinP) == (jg.LrP, jg.KaP, jg.WinP)


# ---- the layouts built from unpacked codes ---------------------------------

def _pack3_rows(codes):
    """(R, L) codes -> (R, ceil(L/3)) radix-216 bytes, trailing slots 0."""
    R, L = codes.shape
    c = np.zeros((R, -(-L // 3) * 3), np.int32)
    c[:, :L] = codes
    c = c.reshape(R, -1, 3)
    return (c[:, :, 0] * 36 + c[:, :, 1] * 6 + c[:, :, 2]).astype(np.uint8)


def _query_matrix_unpacked(codes, mrd, LqP, n_pad):
    """The query matrix laid out from each item's unpacked codes:
    ``query_buffer_np`` rows filled with N_seq to LqP, packed, padded to
    128 bytes."""
    qb = np.full((n_pad, LqP), SYM_N_SEQ, np.uint8)
    for i, c in enumerate(codes):
        b = query_buffer_np(c, mrd)
        qb[i, :len(b)] = b
    qp = _pack3_rows(qb)
    out = np.zeros((n_pad, tce._pad128(qp.shape[1])), np.uint8)
    out[:, :qp.shape[1]] = qp
    return out


def _ref_buffers_unpacked(codes_list, mrd, LrP):
    """(G, LrP) ``ref_buffer_np`` buffers filled with N_ref."""
    return np.stack([ref_buffer_np(c, mrd, pad_to=LrP) for c in codes_list])


def _with_n_runs(rng, n):
    """ACGT codes with runs of N_ref (4) and N_seq (5), one at each end."""
    c = rng.randint(0, 4, n).astype(np.uint8)
    c[:3], c[-2:] = SYM_N_REF, SYM_N_SEQ
    for code in (SYM_N_REF, SYM_N_SEQ, SYM_N_REF, SYM_N_SEQ):
        s = rng.randint(0, n - 40)
        c[s:s + rng.randint(1, 40)] = code
    return c


@pytest.fixture
def no_unpack(monkeypatch):
    """Fail any unpack of a ``PackedCodes`` item."""
    def unpack(self, i):
        raise AssertionError(f"item {i} unpacked on the host")
    monkeypatch.setattr(PackedCodes, "_unpack", unpack)


@pytest.mark.parametrize("mrd", [0, 40])
@pytest.mark.parametrize("G", [1, 4, 6])
def test_dev_ref_buffers_equal_ref_buffer_np(G, mrd):
    """Lengths = 0, 1 and 2 mod 3, codes with runs of both N codes."""
    rng = np.random.RandomState(10 * G + mrd)
    codes = [_with_n_runs(rng, 700 + 334 * g) for g in range(G)]
    lens = np.array([len(c) for c in codes])
    LqP = tce._bucket(int(lens.max()) + mrd + 1024)
    rows = torch.from_numpy(tce.query_rows(codes, LqP, G))
    LrP = tce._bucket(int(2 * lens.max() + 3 * mrd) + 1024)
    got = tce.dev_ref_buffers(rows, lens, mrd, LrP)
    assert got.dtype == torch.uint8 and got.shape == (G, LrP)
    assert np.array_equal(got.numpy(), _ref_buffers_unpacked(codes, mrd, LrP))


@pytest.mark.parametrize("kind", ["packed", "list"])
@pytest.mark.parametrize("mrd", [0, 40])
def test_query_matrix_equals_the_unpacked_layout(kind, mrd, request):
    """``CudaAll2All``'s resident query matrix from ``PackedCodes`` items
    (none unpacked) or a plain list equals the layout of the unpacked
    codes; lengths = 0, 1 and 2 mod 3, one item with N_ref codes."""
    rng = np.random.RandomState(mrd + 3)
    codes = [_with_n_runs(rng, n) for n in (1201, 902, 650, 3000)]
    codes.append(rng.randint(0, 4, 811).astype(np.uint8))
    p = Params()
    p.max_dist_in_ref = mrd
    if kind == "packed":
        inp = pack_items(codes)
        request.getfixturevalue("no_unpack")
    else:
        inp = codes
    eng = tce.CudaAll2All(inp, p, devices=[CPU])
    want = _query_matrix_unpacked(codes, mrd, eng.LqP, eng.n_pad)
    assert eng.Q[CPU].dtype == torch.uint8
    assert np.array_equal(eng.Q[CPU].numpy(), want)
    assert np.array_equal(eng.DSZ[CPU][:len(codes)].numpy(),
                          [len(c) + mrd for c in codes])


@pytest.mark.parametrize("route,r_list", [
    ("group", [0, 3, 4, -1]), ("group", [-1, -1, -1, -1]),
    ("group", [2]), ("big", [0, 2, 4]), ("big", [1])])
def test_indexes_from_query_rows_equal_the_host_build(route, r_list,
                                                      no_unpack):
    """A route's index built from the query matrix's rows, no item
    unpacked: buffers, WIN words, lengths and join equal those built
    from the unpacked codes on the host (a dummy slot: 16 A codes); its
    copies from the host are the WIN words and the lengths alone."""
    rng = np.random.RandomState(len(r_list) + (route == "big"))
    codes = [_with_n_runs(rng, n) for n in (1500, 1201, 902, 2000, 650)]
    p = Params()
    if route == "big":
        p.min_anchor_len, p.min_seed_len = 20, 11
    cfg = tce.ParseCfg.from_params(p)
    eng = tce.CudaAll2All(pack_items(codes), p, devices=[CPU])
    if route == "big":
        eng.big_launch_shape(len(r_list), CPU)
    idx = eng.routes[route].build(r_list, CPU)
    refs = [codes[r] if r >= 0 else np.zeros(16, np.uint8) for r in r_list]
    bufs = _ref_buffers_unpacked(refs, cfg.mrd, idx.LrP)
    nrs = np.array([2 * len(c) + 3 * cfg.mrd for c in refs], np.int32)
    assert (idx.LrP, idx.KaP) == ((eng.LrP_ref, eng.KaP_ref) if route ==
                                  "group" else (eng.LrP_big, eng.KaP_big))
    assert np.array_equal(idx.refbuf.numpy(), bufs)
    assert np.array_equal(idx.nrs.numpy(), nrs)
    win = win_words(nrs, cfg.mal, cfg.msl, cfg.mrd, cfg.mqd)
    assert np.array_equal(idx.win.numpy(), win)
    host = torch.from_numpy(bufs)
    if route == "group":
        want = tce.group_join(host.to(torch.int32), cfg.mal, idx.KaP)
        got = (idx.ptab, idx.poslist)
    else:
        want = big_ref_join(host, cfg.mal, idx.KaP)
        got = (idx.keys, idx.poslist)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert idx.h2d_bytes == win.nbytes + nrs.nbytes


@pytest.mark.parametrize("path", ["group", "big"])
def test_index_h2d_bytes_counts_each_build(path, monkeypatch):
    """``all2all_cuda``'s ``index_h2d_bytes`` is the sum over its index
    builds of their WIN words and lengths."""
    codes = _set(5)
    p = Params()
    if path == "big":
        p.min_anchor_len, p.min_seed_len = 20, 11
    built = []
    for cls in (tce.GroupIndex, tce.BigIndex):
        def init(self, *a, _orig=cls.__init__, **kw):
            _orig(self, *a, **kw)
            built.append(self)
        monkeypatch.setattr(cls, "__init__", init)
    st = {}
    tce.all2all_cuda(codes, p, device=CPU, stats=st)
    kind = tce.GroupIndex if path == "group" else tce.BigIndex
    assert built and all(type(i) is kind for i in built)
    assert st["index_h2d_bytes"] == sum(i.win.nbytes + i.nrs.nbytes
                                        for i in built)
