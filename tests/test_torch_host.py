"""The port's re-homed host helpers equal the lzani_tpu originals bit for
bit (numpy inputs from fixed seeds)."""
import numpy as np
import pytest

from lzani_tpu.ops import anchor_tables as jat
from lzani_tpu.ops import pallas_engine as jpe
from lzani_tpu.ops import parse as jparse
from lzani_tpu.ops import prep as jprep
from lzani_tpu.params import Params
from lzani_tpu_torch.ops import anchor_tables as tat
from lzani_tpu_torch.ops import cuda_engine as tce
from lzani_tpu_torch.ops import parse as tparse
from lzani_tpu_torch.ops import prep as tprep


def _codes(seed, n, n_frac=0.02):
    rng = np.random.RandomState(seed)
    c = rng.randint(0, 4, n).astype(np.uint8)
    c[rng.rand(n) < n_frac] = 5
    return c


@pytest.mark.parametrize("nr,mal,msl,mrd,mqd", [
    (1200, 11, 7, 40, 40), (131_000, 11, 7, 40, 40), (700_000, 11, 7, 40, 40),
    (5000, 13, 9, 8, 63), (300, 5, 4, 63, 8)])
def test_win_table(nr, mal, msl, mrd, mqd):
    a = tat.build_win_table(nr, mal, msl, mrd, mqd)
    b = jat.build_win_table(nr, mal, msl, mrd, mqd)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    bits = a.reshape(-1)
    assert np.array_equal(tce.pack_bits_i32(bits, 128),
                          jpe.pack_bits_i32(bits, 128))


DUMMY_NR = 2 * 16 + 3 * 40     # the 16-symbol dummy slot's composite at mrd 40


@pytest.mark.parametrize("nrs,mal,msl,mrd,mqd", [
    ((1200,), 11, 7, 40, 40), ((131_000,), 11, 7, 40, 40),
    ((700_000,), 11, 7, 40, 40), ((5000,), 13, 9, 8, 63),
    ((300,), 5, 4, 63, 8), ((1200, 40_000), 27, 27, 40, 0),
    ((1200, 40_000), 30, 7, 40, 40),
    ((DUMMY_NR, 80_000, DUMMY_NR, DUMMY_NR), 11, 7, 40, 40),
    ((20, 116_000, 47_000, 700_000, 5000), 11, 7, 40, 40),
    ((2**25 - 1000, 2**25 + 64), 11, 7, 40, 40)])
def test_win_words_equal_the_per_reference_tables(nrs, mal, msl, mrd, mqd):
    """The factored words equal each reference's packed table, the port's
    and the JAX package's, row for row."""
    assert tprep.ref_buffer_np(np.zeros(16, np.uint8), 40).size == DUMMY_NR
    w = tat.win_words(np.array(nrs, np.int32), mal, msl, mrd, mqd)
    assert w.dtype == np.int32 and w.shape[0] == len(nrs)
    for g, nr in enumerate(nrs):
        bits = tat.build_win_table(nr, mal, msl, mrd, mqd).reshape(-1)
        assert np.array_equal(w[g:g + 1], tce.pack_bits_i32(bits, 128))
        jbits = jat.build_win_table(nr, mal, msl, mrd, mqd).reshape(-1)
        assert np.array_equal(w[g:g + 1], jpe.pack_bits_i32(jbits, 128))


@pytest.mark.parametrize("k", [4, 7, 11])
def test_kmer_stream_and_anchor_join(k):
    buf = tprep.ref_buffer_np(_codes(k, 3000), 40)
    assert np.array_equal(tat.kmer_stream_np(buf, k), jat.kmer_stream_np(buf, k))
    for x, y in zip(tat.build_anchor_join(buf, k),
                    jat.build_anchor_join(buf, k)):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_fpow_and_prob():
    rng = np.random.RandomState(4)
    base = 1.0 - tat.prob_len_vec(rng.randint(1, 30, 200))
    e = rng.randint(0, 2**31, 200)
    assert np.array_equal(tat.fpow_vec(base, e), jat.fpow_vec(base, e))
    assert tat.SAT == jat.SAT


@pytest.mark.parametrize("mrd,pad", [(40, None), (7, 5000)])
def test_buffers(mrd, pad):
    c = _codes(mrd, 2500)
    c[::97] = 4
    assert np.array_equal(tprep.ref_buffer_np(c, mrd),
                          jprep.ref_buffer_np(c, mrd))
    assert np.array_equal(tprep.query_buffer_np(c, mrd, pad),
                          jprep.query_buffer_np(c, mrd, pad))
    assert (tprep.SYM_N_REF, tprep.SYM_N_SEQ) == (jprep.SYM_N_REF,
                                                  jprep.SYM_N_SEQ)


@pytest.mark.parametrize("rows,cols", [(1, 1), (3, 1000), (5, 4097)])
def test_pack3_rows(rows, cols):
    """The query matrix laid out from packed items (``query_rows``, its
    rows past the items' N_seq padding) equals the JAX package's
    ``pack3_rows`` of the query buffers, padded to 128 bytes."""
    rng = np.random.RandomState(rows)
    codes = [rng.randint(0, 6, cols - k).astype(np.uint8)
             for k in range(min(rows, cols))]
    n_pad, mrd = rows + 2, 40
    LqP = tce._bucket(cols + mrd + 1024)
    qb = np.full((n_pad, LqP), tprep.SYM_N_SEQ, np.uint8)
    for i, c in enumerate(codes):
        qb[i, :len(c) + mrd] = jprep.query_buffer_np(c, mrd)
    want = jpe.pack3_rows(qb)
    got = tce.query_rows(codes, LqP, n_pad)
    assert got.shape == (n_pad, tce._pad128(want.shape[1]))
    assert np.array_equal(got[:, :want.shape[1]], want)
    assert not got[:, want.shape[1]:].any()


@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097, 700_000])
def test_buckets(n):
    assert tce._bucket(n) == jpe._bucket(n)
    assert tce._bucket(n, lo=1024) == jpe._bucket(n, lo=1024)
    assert tce._pad128(n) == jpe._pad128(n)


def test_parse_cfg():
    p = Params()
    assert tparse.ParseCfg.from_params(p).__dict__ == \
        jparse.ParseCfg.from_params(p).__dict__
    p.min_anchor_len, p.min_seed_len, p.approx_window = 13, 9, 21
    assert tparse.ParseCfg.from_params(p).__dict__ == \
        jparse.ParseCfg.from_params(p).__dict__
