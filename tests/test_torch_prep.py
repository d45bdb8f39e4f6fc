"""The port's torch prep (on the CPU) equals the JAX package's: the numpy
reference prep ``PallasRefIndex._prep_query_np`` + ``build_anchor_join``
for cand / next_hit / the CNT_CAP overflow flag, the jnp ``dev_unpack3``
and ``dev_kmer_stream``, and the resident state of ``PallasAll2All`` /
``PallasGroupIndex`` (carried over by ``jax_state.state_from_jax``). All
values are integers: every comparison is exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lzani_tpu.ops import pallas_engine as jpe
from lzani_tpu.ops.anchor_tables import build_anchor_join
from lzani_tpu.params import Params
from lzani_tpu_torch.ops import cuda_engine as tce
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
    gi = tce.GroupIndex(codes[:4], p, CPU)
    for g, c in enumerate(codes[:4]):
        rb = tce.ref_buffer_np(c, p.max_dist_in_ref)
        start, count, pos_s = build_anchor_join(rb, p.min_anchor_len)
        ptab = np.where(count > 0, (start << 7) | np.minimum(count, 127), 0)
        assert np.array_equal(gi.ptab[g].numpy(), ptab)
        assert np.array_equal(gi.poslist[g, :len(pos_s)].numpy(), pos_s)
        assert np.array_equal(gi.refbuf[g, :len(rb)].numpy(), rb)


@pytest.mark.parametrize("k", [7, 11])
def test_dev_unpack3_and_kmer_stream_match_jax(k):
    rng = np.random.RandomState(k)
    codes = rng.randint(0, 6, (3, 900)).astype(np.uint8)
    packed = tce.pack3_rows(codes)
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
    mine = {"Q": teng.Q[CPU], "DSZ": teng.DSZ[CPU], "refbuf_p": tg.refbuf_p,
            "win": tg.win, "nrs": tg.nrs}
    for name, t in mine.items():
        assert st[name].dtype == t.dtype, name
        assert torch.equal(st[name], t), name
    assert (teng.B, teng.LqP, teng.n_pad) == (jeng.B, jeng.LqP, jeng.n_pad)
    assert (tg.LrP, tg.KaP, tg.WinP) == (jg.LrP, jg.KaP, jg.WinP)
