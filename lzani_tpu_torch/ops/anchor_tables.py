"""Host-side exact tables for the device automaton.

A numpy copy of ``lzani_tpu/ops/anchor_tables.py``: that package's
``ops/__init__.py`` imports jax, so the port keeps its own copy
(tests/test_torch_host.py holds the two equal).

1. WIN table — the anchor-vs-seed arbitration (reference parser.cpp:604-623)
   without f64 on device. The reference compares
     pa = fpow(1 - 4^-al, uint32(2*(nr+1-al)))     (nr = composite buf len)
     pc = fpow(1 - 4^-sl, uint32(lit_run + mrd + 1 - sl))
   and takes the anchor iff pa > pc. In IEEE f64, 1 - 4^-l rounds to exactly
   1.0 for l >= 27, so pa (resp. pc) is exactly 1.0 there regardless of the
   exponent; all other reachable cases have al, sl <= 26 and lit_run <= mqd —
   a finite grid. We precompute WIN[al_c, sl_c, lr] with al_c = min(al, 27),
   sl_c = min(sl, 27) by replicating fpow bit-for-bit (same multiplication
   order, IEEE f64) vectorized in numpy. No monotonicity assumptions.
   Only pa depends on the reference: ``win_words`` (the port's own, not a
   copy) builds a group's packed words from pc computed once a run and pa
   for the group's lengths; ``build_win_table`` is its test oracle.

2. Anchor join tables — ht_long semantics (parser.cpp:146-189, 507-531)
   reduce to "ref positions sharing the query's 11-mer; longest equal_len
   wins; first-inserted (= smallest position) breaks ties; a winner at
   position 0 is discarded" (`if (a_pos)` sentinel, :604). We build a
   direct-address table over the 4^mal keyspace: start index + count into a
   position list sorted by (kmer, position).
"""

from __future__ import annotations

import functools

import numpy as np

CODE_N_REF = 4


def fpow_vec(base: np.ndarray, e: np.ndarray) -> np.ndarray:
    """Vectorized binary exponentiation, bit-identical to the reference's
    scalar loop (parser.h:174-188): ascending-bit multiplication order."""
    base = base.astype(np.float64).copy()
    e = e.astype(np.uint64).copy()
    r = np.ones_like(base)
    while e.any():
        bit = (e & 1) == 1
        r[bit] *= base[bit]
        base *= base
        e >>= 1
    return r


def prob_len_vec(length: np.ndarray) -> np.ndarray:
    """4^-len, exact (parser.h:134-172 table is exact powers of two)."""
    return np.ldexp(1.0, (-2 * length.astype(np.int64)).astype(np.int32))


SAT = 27  # 1 - 4^-l == 1.0 exactly in f64 for l >= 27


def build_win_table(nr: int, mal: int, msl: int, mrd: int, mqd: int
                    ) -> np.ndarray:
    """WIN[al_c - mal, sl_c - msl, lr] (int32 0/1): anchor beats seed.

    al_c in [mal, SAT] (SAT bucket = "al >= SAT"), sl_c in [msl, SAT],
    lr in [0, mqd]. Exact for every reachable (al, sl, lr):
    al >= mal >= 1, sl >= msl >= 1 and values > SAT have pa/pc == 1.0
    exactly, matching the bucket entry.
    """
    als = np.arange(mal, SAT + 1)
    sls = np.arange(msl, SAT + 1)
    lrs = np.arange(0, mqd + 1)
    A, S, L = np.meshgrid(als, sls, lrs, indexing="ij")

    pa_base = 1.0 - prob_len_vec(A)
    pa_e = (2 * (nr + 1 - A)).astype(np.int64).astype(np.uint32)
    pa = fpow_vec(pa_base, pa_e)

    pc_base = 1.0 - prob_len_vec(S)
    pc_e = (L + mrd + 1 - S).astype(np.int64).astype(np.uint32)
    pc = fpow_vec(pc_base, pc_e)

    return (pa > pc).astype(np.int32)


@functools.lru_cache(maxsize=8)
def seed_half(msl: int, mrd: int, mqd: int) -> np.ndarray:
    """pc[sl_c - msl, lr] of ``build_win_table``: (SAT - msl + 1, mqd + 1)
    f64, fixed for a run; computed once per (msl, mrd, mqd) and shared
    read-only."""
    S, L = np.meshgrid(np.arange(msl, SAT + 1), np.arange(0, mqd + 1),
                       indexing="ij")
    pc = fpow_vec(1.0 - prob_len_vec(S),
                  (L + mrd + 1 - S).astype(np.int64).astype(np.uint32))
    pc.flags.writeable = False
    return pc


def win_words(nrs, mal: int, msl: int, mrd: int, mqd: int,
              pad_words: int = 128) -> np.ndarray:
    """(G, W) int32 WIN bit-words of the composite lengths `nrs`: row g
    equals ``pack_bits_i32(build_win_table(nrs[g], ...).reshape(-1),
    pad_words)`` bit for bit (little-endian within a word, W padded to a
    multiple of `pad_words`). The table factors as pa(al, nr) > pc(sl, lr):
    the seed half comes from ``seed_half``, the anchor half is computed
    for the G lengths at once, with the same elementwise ``fpow_vec``."""
    nr = np.asarray(nrs, np.int64).reshape(-1, 1)
    als = np.arange(mal, SAT + 1)          # empty where mal > SAT
    A = np.broadcast_to(als, (len(nr), len(als)))
    pa = fpow_vec(1.0 - prob_len_vec(A), (2 * (nr + 1 - A)).astype(np.uint32))
    bits = (pa[:, :, None, None] > seed_half(msl, mrd, mqd)).reshape(
        len(nr), -1)
    n = bits.shape[1]
    W = -(-max(-(-n // 32), 1) // pad_words) * pad_words
    packed = np.zeros((len(nr), W * 4), np.uint8)
    packed[:, :-(-n // 8)] = np.packbits(bits, axis=1, bitorder="little")
    return packed.view("<i4").astype(np.int32)


def win_lookup(win: np.ndarray, al: int, sl: int, lr: int,
               mal: int, msl: int) -> bool:
    """Reference helper (host-side oracle / tests)."""
    return bool(win[min(al, SAT) - mal, min(sl, SAT) - msl, lr])


def kmer_stream_np(buf: np.ndarray, k: int) -> np.ndarray:
    """int64 k-mer per position, -1 where the window has any N code or runs
    off the end (parser.cpp:53-103)."""
    n = len(buf)
    out = np.full(n, -1, np.int64)
    if n < k:
        return out
    b = buf.astype(np.int64)
    valid = buf < CODE_N_REF
    val = np.zeros(n - k + 1, np.int64)
    ok = np.ones(n - k + 1, bool)
    for j in range(k):
        val = (val << 2) | b[j:j + n - k + 1]
        ok &= valid[j:j + n - k + 1]
    out[:n - k + 1] = np.where(ok, val, -1)
    return out


def build_anchor_join(refbuf: np.ndarray, mal: int):
    """Direct-address anchor join for one composite reference buffer.

    Returns (start, count, pos_sorted):
      start, count: int32[4^mal]; pos_sorted: int32[K] positions ascending
      within each kmer bucket (ties in ht_long resolve to the smallest
      position — SURVEY.md hard-part 3).
    """
    km = kmer_stream_np(refbuf, mal)
    valid = km >= 0
    keys = km[valid]
    pos = np.nonzero(valid)[0].astype(np.int32)
    order = np.lexsort((pos, keys))
    keys_s = keys[order].astype(np.int64)
    pos_s = pos[order]
    nk = 1 << (2 * mal)
    count = np.bincount(keys_s, minlength=nk).astype(np.int32)
    start = np.zeros(nk, np.int32)
    np.cumsum(count[:-1], out=start[1:])
    return start, count, pos_s
