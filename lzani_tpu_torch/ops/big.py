"""Device prep of the long-genome path (plain torch).

Counterpart of the long-genome prep of ``lzani_tpu/ops/pallas_engine.py``:
``dev_kmer_stream2`` (:1798-1821), the sorted two-word-key join of
``_get_big_ref_build`` (:1846-1868) and the query prep of
``_get_big_step`` (:1884-1912), whose ``_lower_bound2`` binary search
(:1824-1843) becomes ``torch.searchsorted``. A k-mer of up to 30 symbols
is one int64 key ``hi << 30 | lo``: both halves fit in 30 bits, so the
key's order is the (hi, lo) order of the JAX join, and equal keys mean
equal substrings (no hash collisions). The join is a stable sort of the
keys, so a key's positions stay ascending (the smallest-position
tie-break of the anchor search); windows with a non-ACGT code sort last.

Both preps take a unit's spans (``spans.UnitSpans``; ``OFF`` records
nothing) and record their stages' device time: ``dev.kmers`` (the k-mer
key streams), ``dev.sort`` (a reference's stable sort and position
list), ``dev.search`` (a reference's two searches and the start and
count planes) and ``dev.next_hit``.
"""

from __future__ import annotations

import torch

from .spans import OFF

#: key of a reference window that is not a k-mer (above every real key)
KEY_INVALID = 1 << 60


def dev_kmer_stream2(buf: torch.Tensor, k: int, n_sym: int = 4):
    """Two-word k-mer stream of (B, L) int32 codes for k <= 30: (hi, lo,
    ok) int32/int32/bool with hi = the first ceil(k/2) symbols, lo = the
    rest, ok = the window is all-ACGT and in bounds. The roll wraps
    around; the wrapped windows are masked by idx <= L - k."""
    B, L = buf.shape
    assert k <= 30, k
    a = k - k // 2
    hi = torch.zeros((B, L), dtype=torch.int32, device=buf.device)
    lo = torch.zeros_like(hi)
    ok = torch.ones((B, L), dtype=torch.bool, device=buf.device)
    for j in range(k):
        sh = torch.roll(buf, -j, dims=1)
        c = torch.where(sh < n_sym, sh, 0)
        if j < a:
            hi = (hi << 2) | c
        else:
            lo = (lo << 2) | c
        ok &= sh < n_sym
    ok &= (torch.arange(L, device=buf.device) <= L - k)[None]
    return hi, lo, ok


def kmer_keys(buf: torch.Tensor, k: int):
    """(keys, ok): int64 ``hi << 30 | lo`` per window of (B, L) int32
    codes, and whether the window is a k-mer. Keys of other windows are
    whatever their symbols give (the JAX query prep leaves them so too)."""
    hi, lo, ok = dev_kmer_stream2(buf, k)
    return (hi.to(torch.int64) << 30) | lo.to(torch.int64), ok


def big_ref_join(refbuf: torch.Tensor, mal: int, KaP: int, spans=OFF):
    """Sorted join of a (G, LrP) int32 stack of composite reference
    buffers: ``keys`` (G, LrP) int64 sorted ascending (KEY_INVALID last)
    and ``poslist`` (G, KaP) int32, the positions in the same order
    (zero past LrP). Built one reference at a time to bound memory."""
    G, LrP = refbuf.shape
    keys = torch.empty((G, LrP), dtype=torch.int64, device=refbuf.device)
    poslist = torch.zeros((G, KaP), dtype=torch.int32, device=refbuf.device)
    n = min(LrP, KaP)
    for g in range(G):
        with spans.stage("dev.kmers"):
            key, ok = kmer_keys(refbuf[g:g + 1], mal)
            key = torch.where(ok, key, KEY_INVALID)[0]
        with spans.stage("dev.sort"):
            keys[g], order = torch.sort(key, stable=True)
            poslist[g, :n] = order[:n].to(torch.int32)
    return keys, poslist


def big_query_prep(q: torch.Tensor, dsz: torch.Tensor, keys: torch.Tensor,
                   mal: int, msl: int, spans=OFF):
    """One long-genome dispatch's query-side prep against G references.

    q (B, LqP) int32 query codes, dsz (G, B) int32 per-pair query lengths
    (msl for a no-op pair), keys (G, LrP) int64 sorted ->
      cand     (G, B, 2, LqP) int32  start plane (lower bound of the
                                     query k-mer in the sorted keys) and
                                     count plane (0 where the window is
                                     not a k-mer); both 0 past dsz
      next_hit (G, B, LqP)    int32  next position >= i with candidates
                                     and i < dsz - msl, else dsz
    """
    G = keys.shape[0]
    B, LqP = q.shape
    dev = q.device
    with spans.stage("dev.kmers"):
        qkey, qok = kmer_keys(q, mal)
    idx = torch.arange(LqP, device=dev, dtype=torch.int32)
    cand = torch.empty((G, B, 2, LqP), dtype=torch.int32, device=dev)
    next_hit = torch.empty((G, B, LqP), dtype=torch.int32, device=dev)
    for g in range(G):
        ds = dsz[g].to(torch.int32)[:, None]
        with spans.stage("dev.search"):
            s_l = torch.searchsorted(keys[g], qkey, out_int32=True)
            s_r = torch.searchsorted(keys[g], qkey, right=True,
                                     out_int32=True)
            cnt = torch.where(qok, s_r - s_l, 0)
            mask = idx[None] < ds
            cand[g, :, 0] = torch.where(mask, s_l, 0)
            cand[g, :, 1] = torch.where(mask, cnt, 0)
        with spans.stage("dev.next_hit"):
            hit = (cnt > 0) & (idx[None] < ds - msl)
            nh_src = torch.where(hit, idx[None], ds)
            nh = torch.flip(torch.cummin(torch.flip(nh_src, [1]),
                                         dim=1).values, [1])
            next_hit[g] = torch.where(mask, nh, ds)
    return cand, next_hit
