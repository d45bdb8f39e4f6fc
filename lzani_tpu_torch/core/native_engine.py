"""ctypes bindings for the native host engine (``csrc/lzani_core.cpp``).

The port's own copy of ``lzani_tpu/core/native_engine.py``. The shared
library is compiled with g++ on first use into ``lzani_tpu_torch/_build/``
under a name keyed by the source and the flags (``ops/build.py``). The
native engine is the CPU backend (``--backend native``), the replay of
the CUDA kernels' event logs, and the bit-exact oracle they are held to.
"""

from __future__ import annotations

import ctypes as ct
import os
import threading

import numpy as np

from ..ops import build

_SRC = os.path.join(build.CSRC, "lzani_core.cpp")

_lock = threading.Lock()
_lib = None


class LzaCfg(ct.Structure):
    _fields_ = [(f, ct.c_int32) for f in
                ("mal", "msl", "mrd", "mqd", "reg", "aw", "am", "ar")]


def get_lib():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ct.CDLL(build.build_gxx("lzani_core", [_SRC]))

        lib.lza_abi_version.restype = ct.c_int32
        assert lib.lza_abi_version() == 6

        lib.lza_parse_pair.restype = ct.c_int64
        lib.lza_parse_pair.argtypes = [
            ct.POINTER(ct.c_uint8), ct.c_int64,
            ct.POINTER(ct.c_uint8), ct.c_int64,
            ct.POINTER(LzaCfg), ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_int32), ct.c_int64,
        ]
        lib.lza_parse_factors.restype = ct.c_int64
        lib.lza_parse_factors.argtypes = [
            ct.POINTER(ct.c_uint8), ct.c_int64,
            ct.POINTER(ct.c_uint8), ct.c_int64,
            ct.POINTER(LzaCfg), ct.POINTER(ct.c_int32), ct.c_int64,
        ]
        lib.lza_pseudo_finalize.restype = ct.c_int64
        lib.lza_pseudo_finalize.argtypes = [
            ct.POINTER(ct.c_uint8), ct.c_int64,
            ct.POINTER(ct.c_uint8), ct.c_int64,
            ct.POINTER(LzaCfg), ct.POINTER(ct.c_int32), ct.c_int64,
            ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32), ct.c_int64,
        ]
        lib.lza_expand_pseudo.restype = ct.c_int64
        lib.lza_expand_pseudo.argtypes = [
            ct.POINTER(ct.c_uint8), ct.c_int64,
            ct.POINTER(ct.c_uint8), ct.c_int64,
            ct.POINTER(LzaCfg), ct.POINTER(ct.c_int32), ct.c_int64,
            ct.POINTER(ct.c_int32), ct.c_int64,
        ]
        _pairsig = [ct.POINTER(ct.c_uint8), ct.c_int64,
                    ct.POINTER(ct.c_uint8), ct.c_int64, ct.POINTER(LzaCfg)]
        lib.lza_replay_finalize.restype = ct.c_int64
        lib.lza_replay_finalize.argtypes = _pairsig + [
            ct.POINTER(ct.c_int32), ct.c_int64, ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_int32), ct.c_int64]
        lib.lza_replay_factors.restype = ct.c_int64
        lib.lza_replay_factors.argtypes = _pairsig + [
            ct.POINTER(ct.c_int32), ct.c_int64, ct.POINTER(ct.c_int32),
            ct.c_int64]
        lib.lza_parse_event_log.restype = ct.c_int64
        lib.lza_parse_event_log.argtypes = _pairsig + [
            ct.POINTER(ct.c_int32), ct.c_int64]
        lib.lza_all2all.restype = ct.c_int32
        lib.lza_all2all.argtypes = [
            ct.POINTER(ct.c_uint8), ct.POINTER(ct.c_int64), ct.c_int64,
            ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int32),
            ct.POINTER(LzaCfg), ct.c_int32, ct.POINTER(ct.c_int32),
            ct.c_char_p, ct.c_int32, ct.c_double, ct.c_double, ct.c_double,
            ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int64),
        ]
        lib.lza_all2all_packed.restype = ct.c_int32
        lib.lza_all2all_packed.argtypes = [
            ct.POINTER(ct.c_uint64), ct.POINTER(ct.c_int64), ct.c_int64,
            ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int32),
            ct.POINTER(LzaCfg), ct.c_int32, ct.POINTER(ct.c_int32),
            ct.c_char_p, ct.c_int32, ct.c_double, ct.c_double, ct.c_double,
            ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int64),
        ]
        i32p, i64p = ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int64)
        lib.lza_replay_unit.restype = ct.c_int64
        lib.lza_replay_unit.argtypes = [
            ct.POINTER(ct.c_uint64), i64p, ct.c_int32, ct.POINTER(LzaCfg),
            ct.c_int64, i32p, i32p, i64p, i32p, i64p, i32p, ct.c_int64,
            i32p, i32p, ct.c_int32, ct.c_int32, ct.c_double, ct.c_double,
            ct.c_double, ct.c_int32, ct.POINTER(i32p), i64p,
        ]
        lib.lza_free.restype = None
        lib.lza_free.argtypes = [ct.c_void_p]
        lib.lza_claim_head.restype = ct.c_int64
        lib.lza_claim_head.argtypes = [ct.POINTER(ct.c_int64)]
        lib.lza_claim_tail.restype = ct.c_int64
        lib.lza_claim_tail.argtypes = [
            ct.POINTER(ct.c_int64), ct.c_int64, ct.POINTER(ct.c_int64)]
        lib.lza_format_results.restype = ct.c_int32
        lib.lza_format_results.argtypes = [
            ct.POINTER(ct.c_int32), ct.c_int64, ct.POINTER(ct.c_int64),
            ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int64), ct.c_char_p,
            ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int32), ct.c_int32,
            ct.c_int32, ct.c_int32, ct.c_double, ct.c_double, ct.c_double,
            ct.c_double, ct.c_double, ct.c_int32, ct.c_char_p, ct.c_char_p,
        ]
        lib.lza_parse_kmerdb.restype = ct.c_int64
        lib.lza_parse_kmerdb.argtypes = [
            ct.c_char_p, ct.c_int64, ct.c_double, ct.c_int64, ct.c_int32,
            ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int32), ct.c_int64,
        ]
        lib.lza_ingest_open.restype = ct.c_void_p
        lib.lza_ingest_open.argtypes = [ct.c_int32, ct.c_int64]
        lib.lza_ingest_feed.restype = ct.c_int64
        lib.lza_ingest_feed.argtypes = [ct.c_void_p, ct.c_void_p, ct.c_int64,
                                        ct.c_int32, i64p]
        lib.lza_ingest_take.restype = None
        lib.lza_ingest_take.argtypes = [ct.c_void_p, ct.c_void_p, i64p, i64p,
                                        ct.c_void_p, i64p]
        lib.lza_ingest_close.restype = None
        lib.lza_ingest_close.argtypes = [ct.c_void_p]
        _lib = lib
        return lib


def make_cfg(params) -> LzaCfg:
    return LzaCfg(
        params.min_anchor_len, params.min_seed_len,
        params.max_dist_in_ref, params.max_dist_in_query,
        params.min_region_len, params.approx_window,
        params.approx_mismatches, params.approx_run_len,
    )


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ct.POINTER(ct.c_uint8))


def parse_pair(ref: np.ndarray, query: np.ndarray, params,
               want_regions: bool = False):
    """Returns ((matches, literals, components), regions[None])."""
    lib = get_lib()
    cfg = make_cfg(params)
    stats = np.zeros(3, dtype=np.int32)
    if not want_regions:
        lib.lza_parse_pair(_u8p(ref), len(ref), _u8p(query), len(query),
                           ct.byref(cfg),
                           stats.ctypes.data_as(ct.POINTER(ct.c_int32)),
                           None, 0)
        return tuple(int(x) for x in stats), None
    cap = max(64, len(query) // max(params.min_region_len, 1) + 8)
    regs = np.zeros((cap, 6), dtype=np.int32)
    n = lib.lza_parse_pair(_u8p(ref), len(ref), _u8p(query), len(query),
                           ct.byref(cfg),
                           stats.ctypes.data_as(ct.POINTER(ct.c_int32)),
                           regs.ctypes.data_as(ct.POINTER(ct.c_int32)), cap)
    if n > cap:  # retry with exact capacity
        regs = np.zeros((n, 6), dtype=np.int32)
        lib.lza_parse_pair(_u8p(ref), len(ref), _u8p(query), len(query),
                           ct.byref(cfg),
                           stats.ctypes.data_as(ct.POINTER(ct.c_int32)),
                           regs.ctypes.data_as(ct.POINTER(ct.c_int32)), n)
    return tuple(int(x) for x in stats), regs[:n]


def parse_factors(ref: np.ndarray, query: np.ndarray, params) -> np.ndarray:
    """Raw factor list {dpos, kind(0=lit,1=close,2=distant), rpos, len}."""
    lib = get_lib()
    cfg = make_cfg(params)
    cap = len(query) + params.max_dist_in_ref + 16
    out = np.zeros((cap, 4), dtype=np.int32)
    n = lib.lza_parse_factors(_u8p(ref), len(ref), _u8p(query), len(query),
                              ct.byref(cfg),
                              out.ctypes.data_as(ct.POINTER(ct.c_int32)), cap)
    assert n <= cap, "factor buffer overflow"
    return out[:n]


def pseudo_finalize(ref: np.ndarray, query: np.ndarray, params,
                    pseudo: np.ndarray, want_regions: bool = False):
    """Expand a device pseudo-factor stream and compute stats (+regions).

    pseudo: int32 (n, 4) records {dpos, kind, rpos, len}; kinds 0/1/2 are
    real factors, 3/4 aligned ranges, 5/6 a gap pair (see lzani_core.cpp).
    """
    lib = get_lib()
    cfg = make_cfg(params)
    pseudo = np.ascontiguousarray(pseudo, dtype=np.int32)
    stats = np.zeros(3, dtype=np.int32)
    pf = pseudo.ctypes.data_as(ct.POINTER(ct.c_int32))
    if not want_regions:
        rc = lib.lza_pseudo_finalize(_u8p(ref), len(ref), _u8p(query),
                                     len(query), ct.byref(cfg), pf,
                                     len(pseudo),
                                     stats.ctypes.data_as(ct.POINTER(ct.c_int32)),
                                     None, 0)
        assert rc >= 0, "malformed pseudo-factor stream"
        return tuple(int(x) for x in stats), None
    cap = max(64, len(query) // max(params.min_region_len, 1) + 8)
    regs = np.zeros((cap, 6), dtype=np.int32)
    n = lib.lza_pseudo_finalize(_u8p(ref), len(ref), _u8p(query), len(query),
                                ct.byref(cfg), pf, len(pseudo),
                                stats.ctypes.data_as(ct.POINTER(ct.c_int32)),
                                regs.ctypes.data_as(ct.POINTER(ct.c_int32)),
                                cap)
    assert n >= 0, "malformed pseudo-factor stream"
    if n > cap:
        regs = np.zeros((n, 6), dtype=np.int32)
        lib.lza_pseudo_finalize(_u8p(ref), len(ref), _u8p(query), len(query),
                                ct.byref(cfg), pf, len(pseudo),
                                stats.ctypes.data_as(ct.POINTER(ct.c_int32)),
                                regs.ctypes.data_as(ct.POINTER(ct.c_int32)), n)
    return tuple(int(x) for x in stats), regs[:n]


def expand_pseudo(ref: np.ndarray, query: np.ndarray, params,
                  pseudo: np.ndarray) -> np.ndarray:
    """Expand a pseudo-factor stream to the real factor list (debug)."""
    lib = get_lib()
    cfg = make_cfg(params)
    pseudo = np.ascontiguousarray(pseudo, dtype=np.int32)
    cap = len(query) + params.max_dist_in_ref + 64
    out = np.zeros((cap, 4), dtype=np.int32)
    n = lib.lza_expand_pseudo(_u8p(ref), len(ref), _u8p(query), len(query),
                              ct.byref(cfg),
                              pseudo.ctypes.data_as(ct.POINTER(ct.c_int32)),
                              len(pseudo),
                              out.ctypes.data_as(ct.POINTER(ct.c_int32)), cap)
    assert 0 <= n <= cap
    return out[:n]


def parse_event_log(ref: np.ndarray, query: np.ndarray, params) -> np.ndarray:
    """Event log of the native parse: int32 (n, 8) records
    {i_ev, best_pos, best_len, bwd, ext, 0, 0, 0} — the decision stream the
    device kernel must reproduce."""
    lib = get_lib()
    cfg = make_cfg(params)
    cap = len(query) + 16
    out = np.zeros((cap, 8), dtype=np.int32)
    n = lib.lza_parse_event_log(_u8p(ref), len(ref), _u8p(query), len(query),
                                ct.byref(cfg),
                                out.ctypes.data_as(ct.POINTER(ct.c_int32)),
                                cap)
    assert 0 <= n <= cap
    return out[:n]


def replay_events(ref: np.ndarray, query: np.ndarray, params,
                  events: np.ndarray, want_regions: bool = False):
    """Replay a device event log into (stats, regions). Raises on an
    inconsistent log (bwd/ext cross-checked against reference scans)."""
    lib = get_lib()
    cfg = make_cfg(params)
    events = np.ascontiguousarray(events, dtype=np.int32)
    stats = np.zeros(3, dtype=np.int32)
    evp = events.ctypes.data_as(ct.POINTER(ct.c_int32))
    nev = len(events)
    if not want_regions:
        rc = lib.lza_replay_finalize(_u8p(ref), len(ref), _u8p(query),
                                     len(query), ct.byref(cfg), evp, nev,
                                     stats.ctypes.data_as(ct.POINTER(ct.c_int32)),
                                     None, 0)
        if rc < 0:
            raise ValueError("inconsistent event log")
        return tuple(int(x) for x in stats), None
    cap = max(64, len(query) // max(params.min_region_len, 1) + 8)
    regs = np.zeros((cap, 6), dtype=np.int32)
    n = lib.lza_replay_finalize(_u8p(ref), len(ref), _u8p(query), len(query),
                                ct.byref(cfg), evp, nev,
                                stats.ctypes.data_as(ct.POINTER(ct.c_int32)),
                                regs.ctypes.data_as(ct.POINTER(ct.c_int32)),
                                cap)
    if n < 0:
        raise ValueError("inconsistent event log")
    if n > cap:
        regs = np.zeros((n, 6), dtype=np.int32)
        lib.lza_replay_finalize(_u8p(ref), len(ref), _u8p(query), len(query),
                                ct.byref(cfg), evp, nev,
                                stats.ctypes.data_as(ct.POINTER(ct.c_int32)),
                                regs.ctypes.data_as(ct.POINTER(ct.c_int32)), n)
    return tuple(int(x) for x in stats), regs[:n]


class SeqTable:
    """The sequences as ``lza_replay_unit`` takes them: a pointer and a
    length each, packed (``PackedCodes``, zero-copy) or raw codes (kept
    alive here for the table's lifetime)."""

    def __init__(self, codes):
        from ..io.packing import PackedCodes

        if isinstance(codes, PackedCodes):
            self.packed, self._keep = 1, codes
            self.ptrs, self.slens = codes.ptrs, codes.slens
        else:
            self.packed = 0
            self._keep = [np.ascontiguousarray(c, np.uint8) for c in codes]
            self.ptrs = np.array([c.ctypes.data for c in self._keep],
                                 np.uint64)
            self.slens = np.array([len(c) for c in self._keep], np.int64)

    def __len__(self):
        return len(self.slens)


def replay_unit(seqs: SeqTable, cfg: LzaCfg, r, q, slot, nev, off,
                ev: np.ndarray, out: np.ndarray, want_regions: bool = False,
                flt: dict | None = None, threads: int = 1):
    """Replay a unit of event logs in one native call (``lza_replay_unit``,
    run without the interpreter lock): pair k is reference ``r[k]`` x
    query ``q[k]``, its triple goes to ``out[slot[k]]`` (`out` a C-ordered
    int32 (S, 3) array), its log is ``ev[off[k]:off[k] + nev[k]]`` of the
    (N, 8) int32 record block `ev`, or it is parsed natively when
    ``nev[k] < 0``. Pairs of one reference should be consecutive (its
    buffers are built once a run of them); the runs are spread over up
    to `threads` native threads. `flt` is the output filter (gani / ani
    / qcov) of the region records.

    Returns (status int32 per pair: 0 replayed, 1 parsed natively, -1 log
    rejected and its slot left as it was; the region records as int32
    words in ``read_region_dump``'s format, empty without regions)."""
    lib = get_lib()
    r = np.ascontiguousarray(r, np.int32)
    q = np.ascontiguousarray(q, np.int32)
    slot = np.ascontiguousarray(slot, np.int64)
    nev = np.ascontiguousarray(nev, np.int32)
    off = np.ascontiguousarray(off, np.int64)
    ev = np.ascontiguousarray(ev, np.int32).reshape(-1, 8)
    k = len(r)
    if not (len(q) == len(slot) == len(nev) == len(off) == k):
        raise ValueError("replay_unit: pair arrays of unequal length")
    if out.dtype != np.int32 or out.ndim != 2 or out.shape[1] != 3 or \
            not out.flags.c_contiguous:
        raise ValueError("replay_unit: out must be C-ordered int32 (S, 3)")
    n = len(seqs)
    has = nev >= 0
    if k and (r.min() < 0 or r.max() >= n or q.min() < 0 or q.max() >= n
              or slot.min() < 0 or slot.max() >= len(out)
              or (has & ((off < 0) | (off + nev > len(ev)))).any()):
        raise ValueError("replay_unit: a pair index, slot or log range is "
                         "out of bounds")
    status = np.zeros(k, np.int32)
    flt = flt or {}
    rec = ct.POINTER(ct.c_int32)()
    rec_len = ct.c_int64(0)
    ptr = lambda a, t: a.ctypes.data_as(ct.POINTER(t))
    rc = lib.lza_replay_unit(
        ptr(seqs.ptrs, ct.c_uint64), ptr(seqs.slens, ct.c_int64),
        seqs.packed, ct.byref(cfg), k, ptr(r, ct.c_int32),
        ptr(q, ct.c_int32), ptr(slot, ct.c_int64), ptr(nev, ct.c_int32),
        ptr(off, ct.c_int64), ptr(ev, ct.c_int32), len(ev),
        ptr(out, ct.c_int32), ptr(status, ct.c_int32),
        1 if want_regions else 0, 1 if flt else 0, flt.get("gani", 0.0),
        flt.get("ani", 0.0), flt.get("qcov", 0.0), max(1, int(threads)),
        ct.byref(rec), ct.byref(rec_len))
    words = np.zeros(0, np.int32)
    if rec:
        try:
            words = np.ctypeslib.as_array(rec, (rec_len.value,)).copy()
        finally:
            lib.lza_free(rec)
    if rc < 0:
        raise ValueError("replay_unit: malformed unit")
    return status, words


def replay_factors(ref: np.ndarray, query: np.ndarray, params,
                   events: np.ndarray) -> np.ndarray:
    """Replay a device event log to the raw factor list (validation aid)."""
    lib = get_lib()
    cfg = make_cfg(params)
    events = np.ascontiguousarray(events, dtype=np.int32)
    cap = len(query) + params.max_dist_in_ref + 64
    out = np.zeros((cap, 4), dtype=np.int32)
    n = lib.lza_replay_factors(_u8p(ref), len(ref), _u8p(query), len(query),
                               ct.byref(cfg),
                               events.ctypes.data_as(ct.POINTER(ct.c_int32)),
                               len(events),
                               out.ctypes.data_as(ct.POINTER(ct.c_int32)),
                               cap)
    if n < 0:
        raise ValueError("inconsistent event log")
    assert n <= cap
    return out[:n]


def all2all(codes: list[np.ndarray], params, filter_csr=None,
            region_path: str | None = None,
            progress: np.ndarray | None = None,
            ext_counter: np.ndarray | None = None,
            out: np.ndarray | None = None) -> np.ndarray:
    """Run the threaded all-vs-all engine.

    Returns int32 triples: dense mode shape (n, n-1, 3) where row r column c
    holds the parse of query (c if c<r else c+1) against reference r; filter
    mode shape (nnz, 3) aligned to the CSR ids array.

    ext_counter: optional int64[1] two-ended row queue packed as
    {tail:32|head:32} (init n << 32) — workers pop longest-first rows
    from the head while a co-running scheduler (ops/pallas_engine's
    hybrid mode) pops the short cheap rows from the tail. out: optional
    caller buffer to fill (hybrid mode shares one triples array across
    engines).
    """
    lib = get_lib()
    cfg = make_cfg(params)
    n = len(codes)
    from ..io.packing import PackedCodes
    packed = isinstance(codes, PackedCodes)
    if packed:
        # zero-copy: workers unpack per row/query inside lzani_core
        ptrs, slens = codes.ptrs, codes.slens
    else:
        offs = np.zeros(n + 1, dtype=np.int64)
        for i, c in enumerate(codes):
            offs[i + 1] = offs[i] + len(c)
        concat = np.concatenate(codes) if n else np.zeros(0, np.uint8)
        concat = np.ascontiguousarray(concat, dtype=np.uint8)

    if filter_csr is not None:
        indptr, ids = filter_csr
        indptr = np.ascontiguousarray(indptr, dtype=np.int64)
        ids = np.ascontiguousarray(ids, dtype=np.int32)
        if out is None:
            out = np.zeros((len(ids), 3), dtype=np.int32)
        ip = indptr.ctypes.data_as(ct.POINTER(ct.c_int64))
        idp = ids.ctypes.data_as(ct.POINTER(ct.c_int32))
    else:
        if out is None:
            out = np.zeros((n, max(n - 1, 0), 3), dtype=np.int32)
        ip = None
        idp = None

    flt = params.output_filter
    flt_enabled = 1 if flt else 0
    common = (
        ip, idp, ct.byref(cfg), int(params.no_threads),
        out.ctypes.data_as(ct.POINTER(ct.c_int32)),
        region_path.encode() if region_path else None,
        flt_enabled, flt.get("gani", 0.0), flt.get("ani", 0.0),
        flt.get("qcov", 0.0),
        progress.ctypes.data_as(ct.POINTER(ct.c_int64))
        if progress is not None else None,
        ext_counter.ctypes.data_as(ct.POINTER(ct.c_int64))
        if ext_counter is not None else None,
    )
    if packed:
        rc = lib.lza_all2all_packed(
            ptrs.ctypes.data_as(ct.POINTER(ct.c_uint64)),
            slens.ctypes.data_as(ct.POINTER(ct.c_int64)), n, *common)
    else:
        rc = lib.lza_all2all(
            _u8p(concat), offs.ctypes.data_as(ct.POINTER(ct.c_int64)), n,
            *common)
    if rc != 0:
        raise RuntimeError(f"lza_all2all failed with code {rc}")
    return out


def parse_kmerdb_csr(body: bytes, thr: float, n_rows: int,
                     n_threads: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Tokenize a kmer-db CSV body (everything after the header line) on
    the native thread pool and return the symmetrized CSR (indptr, ids)."""
    lib = get_lib()
    cap = 2 * body.count(b":") + 2
    indptr = np.zeros(n_rows + 1, np.int64)
    ids = np.zeros(cap, np.int32)
    nt = n_threads or (os.cpu_count() or 1)
    rc = lib.lza_parse_kmerdb(
        body, len(body), float(thr), n_rows, nt,
        indptr.ctypes.data_as(ct.POINTER(ct.c_int64)),
        ids.ctypes.data_as(ct.POINTER(ct.c_int32)), cap)
    if rc < 0:
        raise ValueError(f"Incorrect kmer-db filter file (code {rc})")
    return indptr, ids[:rc].copy()


class FastaIngest:
    """One file's pass from FASTA bytes to packed codes (``lza_ingest_*``,
    run without the interpreter lock): `feed` it the file's bytes chunk by
    chunk, ``final=True`` with the last (or an empty) chunk. In per-file
    mode (`per_file`) the whole file is one record, its contigs joined by
    `sep_len` symbols of code 5, and its name is left to the caller."""

    def __init__(self, per_file: bool = False, sep_len: int = 0):
        self._lib = get_lib()
        self._h = self._lib.lza_ingest_open(int(per_file), int(sep_len))
        if not self._h:
            raise MemoryError("lza_ingest_open")

    def feed(self, buf: np.ndarray, n: int, final: bool = False):
        """Parse ``buf[:n]``. Returns the records it finished as (names
        in bytes, latin-1, one str of them all; int64 name offsets, n + 1;
        their packed bytes, one uint8 array; int64 packed offsets, n + 1;
        int64 symbol counts), or None when it finished none."""
        if buf.dtype != np.uint8 or buf.ndim != 1 or \
                not buf.flags.c_contiguous or not 0 <= n <= len(buf):
            raise ValueError("FastaIngest.feed: a contiguous uint8 buffer "
                             "and 0 <= n <= its length")
        sizes = np.zeros(2, np.int64)
        i64p = ct.POINTER(ct.c_int64)
        k = self._lib.lza_ingest_feed(self._h, buf.ctypes.data, n,
                                      1 if final else 0,
                                      sizes.ctypes.data_as(i64p))
        if k < 0:
            raise MemoryError("lza_ingest_feed")
        if k == 0:
            return None
        packed = np.empty(sizes[0], np.uint8)
        names = np.empty(sizes[1], np.uint8)
        offs, name_offs = np.empty(k + 1, np.int64), np.empty(k + 1, np.int64)
        slens = np.empty(k, np.int64)
        self._lib.lza_ingest_take(
            self._h, packed.ctypes.data, offs.ctypes.data_as(i64p),
            slens.ctypes.data_as(i64p), names.ctypes.data,
            name_offs.ctypes.data_as(i64p))
        return names.tobytes().decode("latin-1"), name_offs, packed, offs, \
            slens

    def close(self) -> None:
        if self._h:
            self._lib.lza_ingest_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# Column ids — must match lzfmt::COL_* in lzani_core.cpp.
COLUMN_IDS = {
    "ridx": 0, "qidx": 1, "reference": 2, "query": 3, "qcov": 4, "rcov": 5,
    "gani": 6, "rlen": 7, "qlen": 8, "len_ratio": 9, "ani": 10,
    "num_alns": 11, "nt_mismatch": 12, "nt_match": 13, "tani": 14,
}


def format_results(out_path: str, params, store, triples: np.ndarray,
                   filter_csr=None) -> None:
    """Stream the results TSV via the threaded native formatter — the
    parallel ordered-output analog of the reference's store_results
    (lz_matcher.cpp:371-567). Byte-identical to output.results_tsv_lines
    (pinned by tests/test_native_format.py)."""
    lib = get_lib()
    n = len(store)
    comps = params.output_components
    comp_ids = np.array([COLUMN_IDS[c] for c in comps], np.int32)
    header = ("\t".join(comps) + "\n").encode("latin-1")
    mrd = params.max_dist_in_ref
    slens = getattr(store, "lengths", None)
    if slens is None:
        slens = [len(c) for c in store.codes]
    lens = np.array(
        [sl - (p - 1) * mrd
         for sl, p in zip(slens, store.no_parts)], np.int64)
    name_bytes = [nm.encode("latin-1") for nm in store.names]
    names_blob = b"".join(name_bytes)
    name_offs = np.zeros(n + 1, np.int64)
    np.cumsum([len(b) for b in name_bytes], out=name_offs[1:])

    if filter_csr is not None:
        indptr, ids = filter_csr
        indptr = np.ascontiguousarray(indptr, dtype=np.int64)
        ids = np.ascontiguousarray(ids, dtype=np.int32)
        ip = indptr.ctypes.data_as(ct.POINTER(ct.c_int64))
        idp = ids.ctypes.data_as(ct.POINTER(ct.c_int32))
    else:
        ip = None
        idp = None
    t = np.ascontiguousarray(triples, dtype=np.int32)

    flt = params.output_filter
    rc = lib.lza_format_results(
        t.ctypes.data_as(ct.POINTER(ct.c_int32)), n, ip, idp,
        lens.ctypes.data_as(ct.POINTER(ct.c_int64)), names_blob,
        name_offs.ctypes.data_as(ct.POINTER(ct.c_int64)),
        comp_ids.ctypes.data_as(ct.POINTER(ct.c_int32)), len(comps),
        1 if params.output_in_percent else 0, 1 if flt else 0,
        flt.get("gani", 0.0), flt.get("ani", 0.0), flt.get("tani", 0.0),
        flt.get("qcov", 0.0), flt.get("rcov", 0.0),
        int(params.no_threads), out_path.encode(), header)
    if rc != 0:
        raise RuntimeError(f"lza_format_results failed with code {rc}")


def read_region_dump(path: str):
    """Parse the binary region dump written by lza_all2all.

    Yields (ref_id, q_id, regions[int32 (k,6)]).
    """
    raw = np.fromfile(path, dtype=np.int32)
    pos = 0
    while pos < len(raw):
        r, q, k = int(raw[pos]), int(raw[pos + 1]), int(raw[pos + 2])
        pos += 3
        yield r, q, raw[pos:pos + 6 * k].reshape(k, 6)
        pos += 6 * k
