"""Replay of kernel event logs through the native emission machinery,
or a native parse of a pair that has no log.

``UnitReplay`` is the device path's: one native call
(``native_engine.replay_unit``) replays a whole downloaded unit without
the interpreter lock, so a pool of threads replays units in parallel.
``Finalizer`` is the same work pair by pair, the plain version the tests
hold it against.

Both are counterparts of ``_make_finalize`` (``lzani_tpu/ops/hybrid.py``),
with one difference: a log that the replay rejects (a bwd/ext cross-check failure,
``ValueError``) is recorded as a replay mismatch instead of being
swallowed, and the pair is not repaired. Such a log means the kernel
computed a wrong stream; ``all2all_cuda`` fails the run when any pair
mismatched. Only a pair without a log (a capacity fallback) is parsed
natively here.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from ..core import native_engine


class Finalizer:
    """Thread-safe ``finalize(r, q, ev, slot)``: writes the pair's stats
    into ``out[slot]`` and, when ``rf`` is an open file, appends its
    region record (with the output pre-filter, lz_matcher.cpp:115-138)."""

    def __init__(self, codes, params, out, rf=None):
        self.codes = codes
        self.params = params
        self.out = out
        self.rf = rf
        self._lock = threading.Lock()
        flt = params.output_filter
        self._flt = flt
        self._f_gani = flt.get("gani", 0.0)
        self._f_ani = flt.get("ani", 0.0)
        self._f_qcov = flt.get("qcov", 0.0)
        #: (r, q) of the logs the replay rejected; their slots stay unset
        self.mismatched: list[tuple[int, int]] = []

    @property
    def replay_mismatches(self) -> int:
        return len(self.mismatched)

    def __call__(self, r, q, ev, slot):
        codes, params = self.codes, self.params
        want = self.rf is not None
        if ev is None:
            stats, regs = native_engine.parse_pair(
                codes[r], codes[q], params, want_regions=want)
        else:
            try:
                stats, regs = native_engine.replay_events(
                    codes[r], codes[q], params, ev, want_regions=want)
            except ValueError:
                with self._lock:
                    self.mismatched.append((r, q))
                return
        self.out[slot] = stats
        if want:
            self._write_regions(r, q, regs)

    def _write_regions(self, r, q, regs):
        m = int(regs[:, 4].sum()) if len(regs) else 0
        lit = int(regs[:, 5].sum()) if len(regs) else 0
        q_len = len(self.codes[q])
        gani = m / q_len
        ani = m / (m + lit) if (m + lit) else 0.0
        qcov = (m + lit) / q_len
        if not self._flt or (gani >= self._f_gani and ani >= self._f_ani
                             and qcov >= self._f_qcov):
            rec = np.concatenate(
                [np.array([r, q, len(regs)], np.int32),
                 np.asarray(regs, np.int32).reshape(-1)])
            with self._lock:
                rec.tofile(self.rf)


#: the wanted (queries, output slots) of a row without pairs
NO_PAIRS = (np.zeros(0, np.int32), np.zeros(0, np.int64))


def unit_pairs(r_list, wanteds, pick):
    """A unit's pairs as arrays (g, r, q, slot, b), those of one reference
    consecutive: for each reference ``r_list[g]`` with its wanted
    (queries, output slots) ``wanteds[g]``, the queries that ``pick(qs)
    -> (mask, b)`` keeps, at column b of the dispatch."""
    parts = []
    for g, (r, (qs, slots)) in enumerate(zip(r_list, wanteds)):
        m, b = pick(qs)
        k = int(m.sum())
        parts.append((np.full(k, g, np.int64), np.full(k, r, np.int32),
                      qs[m], slots[m], np.asarray(b, np.int64)[m]))
    return tuple(np.concatenate(x) for x in zip(*parts))


def row_wanted(r, n, filter_csr=None):
    """(queries int32, output slots int64) of reference row r: the slots
    index the triples as rows of the (n * (n - 1), 3) dense layout, or
    of the (nnz, 3) filter layout."""
    if filter_csr is None:
        qs = np.concatenate([np.arange(r, dtype=np.int32),
                             np.arange(r + 1, n, dtype=np.int32)])
        return qs, r * (n - 1) + np.arange(n - 1, dtype=np.int64)
    indptr, ids = filter_csr
    lo, hi = int(indptr[r]), int(indptr[r + 1])
    return (np.asarray(ids[lo:hi], np.int32),
            np.arange(lo, hi, dtype=np.int64))


class UnitReplay:
    """Thread-safe call ``(r, q, slot, nev, off, ev)``: one native call
    replays a unit's pairs (arrays, pairs of one reference consecutive;
    ``native_engine.replay_unit``) into the triples `out`, flattened to
    (S, 3) with `slot` indexing its rows, and, when `rf` is an open
    file, appends the unit's region records in one write. A log the
    replay rejects is recorded in `mismatched`, as ``Finalizer`` does.

    Counters for the engine stats: `c_s` (seconds inside the native
    calls, summed over threads), `pairs`, and `t_first` / `t_last` (the
    first unit submitted through ``submit`` or begun, the last one
    finished)."""

    def __init__(self, codes, params, out, rf=None):
        self.seqs = native_engine.SeqTable(codes)
        self.cfg = native_engine.make_cfg(params)
        self.out = out.reshape(-1, 3)
        if not np.shares_memory(self.out, out):
            raise ValueError("UnitReplay: `out` must be C-ordered")
        self.rf = rf
        self.flt = params.output_filter
        self._lock = threading.Lock()
        #: (r, q) of the logs the replay rejected; their slots stay unset
        self.mismatched: list[tuple[int, int]] = []
        self.c_s = 0.0
        self.pairs = 0
        self.t_first = self.t_last = None

    @property
    def replay_mismatches(self) -> int:
        return len(self.mismatched)

    @property
    def wall_s(self) -> float:
        return (self.t_last - self.t_first) if self.t_last else 0.0

    def __call__(self, r, q, slot, nev, off, ev=None, threads=1):
        """Replay one unit, its references' runs over up to `threads`
        native threads; ``ev`` None (every ``nev < 0``) parses each pair
        natively."""
        if ev is None:
            ev = np.zeros((0, 8), np.int32)
        t0 = time.perf_counter()
        status, words = native_engine.replay_unit(
            self.seqs, self.cfg, r, q, slot, nev, off, ev, self.out,
            want_regions=self.rf is not None, flt=self.flt, threads=threads)
        dt = time.perf_counter() - t0
        bad = np.flatnonzero(status < 0)
        with self._lock:
            if self.t_first is None:
                self.t_first = t0
            self.c_s += dt
            self.pairs += len(status)
            if len(bad):
                self.mismatched.extend(zip(np.asarray(r)[bad].tolist(),
                                           np.asarray(q)[bad].tolist()))
            if len(words):
                words.tofile(self.rf)
            self.t_last = time.perf_counter()
        return len(status)

    def parse_row(self, r, qs, slots):
        """Parse reference row r's queries `qs` natively into `slots`, in
        one call (one index build), as a unit without logs."""
        k = len(qs)
        if k:
            self(np.full(k, r, np.int32), qs, slots,
                 np.full(k, -1, np.int32), np.zeros(k, np.int64))

    def submit(self, pool, *unit, then=None, threads=1, queued=None,
               replayed=None):
        """Queue ``self(*unit, threads=threads)`` on `pool`;
        ``then(n_pairs)`` runs after it on the same task. When given,
        ``queued(t_submit, t_start)`` runs before it with the times of the
        submission and of the task's start, and ``replayed(t_start,
        t_end)`` after it with the start and end of the replay call.
        Returns the future."""
        t_sub = time.perf_counter()
        with self._lock:
            if self.t_first is None:
                self.t_first = t_sub

        def task():
            t0 = time.perf_counter()
            if queued is not None:
                queued(t_sub, t0)
            k = self(*unit, threads=threads)
            if replayed is not None:
                replayed(t0, time.perf_counter())
            if then is not None:
                then(k)

        return pool.submit(task)
