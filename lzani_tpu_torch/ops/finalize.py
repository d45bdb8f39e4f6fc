"""Per-pair finalizer: replay a kernel event log through the native
emission machinery, or parse the pair natively when there is no log.

Counterpart of ``_make_finalize`` (``lzani_tpu/ops/hybrid.py``), with one
difference: a log that the replay rejects (a bwd/ext cross-check failure,
``ValueError``) is recorded as a replay mismatch instead of being
swallowed, and the pair is not repaired. Such a log means the kernel
computed a wrong stream; ``all2all_cuda`` fails the run when any pair
mismatched. Only a pair without a log (a capacity fallback) is parsed
natively here.
"""

from __future__ import annotations

import threading

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
