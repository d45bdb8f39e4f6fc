"""The event-log fold: factors and the stats triple of every pair of a
parse launch, on the device. The CUDA kernel's wrapper and its plain
version.

The JAX package's automaton backend (``--backend jax``,
``lzani_tpu/ops/engine_jax.py``) computes each pair's stats triple on
the device: ``make_pair_parser`` (``lzani_tpu/ops/parse.py:78``) emits
the factor list as it parses, and ``_component_stats`` (``:535``) folds
it. The port splits that work in two: the parse kernel
(``parse_kernel.parse_events``) writes each pair's event log, and this
kernel replays the log into the factor list and folds the triple, with
the host replay's consistency checks (``Parser::replay_events`` and
``Parser::stats``, ``csrc/lzani_core.cpp``). Inputs are a
``parse_events`` launch's own tensors:

  refbuf  (G, LrP)         uint8  composite reference buffers
  qbuf    (B, LqP)         uint8  query buffers
  ev      (G, B, evc, 8)   int32  event records {i, pos, len, bwd, ext, ...}
  nev     (G, B)           int32  records per pair; < 0: no log (skipped)
  dsz     (B,)             int32  query length + mrd
  nrs     (G,)             int32  composite reference length

Outputs: ``stats`` (G, B, 3) int32 {sym_in_matches, sym_in_literals,
components}; ``status`` (G, B) int32: 0 ok, -1 a log the replay rejects
(events out of order, bwd on a close match, bwd or ext unequal to the
extension scans), 1 skipped (nev < 0); with ``want_factors`` also
``fac`` (G, B, LqP + 4, 4) int32 {dpos, kind, rpos, len} and ``nfac``
(G, B) int32, the first ``nfac`` entries of a pair defined.

A caller marks the pairs it parses natively (capacity fallbacks) with
nev = -1. The wrapper launches the kernel for CUDA tensors (or raises)
and takes the plain version only for CPU tensors; it counts its
launches. One thread per pair (csrc/fold_stats.cu says why).
"""

from __future__ import annotations

import ctypes
import os

import torch

from . import build
from .parse import ParseCfg
from .prep import SYM_N_REF, SYM_N_SEQ

SOURCE = os.path.join(build.CSRC, "fold_stats.cu")

F_LIT, F_CLOSE, F_DISTANT = 0, 1, 2


def stack_entries(LqP: int) -> int:
    """Factor-stack entries per pair: every factor but the last covers at
    least one query position (the JAX automaton's Fmax = Lq + 4)."""
    return LqP + 4


def _check(refbuf, qbuf, ev, nev, dsz, nrs):
    G, _ = refbuf.shape
    B, _ = qbuf.shape
    want = {
        "refbuf": (refbuf, torch.uint8, (G, refbuf.shape[1])),
        "qbuf": (qbuf, torch.uint8, (B, qbuf.shape[1])),
        "ev": (ev, torch.int32, (G, B, ev.shape[2], 8)),
        "nev": (nev, torch.int32, (G, B)),
        "dsz": (dsz, torch.int32, (B,)),
        "nrs": (nrs, torch.int32, (G,)),
    }
    for arg, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"fold_stats: {arg} must be {dtype} of shape "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != refbuf.device:
            raise ValueError(f"fold_stats: {arg} is on {t.device}, refbuf "
                             f"on {refbuf.device}")
        if not t.is_contiguous():
            raise ValueError(f"fold_stats: {arg} is not contiguous")
    if qbuf.shape[1] >= 1 << 29 or refbuf.shape[1] >= 1 << 31:
        raise ValueError("fold_stats: a buffer beyond the kernel's "
                         "position range")


def load() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library."""
    lib = build.load_library("fold_stats", [SOURCE])
    fn = lib.lzt_fold_stats
    if fn.argtypes is None:  # pointers and the stream must not be cut
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 14
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def fold_stats(refbuf, qbuf, ev, nev, dsz, nrs, cfg: ParseCfg,
               want_factors: bool = False):
    """(stats, status) of every pair, or (stats, status, fac, nfac) with
    `want_factors` (see module doc). CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    _check(refbuf, qbuf, ev, nev, dsz, nrs)
    if refbuf.device.type == "cpu":
        return fold_stats_plain(refbuf, qbuf, ev, nev, dsz, nrs, cfg,
                                want_factors)
    dev = refbuf.device
    if dev.type != "cuda":
        raise ValueError(f"fold_stats: unsupported device {dev}")
    G, LrP = refbuf.shape
    B, LqP = qbuf.shape
    F = stack_entries(LqP)
    words = 4 if want_factors else 2
    stats = torch.empty((G, B, 3), dtype=torch.int32, device=dev)
    status = torch.empty((G, B), dtype=torch.int32, device=dev)
    nfac = torch.empty((G, B), dtype=torch.int32, device=dev)
    stack = torch.empty((G, B, F, words), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = load().lzt_fold_stats(
            refbuf.data_ptr(), qbuf.data_ptr(), ev.data_ptr(),
            nev.data_ptr(), dsz.data_ptr(), nrs.data_ptr(),
            stats.data_ptr(), status.data_ptr(), stack.data_ptr(),
            nfac.data_ptr(), G, B, LrP, LqP, ev.shape[2], F, words, cfg.msl,
            cfg.mrd, cfg.mqd, cfg.reg, cfg.aw, cfg.am, cfg.ar, stream)
    if rc != 0:
        raise RuntimeError(f"fold_stats: kernel launch failed (cudaError "
                           f"{rc})")
    fold_stats.launches += 1
    if want_factors:
        return stats, status, stack, nfac
    return stats, status


#: kernel launches since the last reset (plain-version calls never count)
fold_stats.launches = 0


# ---------------------------------------------------------------------------
# plain version: the host replay, pair by pair, in Python
# ---------------------------------------------------------------------------

class _Rejected(Exception):
    """The log fails a consistency check of the replay."""


class _Pair:
    """One pair's replay (``Parser::replay_events`` and its helpers) over
    the pair's buffers; a position outside [0, nr) reads N_REF, outside
    [0, dsz) N_SEQ."""

    def __init__(self, ref: bytes, q: bytes, cfg: ParseCfg, cap: int):
        self.ref, self.q, self.c, self.cap = ref, q, cfg, cap
        self.nr, self.dsz = len(ref), len(q)
        self.fac: list[list[int]] = []

    def eq(self, rp, qp):
        r = self.ref[rp] if 0 <= rp < self.nr else SYM_N_REF
        s = self.q[qp] if 0 <= qp < self.dsz else SYM_N_SEQ
        return r == s

    def push(self, dpos, kind, rpos, length):
        if len(self.fac) >= self.cap:
            raise _Rejected("factor stack overflow")
        self.fac.append([dpos, kind, rpos, length])

    def emit_aligned(self, dpos, rpos, length, backward):
        flag = F_DISTANT if backward else F_CLOSE
        run, matching = 0, False
        for j in range(length):
            if self.eq(rpos + j, dpos + j):
                if matching:
                    run += 1
                else:
                    if run:
                        self.push(dpos + j - run, F_LIT, 0, run)
                    run, matching = 1, True
            elif matching:
                self.push(dpos + j - run, flag, rpos + j - run, run)
                run, matching, flag = 1, False, F_CLOSE
            else:
                run += 1
        if matching:
            self.push(dpos + length - run, flag, rpos + length - run, run)
        elif run:
            self.push(dpos + length - run, F_LIT, 0, run)

    def emit_gap(self, dpos, r_left, r_right, length):
        fac = self.fac
        to_scan = length if r_right < r_left else min(r_right - r_left,
                                                      length)
        lhs = [(0, False)]
        nm = 0
        for j in range(to_scan):
            e = self.eq(r_left + j, dpos + j)
            nm += e
            lhs.append((nm, e))
        rhs = [(0, False)]
        nm = 0
        for j in range(1, min(to_scan, r_right) + 1):
            e = self.eq(r_right - j, dpos + length - j)
            nm += e
            rhs.append((nm, e))
        rhs += [(0, False)] * (to_scan + 1 - len(rhs))
        best = split = 0
        for j in range(to_scan + 1):
            tot = lhs[j][0] + rhs[to_scan - j][0]
            if tot >= best:          # the rightmost split wins ties
                best, split = tot, j
        if split > 0:
            e = lhs[1][1]
            self.push(dpos, F_CLOSE if e else F_LIT, r_left if e else 0, 1)
            dp = dpos + 1
            for j in range(2, split + 1):
                e = lhs[j][1]
                kind = F_CLOSE if e else F_LIT
                if kind == fac[-1][1]:
                    fac[-1][3] += 1
                else:
                    self.push(dp, kind, r_left + j - 1 if e else 0, 1)
                dp += 1
        if to_scan < length:
            if split > 0 and fac[-1][1] == F_LIT:
                fac[-1][3] += length - to_scan
            else:
                self.push(dpos + split, F_LIT, 0, length - to_scan)
        if split < to_scan:
            shift = length - to_scan
            from_right = to_scan - split
            e = rhs[from_right][1]
            dp = dpos + split + shift
            if not e and (split > 0 or shift > 0) and fac[-1][1] == F_LIT:
                fac[-1][3] += 1      # dp deliberately not advanced
            else:
                self.push(dp, F_CLOSE if e else F_LIT,
                          r_right - from_right if e else 0, 1)
                dp += 1
            for j in range(from_right - 1, 0, -1):
                e = rhs[j][1]
                kind = F_CLOSE if e else F_LIT
                if kind == fac[-1][1]:
                    fac[-1][3] += 1
                else:
                    self.push(dp, kind, r_right - j if e else 0, 1)
                dp += 1

    def extend(self, dpos, rpos, max_len, fwd):
        c = self.c
        win = [0] * c.aw
        bad, run, last, e = 0, c.ar, 0, 0
        while (dpos + e < self.dsz and rpos + e < self.nr if fwd
               else dpos - e > 0 and rpos - e > 0 and e < max_len):
            miss = int(not (self.eq(rpos + e, dpos + e) if fwd
                            else self.eq(rpos - e - 1, dpos - e - 1)))
            bad += miss - win[e % c.aw]
            win[e % c.aw] = miss
            if not miss:
                run += 1
                if run >= c.ar:
                    last = e + 1
            else:
                run = 0
            if bad > c.am:
                break
            e += 1
        return last

    def replay(self, ev):
        c, fac, dsz = self.c, self.fac, self.dsz
        pred, lit_run, reg_lo, reg_hi, i = -dsz, 0, -1, 0, 0
        for i_ev, best_pos, best_len, bwd_log, ext_log in ev:
            if i_ev < i or i_ev + c.msl >= dsz:
                raise _Rejected("event out of order")
            while i < i_ev:
                i += 1
                pred += 1
                lit_run += 1
                if lit_run > c.mqd:
                    pred = -dsz
            flag = F_DISTANT
            if pred >= 0 and abs(best_pos - pred) <= c.mrd:
                if bwd_log != 0:
                    raise _Rejected("bwd on a close match")
                self.emit_gap(i - lit_run, pred - lit_run,
                              best_pos + best_len, lit_run)
                self.push(i, F_CLOSE, best_pos, best_len)
            else:
                if lit_run:
                    self.push(i - lit_run, F_LIT, 0, lit_run)
                if reg_lo >= 0 and reg_hi - reg_lo < c.reg:
                    while fac and fac[-1][0] >= reg_lo:
                        fac.pop()
                    run_len = i - reg_lo
                    while fac and fac[-1][1] == F_LIT:
                        run_len += fac.pop()[3]
                    self.push(i - run_len, F_LIT, 0, run_len)
                    reg_lo = -1
                if fac and fac[-1][1] == F_LIT:
                    bwd = self.extend(i, best_pos, fac[-1][3], False)
                    if bwd != bwd_log:
                        raise _Rejected("bwd differs from the scan")
                    if bwd:
                        fac[-1][3] -= bwd
                        if fac[-1][3] == 0:
                            fac.pop()
                        self.emit_aligned(i - bwd, best_pos - bwd, bwd, True)
                        flag = F_CLOSE
                        reg_lo = i - bwd
                elif bwd_log != 0:
                    raise _Rejected("bwd without a literal run")
                self.push(i, flag, best_pos, best_len)
                if flag == F_DISTANT:
                    reg_lo = i
                if reg_lo < 0:
                    for f in reversed(fac):
                        if f[1] == F_DISTANT:
                            reg_lo = f[0]
                            break
            i += best_len
            pred = best_pos + best_len
            lit_run = 0
            ext = self.extend(i, pred, 0, True)
            if ext != ext_log:
                raise _Rejected("ext differs from the scan")
            self.emit_aligned(i, pred, ext, False)
            i += ext
            pred += ext
            reg_hi = i
        while i + c.msl < dsz:
            i += 1
            pred += 1
            lit_run += 1
            if lit_run > c.mqd:
                pred = -dsz
        if pred < 0:
            self.push(i - lit_run, F_LIT, 0, lit_run + (dsz - i))
        else:
            self.emit_aligned(i - lit_run, pred - lit_run - c.msl,
                              lit_run + (dsz - i), False)

    def stats(self):
        """``Parser::stats`` (the JAX package's ``_component_stats``)."""
        reg = self.c.reg
        tm = tl = nc = cm = cl = pend = 0
        for _, kind, _, length in self.fac:
            if kind == F_DISTANT:
                if cm and cm + cl >= reg:
                    tm, tl, nc = tm + cm, tl + cl, nc + 1
                cm, cl, pend = length, 0, 0
            elif kind == F_CLOSE:
                cm, cl, pend = cm + length, cl + pend, 0
            else:
                pend += length
        if cm and cm + cl >= reg:
            tm, tl, nc = tm + cm, tl + cl, nc + 1
        return tm, tl, nc


def fold_stats_plain(refbuf, qbuf, ev, nev, dsz, nrs, cfg: ParseCfg,
                     want_factors: bool = False):
    """Plain version of ``fold_stats``: the replay of each pair in turn,
    on CPU tensors only."""
    if refbuf.device.type != "cpu":
        raise ValueError(f"fold_stats_plain: CPU tensors only, got "
                         f"{refbuf.device}")
    G, B = nev.shape
    F = stack_entries(qbuf.shape[1])
    evc = ev.shape[2]
    stats = torch.zeros((G, B, 3), dtype=torch.int32)
    status = torch.zeros((G, B), dtype=torch.int32)
    nfac = torch.zeros((G, B), dtype=torch.int32)
    fac = torch.zeros((G, B, F, 4) if want_factors else (0,),
                      dtype=torch.int32)
    nev_h, dsz_h, nrs_h = nev.tolist(), dsz.tolist(), nrs.tolist()
    refs = [bytes(refbuf[g, :nrs_h[g]].tolist()) for g in range(G)]
    qs = [bytes(qbuf[b, :dsz_h[b]].tolist()) for b in range(B)]
    for g in range(G):
        for b in range(B):
            n = nev_h[g][b]
            if n < 0:
                status[g, b] = 1
                continue
            pair = _Pair(refs[g], qs[b], cfg, F)
            try:
                if n > evc:
                    raise _Rejected("more records than the log holds")
                pair.replay([r[:5] for r in ev[g, b, :n].tolist()])
            except _Rejected:
                status[g, b] = -1
                continue
            stats[g, b] = torch.tensor(pair.stats(), dtype=torch.int32)
            nfac[g, b] = len(pair.fac)
            if want_factors and pair.fac:
                fac[g, b, :len(pair.fac)] = torch.tensor(pair.fac,
                                                         dtype=torch.int32)
    return (stats, status, fac, nfac) if want_factors else (stats, status)
