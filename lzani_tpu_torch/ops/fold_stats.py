"""The event-log fold: factors and the stats triple of every pair of a
parse launch, on the device. The CUDA kernel's wrapper and its plain
version.

The JAX package's automaton backend (``--backend jax``,
``lzani_tpu/ops/engine_jax.py``) computes each pair's stats triple on
the device: ``make_pair_parser`` (``lzani_tpu/ops/parse.py:78``) emits
the factor list as it parses, and ``_component_stats`` (``:536``) folds
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
extension scans) or a factor list over the stack's capacity, 1 skipped
(nev < 0); with ``want_factors`` also ``fac`` (G, B, LqP + 4, 4) int32
{dpos, kind, rpos, len} and ``nfac`` (G, B) int32, the first ``nfac``
entries of a pair defined.

A caller marks the pairs it parses natively (capacity fallbacks) with
nev = -1. The wrapper launches the kernel for CUDA tensors (or raises)
and takes the plain version only for CPU tensors; it counts its
launches. The kernel runs one warp per pair on the parse kernel's bit
planes, which it packs into scratch on the card; the reference's planes,
each query's planes and the top of each pair's factor stack (a ring of
RING entries) sit in shared memory where they fit (``launch_plan``,
chosen by shape against the card's limit before the launch), and what
does not fit is read from device memory (csrc/fold_stats.cu says why).
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from . import build
from .parse import ParseCfg
from .parse_kernel import sm_count
from .prep import SYM_N_REF, SYM_N_SEQ

SOURCE = os.path.join(build.CSRC, "fold_stats.cu")

F_LIT, F_CLOSE, F_DISTANT = 0, 1, 2

#: entries of the factor stack's top kept in shared memory, a warp (a
#: power of two); the heaviest viral pair's stack reaches 894 entries
RING = 2048

#: warps a block of the kernel (its launch bound)
MAX_WARPS = 8


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


#: per-pair int64 fields of the probe build (csrc/fold_stats.cu; ``load``
#: checks their count against its lzt_fold_nprobe): the warp's span in
#: cycles; events, backward scans, symbols scanned back and forward,
#: symbols emitted in aligned ranges, gaps with their symbols, scanned
#: positions and splits, pushes, top merges, region kills and their pops,
#: the stack's deepest and final entries; cycles in records and the first
#: pass, gaps, the capped backward scan, emission, kills and the stats;
#: entries read below the shared-memory ring
PROBE_FIELDS = ("span", "events", "bwd_scans", "bwd_syms", "fwd_syms",
                "emit_syms", "gaps", "gap_syms", "gap_scan", "gap_split",
                "pushes", "merges", "kills", "kill_pops", "max_n", "nfac",
                "cyc_rec", "cyc_gap", "cyc_bwd", "cyc_emit", "cyc_kill",
                "cyc_stats", "below_ring")
NPROBE = len(PROBE_FIELDS)


def set_argtypes(lib) -> None:
    """Argument and result types of the C entries of `lib` (pointers and
    the stream must not be cut to int)."""
    lib.lzt_fold_stats.argtypes = ([ctypes.c_void_p] * 10
                                   + [ctypes.c_int] * 14
                                   + [ctypes.c_void_p] * 6
                                   + [ctypes.c_int] * 6)
    lib.lzt_fold_occupancy.argtypes = [ctypes.c_int, ctypes.c_int]
    for fn in (lib.lzt_fold_stats, lib.lzt_fold_abi, lib.lzt_fold_nprobe,
               lib.lzt_fold_smem_max, lib.lzt_fold_occupancy):
        fn.restype = ctypes.c_int


@functools.lru_cache(maxsize=None)
def load(probe: bool = False) -> ctypes.CDLL:
    """Build (at first use) and load the kernel's library; `probe` builds
    the probe variant (-DLZT_PROBE: per-pair spans and counts), a library
    of its own name and build key. Checks the probe record's size against
    PROBE_FIELDS."""
    lib = (build.load_library("fold_stats_probe", [SOURCE], ("-DLZT_PROBE",))
           if probe else build.load_library("fold_stats", [SOURCE]))
    set_argtypes(lib)
    if lib.lzt_fold_nprobe() != NPROBE:
        raise RuntimeError(f"fold_stats: the library's probe records have "
                           f"{lib.lzt_fold_nprobe()} fields, PROBE_FIELDS "
                           f"{NPROBE}")
    return lib


def launch_plan(G: int, B: int, LrP: int, LqP: int, n_sm: int,
                smem_max: int, ring: int = RING):
    """(shared bytes, reference planes in shared memory, query planes in
    shared memory, warps a block, blocks a reference) of a launch over G
    references x B queries at buckets LrP / LqP on a card of `n_sm` SMs
    whose blocks may take `smem_max` bytes of dynamic shared memory
    (``smem_limit``). A warp for each query, in blocks few enough in warps
    that the G references' blocks cover the SMs; each warp's ring of
    `ring` stack entries (8 bytes each) always, then the reference's three
    planes of LrP / 32 words where they fit, then a slot for a query's
    planes a warp where those fit too (and LqP / 32 is a multiple of 4,
    for 16-byte copies). Raises when the rings alone do not fit."""
    per_ref = max(1, -(-n_sm // max(G, 1)))
    warps = min(MAX_WARPS, max(1, B // per_ref))
    used = warps * ring * 8
    if used > smem_max:
        raise ValueError(f"fold_stats: {warps} rings of {ring} entries need "
                         f"{used} bytes of shared memory, the card gives "
                         f"{smem_max}")
    ref_bytes = 3 * (LrP // 32) * 4
    ref_smem = used + ref_bytes <= smem_max
    used += ref_bytes if ref_smem else 0
    q_bytes = warps * 3 * (LqP // 32) * 4
    q_smem = (LqP // 32) % 4 == 0 and used + q_bytes <= smem_max
    used += q_bytes if q_smem else 0
    return used, ref_smem, q_smem, warps, max(1, -(-B // warps))


@functools.lru_cache(maxsize=None)
def smem_limit(dev: torch.device) -> int:
    """Dynamic shared memory (bytes) a block of the kernel may take on the
    card `dev` (its opt-in limit less the kernel's static shared memory;
    H100: 227 KiB); raises on an error."""
    with torch.cuda.device(dev):
        n = load().lzt_fold_smem_max()
    if n < 0:
        raise RuntimeError("fold_stats: shared-memory limit query failed")
    return n


def occupancy(smem: int, warps: int) -> int:
    """Blocks of `warps` warps with `smem` shared bytes that one SM holds at
    once, on the current card (the occupancy API); raises on an error."""
    n = load().lzt_fold_occupancy(smem, warps)
    if n < 0:
        raise RuntimeError("fold_stats: occupancy query failed")
    return n


def fold_stats(refbuf, qbuf, ev, nev, dsz, nrs, cfg: ParseCfg,
               want_factors: bool = False, smem_max: int | None = None,
               ring: int = RING):
    """(stats, status) of every pair, or (stats, status, fac, nfac) with
    `want_factors` (see module doc). CUDA tensors launch the kernel; CPU
    tensors take the plain version. `smem_max`: the shared bytes a block
    may take (None: the card's limit; the rings alone keep the planes in
    device memory), `ring`: the stack entries a warp keeps in shared
    memory (a power of two)."""
    _check(refbuf, qbuf, ev, nev, dsz, nrs)
    if refbuf.device.type == "cpu":
        return fold_stats_plain(refbuf, qbuf, ev, nev, dsz, nrs, cfg,
                                want_factors)
    out = _launch(load(), refbuf, qbuf, ev, nev, dsz, nrs, cfg,
                  want_factors, smem_max=smem_max, ring=ring)
    fold_stats.launches += 1
    return out[:4] if want_factors else out[:2]


def fold_stats_probe(refbuf, qbuf, ev, nev, dsz, nrs, cfg: ParseCfg):
    """``fold_stats`` through the probe build (CUDA tensors only; not
    counted as a launch): (stats, status, counts), counts (G, B, NPROBE)
    int64, each pair's PROBE_FIELDS."""
    _check(refbuf, qbuf, ev, nev, dsz, nrs)
    counts = torch.zeros((*nev.shape, NPROBE), dtype=torch.int64,
                         device=refbuf.device)
    stats, status = _launch(load(probe=True), refbuf, qbuf, ev, nev, dsz,
                            nrs, cfg, False, counts)[:2]
    return stats, status, counts


def _launch(lib, refbuf, qbuf, ev, nev, dsz, nrs, cfg, want_factors,
            probe=None, smem_max: int | None = None, ring: int = RING):
    """Allocate the outputs and the scratch and launch `lib`'s C entry on
    the current stream of refbuf's device; raises when the launch is
    refused. Returns (stats, status, stack, nfac)."""
    G, LrP = refbuf.shape
    B, LqP = qbuf.shape
    if LrP % 128 or LqP % 32:
        # plane rows of whole words, the reference's copied in 16-byte
        # chunks
        raise ValueError(f"fold_stats: LrP {LrP} must be a multiple of 128 "
                         f"and LqP {LqP} of 32")
    if ring < 2 or ring & (ring - 1):
        raise ValueError(f"fold_stats: ring {ring} is not a power of two")
    dev = refbuf.device
    if dev.type != "cuda":
        raise ValueError(f"fold_stats: unsupported device {dev}")
    F = stack_entries(LqP)
    words = 4 if want_factors else 2
    i32 = dict(dtype=torch.int32, device=dev)
    stats = torch.empty((G, B, 3), **i32)
    status = torch.empty((G, B), **i32)
    nfac = torch.empty((G, B), **i32)
    stack = torch.empty((G, B, F, words), **i32)
    with torch.cuda.device(dev):
        smem, ref_smem, q_smem, warps, slices = launch_plan(
            G, B, LrP, LqP, sm_count(dev),
            smem_limit(dev) if smem_max is None else smem_max, ring)
        rpl = torch.empty((G, 3, LrP // 32), **i32)
        qpl = torch.empty((B, 3, LqP // 32), **i32)
        order = torch.argsort(dsz, descending=True,
                              stable=True).to(torch.int32)
        next_q = torch.zeros(G, **i32)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.lzt_fold_stats(
            refbuf.data_ptr(), qbuf.data_ptr(), ev.data_ptr(),
            nev.data_ptr(), dsz.data_ptr(), nrs.data_ptr(),
            stats.data_ptr(), status.data_ptr(), stack.data_ptr(),
            nfac.data_ptr(), G, B, LrP, LqP, ev.shape[2], F, words, cfg.msl,
            cfg.mrd, cfg.mqd, cfg.reg, cfg.aw, cfg.am, cfg.ar, stream,
            0 if probe is None else probe.data_ptr(), rpl.data_ptr(),
            qpl.data_ptr(), order.data_ptr(), next_q.data_ptr(), smem,
            int(ref_smem), int(q_smem), ring, warps, slices)
    if rc != 0:
        raise RuntimeError(f"fold_stats: kernel launch failed (cudaError "
                           f"{rc})")
    return stats, status, stack, nfac


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
