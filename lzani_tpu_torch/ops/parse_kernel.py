"""Event-log parse of a dispatch: the CUDA kernels' wrappers and their
plain PyTorch versions.

Both kernels compute, for every (reference g, query b) pair, the greedy
LZ-parse decision stream of the reference parser — the function of the
TPU kernels ``make_parse_kernel_sim`` (``lzani_tpu/ops/pallas_v7.py``)
and ``make_parse_kernel(big=True)`` (``lzani_tpu/ops/pallas_engine.py``),
and of the C++ oracle ``Parser::parse`` (``csrc/lzani_core.cpp``). They
differ only in the candidate table and the query lengths. Inputs:

  refbuf   (G, LrP)     uint8   composite reference buffers
  qbuf     (B, LqP)     uint8   query buffers
  poslist  (G, KaP)     int32   anchor positions sorted by (k-mer, pos)
  win      (G, WinP)    int32   WIN arbitration bit table
  nrs      (G,)         int32   composite reference length
group path (``parse_events``):
  cand     (G, B, LqP)  int32   start << 7 | min(count, 127) per query pos
  dsz      (B,)         int32   query length + mrd
long-genome path (``parse_events_big``):
  cand     (G, B, 2, LqP) int32 start plane, unbounded count plane
  dsz      (G, B)       int32   query length + mrd per pair (msl: no-op)
both:
  next_hit (G, B, LqP)  int32   next query position with candidates

Outputs: ``ev`` (G, B, ev_cap + 1, 8) int32 records {i, pos, len, bwd,
ext, 0, 0, 0} and ``nev`` (G, B) int32, -1 when the parse did not reach
``i + msl >= dsz`` within ev_cap + 1 records. Only the first ``nev``
records of a pair are defined.

A wrapper launches its kernel for CUDA tensors (or raises) and takes the
plain version only for CPU tensors. Each wrapper counts its launches. A
launch runs one warp per pair (G x B warps; csrc/parse_events.cu says
how they are grouped into blocks), so its time is that of its slowest
pair once the card holds every warp at once. ``parse_events`` also
serves the per-reference routes (``CudaRefIndex``, ``dispatch_range``:
G = 1).
"""

from __future__ import annotations

import ctypes
import os

import torch

from . import build
from .anchor_tables import SAT
from .parse import ParseCfg
from .prep import SYM_N_REF, SYM_N_SEQ

SOURCE = os.path.join(build.CSRC, "parse_events.cu")


def _check(name, refbuf, qbuf, poslist, cand, next_hit, win, dsz, nrs,
           cfg: ParseCfg, ev_cap: int, big: bool):
    G, _ = refbuf.shape
    B, LqP = qbuf.shape
    want = {
        "refbuf": (refbuf, torch.uint8, (G, refbuf.shape[1])),
        "qbuf": (qbuf, torch.uint8, (B, LqP)),
        "poslist": (poslist, torch.int32, (G, poslist.shape[1])),
        "cand": (cand, torch.int32, (G, B, 2, LqP) if big else (G, B, LqP)),
        "next_hit": (next_hit, torch.int32, (G, B, LqP)),
        "win": (win, torch.int32, (G, win.shape[1])),
        "dsz": (dsz, torch.int32, (G, B) if big else (B,)),
        "nrs": (nrs, torch.int32, (G,)),
    }
    for arg, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} must be {dtype} of shape "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != refbuf.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, refbuf on "
                             f"{refbuf.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
    need_bits = ((SAT - cfg.mal + 1) * (SAT - cfg.msl + 1)
                 * (cfg.mqd + 1))
    if not (1 <= cfg.mal <= SAT and 1 <= cfg.msl <= SAT and cfg.aw >= 1
            and win.shape[1] * 32 >= need_bits and ev_cap >= 0):
        raise ValueError(f"{name}: parameters outside the kernel's "
                         f"envelope ({cfg}, WinP={win.shape[1]}, "
                         f"ev_cap={ev_cap})")
    if max(refbuf.shape[1], LqP, poslist.shape[1]) >= 1 << 31:
        raise ValueError(f"{name}: a buffer of 2^31 or more positions")


def load() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' library."""
    lib = build.load_library("parse_events", [SOURCE])
    for fn in (lib.lzt_parse_events, lib.lzt_parse_events_big):
        if fn.argtypes is None:  # pointers and the stream must not be cut
            fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 15
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
    return lib


def _launch(name, fn, refbuf, qbuf, poslist, cand, next_hit, win, dsz,
            nrs, cfg: ParseCfg, ev_cap: int):
    """Allocate the outputs and launch the C entry `fn` (a function of
    ``load()``) on the current stream of refbuf's device; raises when the
    launch is refused."""
    dev = refbuf.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    G, LrP = refbuf.shape
    B, LqP = qbuf.shape
    evc = ev_cap + 1
    ev = torch.empty((G, B, evc, 8), dtype=torch.int32, device=dev)
    nev = torch.empty((G, B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(refbuf.data_ptr(), qbuf.data_ptr(), poslist.data_ptr(),
                cand.data_ptr(), next_hit.data_ptr(), win.data_ptr(),
                dsz.data_ptr(), nrs.data_ptr(), ev.data_ptr(),
                nev.data_ptr(), G, B, LrP, LqP, poslist.shape[1],
                win.shape[1], evc, cfg.mal, cfg.msl, cfg.mrd, cfg.mqd,
                cfg.reg, cfg.aw, cfg.am, cfg.ar, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")
    return ev, nev


def parse_events(refbuf, qbuf, poslist, cand, next_hit, win, dsz, nrs,
                 cfg: ParseCfg, ev_cap: int):
    """Event logs of every pair of a group dispatch (see module doc).
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    args = (refbuf, qbuf, poslist, cand, next_hit, win, dsz, nrs, cfg,
            ev_cap)
    _check("parse_events", *args, big=False)
    if refbuf.device.type == "cpu":
        return parse_events_plain(*args)
    out = _launch("parse_events", load().lzt_parse_events, *args)
    parse_events.launches += 1
    return out


def parse_events_big(refbuf, qbuf, poslist, cand, next_hit, win, dsz, nrs,
                     cfg: ParseCfg, ev_cap: int):
    """Event logs of every pair of a long-genome dispatch: two-plane
    candidate table, per-pair query lengths (see module doc). CUDA tensors
    launch the kernel; CPU tensors take the plain version."""
    args = (refbuf, qbuf, poslist, cand, next_hit, win, dsz, nrs, cfg,
            ev_cap)
    _check("parse_events_big", *args, big=True)
    if refbuf.device.type == "cpu":
        return parse_events_big_plain(*args)
    out = _launch("parse_events_big", load().lzt_parse_events_big, *args)
    parse_events_big.launches += 1
    return out


#: kernel launches since the last reset (plain-version calls never count)
parse_events.launches = 0
parse_events_big.launches = 0


# ---------------------------------------------------------------------------
# plain PyTorch version: the same automaton in lockstep over the pair axis
# ---------------------------------------------------------------------------

class _Bufs:
    """Flat symbol reads with the kernel's guards: a reference position
    outside [0, nr) reads N_REF (4), a query position outside [0, dsz)
    reads N_SEQ (5), so every comparison past a buffer's end mismatches."""

    def __init__(self, refbuf, qbuf):
        self.ref = refbuf.reshape(-1)
        self.q = qbuf.reshape(-1)
        self.LrP = refbuf.shape[1]
        self.LqP = qbuf.shape[1]

    def r(self, g, nr, pos):
        v = self.ref[g * self.LrP + pos.clamp(0, self.LrP - 1)]
        return torch.where((pos >= 0) & (pos < nr), v, SYM_N_REF)

    def qs(self, b, dsz, pos):
        v = self.q[b * self.LqP + pos.clamp(0, self.LqP - 1)]
        return torch.where((pos >= 0) & (pos < dsz), v, SYM_N_SEQ)


def _lce(bufs, g, nr, rp, b, dsz, qp, start, live):
    """Vectorised Parser::match_len: per element, the first offset >=
    start where ref[rp + off] != q[qp + off]. Chunks double in width and
    only unresolved elements are re-read."""
    n = start.clone()
    todo = live.clone()
    ch = 16
    while bool(todo.any()):
        idx = todo.nonzero(as_tuple=True)
        off = n[idx][:, None] + torch.arange(ch, device=n.device)
        neq = (bufs.r(g[idx][:, None], nr[idx][:, None], rp[idx][:, None] + off)
               != bufs.qs(b[idx][:, None], dsz[idx][:, None],
                          qp[idx][:, None] + off))
        has = neq.any(1)
        n[idx] = n[idx] + torch.where(has, neq.int().argmax(1), ch)
        todo[idx] = ~has
        ch = min(2 * ch, 4096)
    return torch.where(live, n, 0)


def _ext_scan(bufs, cfg, g, nr, b, dsz, dpos, rpos, max_len, live, fwd):
    """Vectorised extend_fwd/extend_bwd (lzani_core.cpp:516-552) over
    chunks, carrying the last aw mismatches and the last-miss position."""
    dev = dpos.device
    aw, am, ar = cfg.aw, cfg.am, cfg.ar
    N = dpos.shape[0]
    last = torch.zeros(N, dtype=torch.long, device=dev)
    hist = torch.zeros((N, aw), dtype=torch.long, device=dev)
    lastmiss = torch.full((N,), -1 - ar, dtype=torch.long, device=dev)
    todo = live & (max_len > 0)
    e0, ch = 0, 32
    while bool(todo.any()):
        idx = todo.nonzero(as_tuple=True)
        e = e0 + torch.arange(ch, device=dev)
        inr = e[None] < max_len[idx][:, None]
        if fwd:
            dq = dpos[idx][:, None] + e
            dr = rpos[idx][:, None] + e
        else:
            dq = dpos[idx][:, None] - 1 - e
            dr = rpos[idx][:, None] - 1 - e
        miss = (bufs.qs(b[idx][:, None], dsz[idx][:, None], dq)
                != bufs.r(g[idx][:, None], nr[idx][:, None], dr)) & inr
        ext = torch.cat([hist[idx], miss.long()], 1)
        cs = ext.cumsum(1)
        bad = cs[:, aw:] - cs[:, :ch]          # misses in (e - aw, e]
        stop = ~inr | (bad > am)
        has_stop = stop.any(1)
        first_stop = torch.where(has_stop, stop.int().argmax(1), ch)
        lm = torch.where(miss, e[None], -1 - ar)
        lm = torch.maximum(lm.cummax(1).values, lastmiss[idx][:, None])
        ok = (~miss & (e[None] - lm >= ar)
              & (torch.arange(ch, device=dev)[None] < first_stop[:, None]))
        got = torch.where(ok, e[None] + 1, 0).amax(1)
        last[idx] = torch.maximum(last[idx], got)
        hist[idx] = ext[:, ch:]
        lastmiss[idx] = lm[:, -1]
        todo[idx] = ~has_stop
        e0 += ch
        ch = min(2 * ch, 2048)
    return last


#: candidates compared per chunk in the plain anchor search (bounds its
#: memory when counts run into the thousands: tandem repeats)
CAND_CHUNK = 256


def _anchor_search(bufs, cfg, g, nr, b, ds, i, start, cnt, pos_f, KaP):
    """Best (len, pos) over poslist[start : start + cnt] per pair: exact
    LCE >= mal, longest wins, the earliest (= smallest) position breaks
    ties. Candidates go in chunks of CAND_CHUNK; a later chunk wins only
    with a strictly longer match."""
    a_len = torch.zeros_like(i)
    a_pos = torch.zeros_like(i)
    kmax = int(cnt.max()) if cnt.numel() else 0
    for k0 in range(0, kmax, CAND_CHUNK):
        sel = (cnt > k0).nonzero(as_tuple=True)[0]
        k = torch.arange(k0, min(k0 + CAND_CHUNK, kmax), device=i.device)
        valid = k[None] < cnt[sel][:, None]
        pp = pos_f[g[sel][:, None] * KaP
                   + (start[sel][:, None] + k).clamp(0, KaP - 1)].long()
        ex = lambda t: t[sel][:, None].expand(-1, k.numel())
        ml = _lce(bufs, ex(g), ex(nr), pp, ex(b), ex(ds), ex(i),
                  torch.zeros_like(pp), valid)
        ok = valid & (ml >= cfg.mal)
        c_len = torch.where(ok, ml, 0).amax(1)
        top = ok & (ml == c_len[:, None])
        c_pos = torch.where(top, pp, torch.iinfo(torch.long).max).amin(1)
        better = c_len > a_len[sel]
        a_len[sel] = torch.where(better, c_len, a_len[sel])
        a_pos[sel] = torch.where(better, c_pos, a_pos[sel])
    return a_len, a_pos


def parse_events_plain(refbuf, qbuf, poslist, cand, next_hit, win, dsz,
                       nrs, cfg: ParseCfg, ev_cap: int):
    """Plain PyTorch version of ``parse_events``."""
    G, B = cand.shape[:2]
    LqP = qbuf.shape[1]
    cand_f = cand.reshape(-1)

    def cand_at(pid, ic):
        cw = cand_f[pid * LqP + ic].long()
        return cw >> 7, cw & 127

    ds = dsz.long()[None].expand(G, B).reshape(-1)
    return _automaton(refbuf, qbuf, poslist, cand_at, next_hit, win, ds,
                      nrs, cfg, ev_cap, G, B)


def parse_events_big_plain(refbuf, qbuf, poslist, cand, next_hit, win, dsz,
                           nrs, cfg: ParseCfg, ev_cap: int):
    """Plain PyTorch version of ``parse_events_big``."""
    G, B = cand.shape[:2]
    LqP = qbuf.shape[1]
    cand_f = cand.reshape(-1)

    def cand_at(pid, ic):
        base = pid * (2 * LqP) + ic
        return cand_f[base].long(), cand_f[base + LqP].long()

    return _automaton(refbuf, qbuf, poslist, cand_at, next_hit, win,
                      dsz.long().reshape(-1), nrs, cfg, ev_cap, G, B)


def _automaton(refbuf, qbuf, poslist, cand_at, next_hit, win, ds, nrs,
               cfg: ParseCfg, ev_cap: int, G: int, B: int):
    """The per-pair automaton in lockstep over all G*B pairs, one decision
    per pair per step, with masked state updates (see csrc/parse_events.cu
    for the semantics). ``cand_at(pid, i)`` reads the candidate table:
    (start, count) per pair; ``ds`` is the per-pair query length."""
    dev = refbuf.device
    LqP = qbuf.shape[1]
    KaP = poslist.shape[1]
    WinP = win.shape[1]
    P = G * B
    evc = ev_cap + 1
    L = torch.long
    mal, msl, mrd, mqd = cfg.mal, cfg.msl, cfg.mrd, cfg.mqd
    NS, NL = SAT - msl + 1, mqd + 1
    bufs = _Bufs(refbuf, qbuf)
    pid = torch.arange(P, device=dev)
    g = pid // B
    b = pid % B
    nr = nrs.to(L)[g]
    nh_f = next_hit.reshape(-1)
    pos_f = poslist.reshape(-1)
    win_f = win.reshape(-1)
    limit = ds - msl

    i = torch.zeros(P, dtype=L, device=dev)
    pred = -ds.clone()
    lit_run = torch.zeros_like(i)
    reg_lo = torch.full_like(i, -1)
    reg_hi = torch.zeros_like(i)
    lit_below = torch.zeros_like(i)
    ne = torch.zeros_like(i)
    ev = torch.zeros((P, evc, 8), dtype=torch.int32, device=dev)
    big = torch.iinfo(L).max

    while True:
        act = (i < limit) & (ne < evc)
        if not bool(act.any()):
            break
        # desynced pairs jump to their next anchor candidate
        uns = act & (pred < 0)
        j = torch.minimum(nh_f[pid * LqP + i.clamp(0, LqP - 1)].to(L), limit)
        lit_run = torch.where(uns, lit_run + (j - i), lit_run)
        i = torch.where(uns, j, i)
        act = act & (i < limit)
        syn = act & (pred >= 0)
        ic = i.clamp(0, LqP - 1)

        # anchors: longest exact LCE over the candidate range
        start, cnt = cand_at(pid, ic)
        cnt = torch.where(act, cnt, 0)
        a_len, a_pos = _anchor_search(bufs, cfg, g, nr, b, ds, i, start,
                                      cnt, pos_f, KaP)
        bl, bp = a_len, a_pos

        # synced seed search over [max(0, pred - lit_run), pred + mrd)
        if bool(syn.any()):
            W = mqd + mrd
            k = torch.arange(W, device=dev)
            p = (pred - lit_run)[:, None] + k
            inwin = syn[:, None] & (p >= 0) & (p < (pred + mrd)[:, None])
            t = torch.arange(msl, device=dev)
            ex3 = lambda v: v[:, None, None]
            pref = (bufs.r(ex3(g), ex3(nr), p[..., None] + t)
                    == bufs.qs(ex3(b), ex3(ds), ex3(i) + t)).all(-1) & inwin
            ex = lambda v: v[:, None].expand(-1, W)
            ml = _lce(bufs, ex(g), ex(nr), p, ex(b), ex(ds), ex(i),
                      torch.full_like(p, msl), pref)
            s_len = ml.amax(1)
            top = pref & (ml == s_len[:, None])
            dist = (p - pred[:, None]).abs()
            dmin = torch.where(top, dist, big).amin(1)
            top = top & (dist == dmin[:, None])
            s_pos = torch.where(top, p, big).amin(1)
            s_pos = torch.where(s_len > 0, s_pos, 0)
            # anchor vs seed: WIN bit table (exact f64 fpow replica)
            widx = (((a_len.clamp(max=SAT) - mal) * NS
                     + (s_len.clamp(max=SAT) - msl)) * NL + lit_run)
            widx = widx.clamp(0, WinP * 32 - 1)
            word = win_f[g * WinP + (widx >> 5)].to(L)
            arb = ((word >> (widx & 31)) & 1) > 0
            take = (a_pos != 0) & ((s_pos == 0) | arb)
            bl = torch.where(syn, torch.where(take, a_len, s_len), bl)
            bp = torch.where(syn, torch.where(take, a_pos, s_pos), bp)

        good = act & (bl >= msl)
        lit_step = act & ~good
        if bool(good.any()):
            close = (pred >= 0) & ((bp - pred).abs() <= mrd)
            kill = (reg_lo >= 0) & (reg_hi - reg_lo < cfg.reg)
            tl = torch.where(kill, (i - reg_lo) + lit_below, lit_run)
            need_bwd = good & ~close & (tl > 0)
            bmax = torch.minimum(torch.minimum(i, bp), tl)
            bwd = _ext_scan(bufs, cfg, g, nr, b, ds, i, bp, bmax, need_bwd,
                            fwd=False)
            i2 = i + bl
            pred2 = bp + bl
            fmax = torch.minimum(ds - i2, nr - pred2)
            ext = _ext_scan(bufs, cfg, g, nr, b, ds, i2, pred2, fmax, good,
                            fwd=True)
            gp = good.nonzero(as_tuple=True)[0]
            rec = torch.zeros((gp.numel(), 8), dtype=torch.int32, device=dev)
            rec[:, :5] = torch.stack(
                [i[gp], bp[gp], bl[gp], bwd[gp], ext[gp]], 1).to(torch.int32)
            ev[gp, ne[gp]] = rec
            far = good & ~close
            reg_lo = torch.where(far, torch.where(bwd > 0, i - bwd, i),
                                 reg_lo)
            lit_below = torch.where(far, tl - bwd, lit_below)
            i = torch.where(good, i2 + ext, i)
            pred = torch.where(good, pred2 + ext, pred)
            lit_run = torch.where(good, 0, lit_run)
            reg_hi = torch.where(good, i, reg_hi)
            ne = ne + good.long()
        # no match: one literal step; desync once the run exceeds mqd
        i = torch.where(lit_step, i + 1, i)
        pred = torch.where(lit_step & (pred >= 0), pred + 1, pred)
        lit_run = torch.where(lit_step, lit_run + 1, lit_run)
        pred = torch.where(lit_step & (lit_run > mqd), -ds, pred)

    nev = torch.where(i < limit, -1, ne).to(torch.int32)
    return ev.reshape(G, B, evc, 8), nev.reshape(G, B)
