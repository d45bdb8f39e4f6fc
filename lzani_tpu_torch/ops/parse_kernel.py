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
  dsz      (G, B)       int32   query length + mrd per pair (msl: no-op;
                                the kernel packs a query's planes to its
                                longest pair and reads a shorter pair's
                                query as N past its dsz)
both:
  next_hit (G, B, LqP)  int32   next query position with candidates

Outputs: ``ev`` (G, B, ev_cap + 1, 8) int32 records {i, pos, len, bwd,
ext, 0, 0, 0} and ``nev`` (G, B) int32, -1 when the parse did not reach
``i + msl >= dsz`` within ev_cap + 1 records. Only the first ``nev``
records of a pair are defined.

Symbol codes: 0-3 ACGT; the reference's N is 4 and the query's 5, so N
never matches. (The group kernel reads every code >= 4 as N on both
sides.)

A wrapper launches its kernel for CUDA tensors (or raises) and takes the
plain version only for CPU tensors. Each wrapper counts its launches. A
launch runs one warp per pair, so its time is that of its slowest pair
once the card holds every warp at once. Both kernels pack the symbols
into bit planes in scratch on the card. The group kernel
(``parse_events``) keeps each reference's planes in shared memory when
they fit (``launch_plan``, chosen by shape against the card's limit
before the launch); otherwise its other instantiation reads them from
device memory. It counts the launches of each instantiation too.
``parse_events`` also serves the per-reference routes (``CudaRefIndex``,
``dispatch_range``: G = 1). The long-genome kernel (``parse_events_big``)
reads both sides' planes from device memory, its warps taking the pairs
longest first (``big_launch_plan``, ``big_scratch``).
"""

from __future__ import annotations

import ctypes
import functools
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


#: per-pair int64 fields of either kernel's probe build
#: (csrc/parse_events.cu; ``load`` checks their count against its
#: lzt_parse_nprobe)
PROBE_FIELDS = ("span", "steps", "jumps", "anc_cand", "anc_lce", "synced",
                "synced_lit", "seed_chunks", "seed_loads", "seed_hits",
                "seed_lce", "ext_bwd", "ext_fwd", "events", "cyc_anc",
                "cyc_seed", "cyc_ext", "skipped", "cyc_run", "cyc_jump")
NPROBE = len(PROBE_FIELDS)

#: warps a block of either kernel (their launch bound)
MAX_WARPS = 8


def launch_plan(G: int, B: int, LrP: int, n_sm: int, smem_max: int):
    """(shared bytes, warps a block, blocks a reference) of a group launch
    of G references x B queries at reference bucket LrP on a card of
    `n_sm` SMs whose blocks may take `smem_max` bytes of dynamic shared
    memory (``smem_limit``). The reference's three planes of LrP / 32
    words go into shared memory when they fit; shared bytes 0 selects the
    instantiation that reads them from device memory.
    A warp for each query, in blocks few enough in warps that the G
    references' blocks cover the SMs (a block's warps take its reference's
    queries from a counter)."""
    ref_bytes = 3 * (LrP // 32) * 4
    per_ref = max(1, -(-n_sm // max(G, 1)))
    warps = min(MAX_WARPS, max(1, B // per_ref))
    return (ref_bytes if ref_bytes <= smem_max else 0, warps,
            max(1, -(-B // warps)))


def big_launch_plan(pairs: int, n_sm: int):
    """(warps a block, blocks) of a long-genome launch of `pairs` pairs on
    a card of `n_sm` SMs. A warp for each pair: one a block, each on an
    SM of its own, while the pairs are no more than the SMs (a pair's
    warp is one chain of dependent loads, and a launch lasts as long as
    its slowest pair); above that, up to MAX_WARPS a block. The warps
    take the pairs from a counter, longest query first."""
    warps = min(MAX_WARPS, max(1, -(-pairs // n_sm)))
    return warps, max(1, -(-pairs // warps))


def big_scratch(dsz, LrP: int, LqP: int):
    """Scratch of a long-genome launch of (G, B) per-pair query lengths
    `dsz` at buckets LrP and LqP, on dsz's device: the references' and the
    queries' bit planes ((G, 3, LrP / 32) and (B, 3, LqP / 32) words), each
    query's longest pair length (its planes are packed to it; the kernel
    reads a shorter pair's query as N past its dsz), the G * B pairs
    longest first, and the zeroed pair counter."""
    G, B = dsz.shape
    i32 = dict(dtype=torch.int32, device=dsz.device)
    return (torch.empty((G, 3, LrP // 32), **i32),
            torch.empty((B, 3, LqP // 32), **i32),
            dsz.amax(0).to(torch.int32),
            torch.argsort(dsz.reshape(-1), descending=True,
                          stable=True).to(torch.int32),
            torch.zeros(1, **i32))


@functools.lru_cache(maxsize=None)
def sm_count(dev: torch.device) -> int:
    """The SMs of the card `dev`."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


@functools.lru_cache(maxsize=None)
def smem_limit(dev: torch.device) -> int:
    """Dynamic shared memory (bytes) a block of the group kernel may take
    on the card `dev` (its opt-in limit less the kernel's static shared
    memory; H100: 227 KiB); raises on an error."""
    with torch.cuda.device(dev):
        n = load().lzt_parse_smem_max()
    if n < 0:
        raise RuntimeError("parse_events: shared-memory limit query failed")
    return n


@functools.lru_cache(maxsize=None)
def load(probe: bool = False) -> ctypes.CDLL:
    """Build (at first use) and load the kernels' library; `probe` builds
    the probe variant (-DLZT_PROBE: either kernel's per-pair spans and
    step counts), a library of its own name and build key. Sets the C
    entries' argument types (pointers and the stream must not be cut to
    int) and checks the probe record's size against PROBE_FIELDS."""
    lib = (build.load_library("parse_events_probe", [SOURCE],
                              ("-DLZT_PROBE",)) if probe
           else build.load_library("parse_events", [SOURCE]))
    head = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 15 + [ctypes.c_void_p]
    lib.lzt_parse_events.argtypes = (head + [ctypes.c_void_p] * 5
                                     + [ctypes.c_int] * 3)
    lib.lzt_parse_events_big.argtypes = (head + [ctypes.c_void_p] * 6
                                         + [ctypes.c_int] * 2)
    lib.lzt_parse_occupancy.argtypes = [ctypes.c_int, ctypes.c_int]
    for fn in (lib.lzt_parse_events, lib.lzt_parse_events_big,
               lib.lzt_parse_occupancy, lib.lzt_parse_nprobe,
               lib.lzt_parse_smem_max):
        fn.restype = ctypes.c_int
    if lib.lzt_parse_nprobe() != NPROBE:
        raise RuntimeError(f"parse_events: the library's probe records have "
                           f"{lib.lzt_parse_nprobe()} fields, PROBE_FIELDS "
                           f"{NPROBE}")
    return lib


def occupancy(smem: int, warps: int) -> int:
    """Blocks of `warps` warps that one SM holds at once for the group
    kernel with `smem` shared bytes (0: the device-memory instantiation),
    on the current card (the occupancy API); raises on an error."""
    n = load().lzt_parse_occupancy(smem, warps)
    if n < 0:
        raise RuntimeError("parse_events: occupancy query failed")
    return n


def _launch(name, fn, refbuf, qbuf, poslist, cand, next_hit, win, dsz,
            nrs, cfg: ParseCfg, ev_cap: int, *, group: bool = True,
            probe=None, smem_max: int | None = None):
    """Allocate the outputs and the launch's scratch (the planes of both
    sides) and launch the C entry `fn` (a function of ``load()``) on the
    current stream of refbuf's device; raises when the launch is refused.
    Returns (ev, nev, plan): the plan launched, (shared bytes, warps a
    block, blocks a reference) of a group launch (``launch_plan``) or
    (warps a block, blocks) of a long-genome one (``big_launch_plan``). A
    group
    launch keeps the reference in shared memory when it fits `smem_max`
    bytes (None: the card's ``smem_limit``; 0 reads it from device
    memory); `probe`, a (G, B, NPROBE) int64 tensor, takes the probe
    build's per-pair counts."""
    dev = refbuf.device
    G, LrP = refbuf.shape
    B, LqP = qbuf.shape
    if LrP % (128 if group else 32) or LqP % 32:
        # plane rows of whole words (a group launch copies a reference's
        # in 16-byte chunks)
        raise ValueError(f"{name}: LrP {LrP} must be a multiple of "
                         f"{128 if group else 32} and LqP {LqP} of 32")
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if refbuf.data_ptr() % 16 or qbuf.data_ptr() % 16:
        # the plane pack reads 16 bytes at a time
        raise ValueError(f"{name}: refbuf and qbuf must be 16-byte aligned")
    evc = ev_cap + 1
    i32 = dict(dtype=torch.int32, device=dev)
    ev = torch.empty((G, B, evc, 8), **i32)
    nev = torch.empty((G, B), **i32)
    with torch.cuda.device(dev):
        if group:
            plan = launch_plan(
                G, B, LrP, sm_count(dev),
                smem_limit(dev) if smem_max is None else smem_max)
            scratch = (torch.empty((G, 3, LrP // 32), **i32),
                       torch.empty((B, 3, LqP // 32), **i32),
                       torch.argsort(dsz, descending=True,
                                     stable=True).to(torch.int32),
                       torch.zeros(G, **i32))
        else:
            scratch = big_scratch(dsz, LrP, LqP)
            plan = big_launch_plan(G * B, sm_count(dev))
        extra = (0 if probe is None else probe.data_ptr(),
                 *(t.data_ptr() for t in scratch), *plan)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(refbuf.data_ptr(), qbuf.data_ptr(), poslist.data_ptr(),
                cand.data_ptr(), next_hit.data_ptr(), win.data_ptr(),
                dsz.data_ptr(), nrs.data_ptr(), ev.data_ptr(),
                nev.data_ptr(), G, B, LrP, LqP, poslist.shape[1],
                win.shape[1], evc, cfg.mal, cfg.msl, cfg.mrd, cfg.mqd,
                cfg.reg, cfg.aw, cfg.am, cfg.ar, stream, *extra)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")
    return ev, nev, plan


def parse_events(refbuf, qbuf, poslist, cand, next_hit, win, dsz, nrs,
                 cfg: ParseCfg, ev_cap: int, smem_max: int | None = None):
    """Event logs of every pair of a group dispatch (see module doc).
    CUDA tensors launch the kernel; CPU tensors take the plain version.
    `smem_max`: the shared bytes the reference may take (None: the
    card's limit; 0 selects the device-memory instantiation)."""
    args = (refbuf, qbuf, poslist, cand, next_hit, win, dsz, nrs, cfg,
            ev_cap)
    _check("parse_events", *args, big=False)
    if refbuf.device.type == "cpu":
        return parse_events_plain(*args)
    ev, nev, plan = _launch("parse_events", load().lzt_parse_events, *args,
                            smem_max=smem_max)
    parse_events.launches += 1
    parse_events.last_plan = plan
    if plan[0]:
        parse_events.launches_shared += 1
    else:
        parse_events.launches_device += 1
    return ev, nev


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
    ev, nev, plan = _launch("parse_events_big",
                            load().lzt_parse_events_big, *args, group=False)
    parse_events_big.launches += 1
    parse_events_big.last_plan = plan
    return ev, nev


def parse_events_probe(refbuf, qbuf, poslist, cand, next_hit, win, dsz,
                       nrs, cfg: ParseCfg, ev_cap: int,
                       smem_max: int | None = None):
    """``parse_events`` through the group kernel's probe build (CUDA
    tensors only; not counted as a launch): (ev, nev, counts), counts
    (G, B, NPROBE) int64, each pair's PROBE_FIELDS."""
    args = (refbuf, qbuf, poslist, cand, next_hit, win, dsz, nrs, cfg,
            ev_cap)
    _check("parse_events_probe", *args, big=False)
    counts = torch.zeros((*cand.shape[:2], NPROBE), dtype=torch.int64,
                         device=refbuf.device)
    ev, nev, _ = _launch("parse_events_probe",
                         load(probe=True).lzt_parse_events, *args,
                         probe=counts, smem_max=smem_max)
    return ev, nev, counts


def parse_events_big_probe(refbuf, qbuf, poslist, cand, next_hit, win, dsz,
                           nrs, cfg: ParseCfg, ev_cap: int):
    """``parse_events_big`` through the probe build (CUDA tensors only;
    not counted as a launch): (ev, nev, counts), counts (G, B, NPROBE)
    int64, each pair's PROBE_FIELDS."""
    args = (refbuf, qbuf, poslist, cand, next_hit, win, dsz, nrs, cfg,
            ev_cap)
    _check("parse_events_big_probe", *args, big=True)
    counts = torch.zeros((*cand.shape[:2], NPROBE), dtype=torch.int64,
                         device=refbuf.device)
    ev, nev, _ = _launch("parse_events_big_probe",
                         load(probe=True).lzt_parse_events_big, *args,
                         group=False, probe=counts)
    return ev, nev, counts


#: kernel launches since the last reset (plain-version calls never count);
#: the group kernel's also by instantiation: the reference in shared
#: memory, or read from device memory; the plan of each wrapper's last
#: launch (``_launch``), None before the first
parse_events.launches = 0
parse_events.launches_shared = 0
parse_events.launches_device = 0
parse_events.last_plan = None
parse_events_big.launches = 0
parse_events_big.last_plan = None


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
