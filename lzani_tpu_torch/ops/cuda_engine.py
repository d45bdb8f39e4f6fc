"""All-vs-all device engine of the port: resident state, plain-torch prep
and the two device routes around the CUDA event-log parse kernels.

Counterpart of the group and long-genome paths of
``lzani_tpu/ops/pallas_engine.py`` (``PallasAll2All``,
``PallasGroupIndex``, ``_get_group_step``, ``build_big_index``,
``dispatch_big``, ``collect_big``, ``all2all_pallas``). The query matrix
is packed 3 symbols per byte, laid out from the store's packed items and
kept resident on the device; each index derives its references'
composite buffers from the matrix's rows there (``dev_ref_buffers``), so
a genome crosses to the device once. Each reference row is routed as
the JAX package routes it (``row_path``) to the group route
(``GroupRoute``: groups of 4, the dense 11-mer join, ``parse_events``),
the long-genome route (``BigRoute``: the sorted
two-word-key join of ``big.py``, ``parse_events_big``) or, above
MAX_BIG_SYMS, the native engine. ``all2all_cuda`` plans the run
(``plan.py``) and drives each unit through its route: a group's index
built once on the device, a unit's prep and launch, its logs downloaded
compacted (``EventLogs``) and replayed by one native call on a thread
pool (``finalize.UnitReplay``). A group unit of a run that writes no
regions has its logs folded into triples on the device instead
(``GroupRoute.fold``, the fold kernel ``fold_stats``) and downloads
only those (``FoldedLogs``). The per-reference API runs on the group
route with G = 1: ``CudaRefIndex`` (``PallasRefIndex``) and
``CudaAll2All.dispatch_range`` / ``collect`` / ``run_range``. All is
plain PyTorch on an explicit ``torch.device`` but the hand-written
kernels, ``parse_kernel.parse_events``, ``parse_events_big`` and
``fold_stats.fold_stats``.
"""

from __future__ import annotations

import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..core import native_engine
from ..io.packing import pack_items
from .anchor_tables import SAT, win_words
from .big import big_query_prep, big_ref_join
from .finalize import UnitReplay
from .fold_stats import fold_stats
from .parse import ParseCfg
from .parse_kernel import parse_events, parse_events_big
from .plan import Layout, Plan, route_rows
from .prep import SYM_N_REF, SYM_N_SEQ
from .spans import OFF, Spans, UnitSpans, requested


# ---- host helpers (numpy; pallas_engine.py:214-249, 1059-1068) ------------

def _pad128(n):
    return -(-n // 128) * 128


def _bucket(n, lo=4096):
    """Power-of-two shape bucket."""
    b = lo
    while b < n:
        b *= 2
    return b


def _byte_table():
    """Radix-216 byte -> the same byte with each slot's N_ref (4) made
    N_seq (5), as ``prep.query_buffer_np`` maps codes; bytes above 215
    (no packing makes them) map to themselves."""
    b = np.arange(256)
    slots = [b // 36, (b // 6) % 6, b % 6]
    c0, c1, c2 = (np.where(x == SYM_N_REF, SYM_N_SEQ, x) for x in slots)
    return np.where(b < 216, c0 * 36 + c1 * 6 + c2, b).astype(np.uint8)


_TO_N_SEQ = _byte_table()
#: a byte of three N_seq codes
_N3 = SYM_N_SEQ * 43


def query_rows(codes, LqP: int, n_rows: int) -> np.ndarray:
    """The resident query matrix: (n_rows, pad128(ceil(LqP / 3))) uint8,
    row i the radix-216 packing (``io/packing.py``) of
    ``prep.query_buffer_np(codes[i], mrd)`` filled with N_seq up to LqP,
    its last byte's slots past LqP zero and zero bytes past it; rows past
    ``len(codes)`` all N_seq (padding). Laid out from the packed items
    (`codes.chunks`, a ``PackedCodes``; a plain list is packed first):
    each item's bytes go through ``_TO_N_SEQ`` once and the empty slots
    of its last byte become N_seq. No item is unpacked."""
    if not hasattr(codes, "chunks"):
        codes = pack_items(codes)
    full, part = divmod(LqP, 3)
    out = np.zeros((n_rows, _pad128(full + (part > 0))), np.uint8)
    out[:, :full] = _N3
    if part:                       # N_seq in its first `part` slots
        out[:, full] = _N3 - _N3 % (36 if part == 1 else 6)
    for i, (chunk, n) in enumerate(zip(codes.chunks, codes.slens.tolist())):
        w, r = -(-n // 3), n % 3
        assert w <= full, (n, LqP)
        out[i, :w] = _TO_N_SEQ[chunk[:w]]
        if r:                      # keep its first r slots, fill N_seq
            b, unit = int(out[i, w - 1]), 36 if r == 1 else 6
            out[i, w - 1] = b - b % unit + _N3 % unit
    return out


def pack_bits_i32(bits: np.ndarray, pad_words: int) -> np.ndarray:
    """0/1 array -> (1, W) int32 bit-words (little-endian within a word),
    W padded to a multiple of `pad_words`."""
    b = np.asarray(bits, np.uint8).reshape(-1)
    n_words = -(-len(b) // 32)
    W = -(-max(n_words, 1) // pad_words) * pad_words
    padded = np.zeros(W * 32, np.uint8)
    padded[:len(b)] = b
    words = (padded.reshape(W, 32).astype(np.uint32)
             << np.arange(32, dtype=np.uint32)).sum(1, dtype=np.uint32)
    return words.view(np.int32).reshape(1, W)


# ---- device prep (torch; pallas_engine.py:228-235, 1783-1795, 2094-2145)

def dev_unpack3(packed: torch.Tensor, L: int) -> torch.Tensor:
    """(R, Lp) radix-216 uint8 bytes -> (R, L) int32 codes."""
    p = packed.to(torch.int32)
    out = torch.stack([p // 36, (p // 6) % 6, p % 6], dim=-1)
    return out.reshape(p.shape[0], -1)[:, :L]


def dev_ref_buffers(qrows: torch.Tensor, lens, mrd: int,
                    LrP: int) -> torch.Tensor:
    """(G, LrP) uint8 composite reference buffers on the device of the
    packed rows `qrows` ((G, W) uint8, radix 216, as ``query_rows`` lays
    them out) of `lens[g]` symbols each (host ints): ``prep.ref_buffer_np``
    of each row's codes, fwd (N_seq -> N_ref) | N_ref x 2 mrd | its
    reverse complement, filled with N_ref to LrP. One row at a time, so
    the transients are one genome's."""
    out = torch.full((len(lens), LrP), SYM_N_REF, dtype=torch.uint8,
                     device=qrows.device)
    for g, n in enumerate(int(v) for v in lens):
        assert 2 * n + 3 * mrd <= LrP, (n, mrd, LrP)
        c = dev_unpack3(qrows[g:g + 1, :-(-n // 3)], n)[0].to(torch.uint8)
        fwd = torch.where(c == SYM_N_SEQ, SYM_N_REF, c)
        out[g, :n] = fwd
        out[g, n + 2 * mrd:2 * n + 2 * mrd] = torch.where(
            fwd < SYM_N_REF, 3 - fwd, fwd).flip(0)
    return out


def dev_kmer_stream(buf: torch.Tensor, k: int, n_sym: int = 4) -> torch.Tensor:
    """int32 k-mers per position of (B, L) int32 codes; -1 where the
    window has a non-ACGT code or runs off the end (parser.cpp:53-103).
    The roll wraps around; the wrapped windows are masked by idx <= L-k."""
    B, L = buf.shape
    val = torch.zeros((B, L), dtype=torch.int32, device=buf.device)
    ok = torch.ones((B, L), dtype=torch.bool, device=buf.device)
    for j in range(k):
        sh = torch.roll(buf, -j, dims=1)
        val = (val << 2) | torch.where(sh < n_sym, sh, 0)
        ok &= sh < n_sym
    idx = torch.arange(L, device=buf.device)
    ok &= (idx <= L - k)[None]
    return torch.where(ok, val, -1)


def group_join(refbuf: torch.Tensor, mal: int, KaP: int):
    """Per-reference anchor join of a (G, LrP) int32 buffer stack:
    ``ptab`` (G, 4^mal) int32 = start << 7 | min(count, 127) (0 where the
    k-mer is absent) and ``poslist`` (G, KaP) int32 = positions sorted by
    (k-mer, position). The sort is stable, so equal k-mers keep ascending
    positions (the smallest-position tie-break of the anchor search)."""
    G, LrP = refbuf.shape
    nk = 1 << (2 * mal)
    km = dev_kmer_stream(refbuf, mal)
    keys = torch.where(km >= 0, km, nk).to(torch.int64)
    _, order = torch.sort(keys, dim=1, stable=True)
    goff = torch.arange(G, device=refbuf.device)[:, None] * (nk + 1)
    count = torch.bincount((keys + goff).reshape(-1),
                           minlength=G * (nk + 1)).reshape(G, nk + 1)[:, :nk]
    start = count.cumsum(1) - count
    ptab = torch.where(count > 0, (start << 7) | count.clamp(max=127), 0)
    pos_s = order.to(torch.int32)
    if KaP <= LrP:
        poslist = pos_s[:, :KaP].contiguous()
    else:
        poslist = torch.zeros((G, KaP), dtype=torch.int32,
                              device=refbuf.device)
        poslist[:, :LrP] = pos_s
    return ptab.to(torch.int32), poslist


def query_prep(q_rows: torch.Tensor, dsz: torch.Tensor, ptab: torch.Tensor,
               LqP: int, mal: int, msl: int, cnt_cap: int):
    """One dispatch's query-side prep against a group's join.

    q_rows (B, W) packed uint8, dsz (B,) int32, ptab (G, 4^mal) int32 ->
      qbuf     (B, LqP)    uint8  query codes
      cand     (G, B, LqP) int32  ptab entry of the query k-mer at each
                                  position (0 past dsz)
      next_hit (G, B, LqP) int32  next position >= i with candidates and
                                  i < dsz - msl, else dsz
      overflow (G, B)      bool   any candidate count > cnt_cap in the
                                  row (the whole row, as the reference)
    """
    q = dev_unpack3(q_rows, LqP)
    qkm = dev_kmer_stream(q, mal)
    valid = qkm >= 0
    qk = torch.where(valid, qkm, 0).to(torch.int64)
    pk = torch.where(valid[None], ptab[:, qk], 0)            # (G, B, LqP)
    cnt = pk & 127
    overflow = cnt.amax(dim=2) > cnt_cap
    idx = torch.arange(LqP, device=q.device, dtype=torch.int32)
    ds = dsz.to(torch.int32)
    hit = (cnt > 0) & (idx[None] < (ds - msl)[:, None])[None]
    nh_src = torch.where(hit, idx, ds[None, :, None])
    nh = torch.flip(torch.cummin(torch.flip(nh_src, [2]), dim=2).values, [2])
    mask = (idx[None] < ds[:, None])[None]
    cand = torch.where(mask, pk, 0).contiguous()
    next_hit = torch.where(mask, nh, ds[None, :, None]).contiguous()
    return q.to(torch.uint8).contiguous(), cand, next_hit, overflow


def group_kernel_args(idx, q_rows, dsz, LqP: int, cfg, cap: int):
    """(the arguments of ``parse_events`` for the references of the
    ``GroupIndex`` `idx` x the queries `q_rows` ((B, W) uint8, packed 3
    symbols a byte, W >= LqP / 3) of lengths `dsz` ((B,) int32, the mrd
    guard in) at query bucket `LqP` and event cap `cap`, the (G, B) flags
    of rows with an anchor bucket over CNT_CAP)."""
    qbuf, cand, next_hit, overflow = query_prep(
        q_rows, dsz, idx.ptab, LqP, cfg.mal, cfg.msl, CudaAll2All.CNT_CAP)
    return ((idx.refbuf, qbuf, idx.poslist, cand, next_hit, idx.win,
             dsz.contiguous(), idx.nrs, cfg, cap), overflow)


def fold_args(args, ev, nev, overflow):
    """(the (G, B) flags of the pairs without a log, the arguments of
    ``fold_stats``) for a group launch's logs (`args` its
    ``group_kernel_args``, `ev` / `nev` its logs, `overflow` its flags).
    A pair has no log where its query row had an anchor bucket over
    CNT_CAP, nev < 0 or nev is over the cap; it goes to the fold with
    nev = -1 and is parsed natively."""
    refbuf, qbuf, _, _, _, _, dsz, nrs, cfg, cap = args
    skip = overflow | (nev < 0) | (nev > cap)
    return skip, (refbuf, qbuf, ev, torch.where(skip, -1, nev), dsz, nrs,
                  cfg)


# ---- envelope and routing --------------------------------------------------

def device_envelope_reason(params) -> str | None:
    """Why a parameter set falls outside the CUDA kernel's envelope, or
    None when the device path is legal. Derived from the kernel's own
    limits: the WIN table indexes anchor/seed lengths from mal/msl up to
    its saturation bucket SAT, and the extension window needs aw >= 1.
    (The TPU kernel's window-geometry and 7-bit tie-pack limits do not
    exist here: the kernel scans the seed window and LCEs directly.)"""
    cfg = ParseCfg.from_params(params)
    if not (1 <= cfg.mal <= SAT and 1 <= cfg.msl <= SAT):
        return (f"anchor/seed length outside [1, {SAT}] (mal={cfg.mal}, "
                f"msl={cfg.msl}): the WIN arbitration table saturates at "
                f"{SAT}")
    if cfg.aw < 1:
        return f"approx window {cfg.aw} < 1"
    return None


def query_shape(codes, mrd: int):
    """(dszs, LqP): per-sequence query lengths with the mrd N guard, and
    the run's query bucket."""
    slens = (np.asarray(codes.slens, np.int64) if hasattr(codes, "slens")
             else np.array([len(c) for c in codes], np.int64))
    dszs = (slens + mrd).astype(np.int32)
    return dszs, _bucket(int(dszs.max(initial=0)) + 1024)


def _warn(params, msg, level=1):
    """Print `msg` on standard error at verbosity `level` and above."""
    if getattr(params, "verbosity_level", 1) >= level:
        print(msg, file=sys.stderr)


def _entries(device, devices) -> list:
    """A run's device entries: `devices`, [`device`] or the current card."""
    if devices is None:
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("all2all_cuda: no CUDA device")
            device = torch.device("cuda", torch.cuda.current_device())
        devices = [device]
    elif device is not None or not devices:
        raise ValueError("all2all_cuda: give `device` or a non-empty "
                         "`devices`, not both")
    return [torch.device(d) for d in devices]


# ---- resident state --------------------------------------------------------

#: symbols of a group's dummy slot (r = -1): A codes, a zero packed row
DUMMY_SYMS = 16


class _RefSet:
    """What both routes' indexes hold for G references at shared length
    buckets: `refbuf` (G, LrP) uint8 codes, `win` (G, WinP) int32 WIN bit
    words, `nrs` (G,) int32 composite lengths, `win_s` (host seconds of
    ``anchor_tables.win_words``) and `h2d_bytes` (what the build copied
    from the host: the WIN words and the lengths). The references come
    as packed rows already on the device (`qrows`, rows of the query
    matrix, ``CudaAll2All.ref_rows``) and their symbol counts `lens`; the
    buffers are derived from them there (``dev_ref_buffers``; `spans`
    records it as ``dev.refs``) and a subclass builds its join from them
    (``_join``; ``dev.join``)."""

    def __init__(self, qrows: torch.Tensor, lens, params, device,
                 LrP: int | None = None, KaP: int | None = None, spans=OFF):
        cfg = ParseCfg.from_params(params)
        self.G = len(lens)
        nrs = (2 * np.asarray(lens, np.int64) + 3 * cfg.mrd).astype(np.int32)
        mx = int(nrs.max())
        self.LrP = LrP if LrP is not None else _bucket(mx + 1024)
        self.KaP = KaP if KaP is not None else _bucket(mx + 256, lo=1024)
        assert self.LrP >= mx + 1024 and self.KaP >= mx + 256
        t0 = time.perf_counter()
        wfs = win_words(nrs, cfg.mal, cfg.msl, cfg.mrd, cfg.mqd)  # (G, WinP)
        self.win_s = time.perf_counter() - t0
        self.WinP = wfs.shape[1]
        dev = torch.device(device)
        self.win = torch.from_numpy(wfs).to(dev)
        self.nrs = torch.from_numpy(nrs).to(dev)
        self.h2d_bytes = wfs.nbytes + nrs.nbytes
        with spans.stage("dev.refs"):
            self.refbuf = dev_ref_buffers(qrows, lens, cfg.mrd, self.LrP)
        with spans.stage("dev.join"):
            self._join(cfg, spans)

    @classmethod
    def of_codes(cls, codes_list, params, device, **kw):
        """The index of references given as codes (a list of uint8 arrays
        or a ``PackedCodes``): their packed rows laid out as the query
        matrix's (``query_rows``) and copied to `device` (counted in
        `h2d_bytes`)."""
        mrd = ParseCfg.from_params(params).mrd
        dszs, LqP = query_shape(codes_list, mrd)
        rows = torch.from_numpy(query_rows(codes_list, LqP, len(dszs)))
        idx = cls(rows.to(device), dszs - mrd, params, device, **kw)
        idx.h2d_bytes += rows.nbytes
        return idx


class GroupIndex(_RefSet):
    """Device state of a group-route group (counterpart of
    PallasGroupIndex): the buffers and the dense anchor join ``ptab`` /
    ``poslist`` (``group_join``)."""

    def _join(self, cfg, spans):
        self.ptab, self.poslist = group_join(self.refbuf, cfg.mal, self.KaP)


class BigIndex(_RefSet):
    """Device state of G long-genome references at the run's big buckets
    (counterpart of ``build_big_index``): the buffers and the sorted
    join, ``keys`` (G, LrP) int64 sorted k-mer keys and ``poslist`` (G,
    KaP) int32 positions in the same order (``big_ref_join``)."""

    def _join(self, cfg, spans):
        """The sorted join; `spans` records its stages (``big_ref_join``)."""
        self.keys, self.poslist = big_ref_join(self.refbuf, cfg.mal, self.KaP,
                                               spans)


class CudaRefIndex:
    """One reference for the event-log kernel (counterpart of
    ``PallasRefIndex``, pallas_engine.py:1195-1336): a one-reference
    ``GroupIndex``; each query batch is one launch of ``parse_events``
    (G = 1 x B = len(queries)). `device` defaults to the current CUDA
    device; a CPU device runs the kernel's plain version (tests)."""

    #: records per query of the JAX package's buffer; logs of more than
    #: MAXEV - 16 events fall back to the native engine, as there
    MAXEV = 2176

    def __init__(self, codes: np.ndarray, params, device=None):
        self.cfg = ParseCfg.from_params(params)
        self.device = (torch.device(device) if device is not None else
                       torch.device("cuda", torch.cuda.current_device()))
        self.gidx = GroupIndex.of_codes([codes], params, self.device)

    def batch_args(self, queries: list):
        """(arguments of ``parse_events``, (1, B) overflow flags) of one
        batch: a query with an anchor bucket over CNT_CAP is flagged."""
        dsz, LqP = query_shape(queries, self.cfg.mrd)
        rows = query_rows(queries, LqP, len(dsz))
        return self.rows_args(torch.from_numpy(rows).to(self.device),
                              torch.from_numpy(dsz).to(self.device), LqP)

    def rows_args(self, q_rows, dsz, LqP: int):
        """``batch_args`` of query rows already on the device
        (``group_kernel_args``)."""
        return group_kernel_args(self.gidx, q_rows, dsz, LqP, self.cfg,
                                 self.MAXEV - 16)

    def parse_events_batch(self, queries: list) -> list:
        """Event logs of a query batch, one launch: a list of int32 (n, 8)
        arrays, None where the query must be parsed natively (an anchor
        bucket over CNT_CAP, an unfinished parse, more than MAXEV - 16
        events)."""
        args, overflow = self.batch_args(queries)
        return _download_logs(*parse_events(*args), self.MAXEV - 16,
                              overflow)[0]

    def parse_events(self, q_codes: np.ndarray) -> np.ndarray:
        """One query's event log; raises where it falls back."""
        ev = self.parse_events_batch([q_codes])[0]
        if ev is None:
            raise RuntimeError("CudaRefIndex.parse_events: kernel fallback "
                               "(anchor bucket over CNT_CAP or more than "
                               "MAXEV - 16 events)")
        return ev


class CudaAll2All:
    """All-vs-all engine (counterpart of PallasAll2All): one resident query
    matrix per device, each row routed (``paths``) to a device route
    (``routes``) or the native engine, one dispatch per (group, query
    block) of a route."""

    CNT_CAP = 112        # anchor-bucket count above which a row falls back
    EV_CAP = 2048        # events per pair; beyond -> native fallback
    GROUP = 4            # references per dispatch
    MAX_REF_SYMS = 700_000   # composite symbols of a group-path reference
    MAX_Q = 1 << 19          # query bucket of the group path
    MAX_BIG_SYMS = 1 << 25   # composite symbols of a long-genome reference
    #: memory a long-genome launch may take on the CPU (tests); on a card
    #: it is a quarter of the free memory
    CPU_BIG_BUDGET = 1 << 30

    @classmethod
    def row_path(cls, nr: int, all_big: bool) -> str:
        """'group', 'big' or 'native' for a reference row whose composite
        has `nr` symbols (the JAX rule, pallas_engine.py:1494-1522)."""
        if nr <= cls.MAX_REF_SYMS and not all_big:
            return "group"
        return "big" if nr <= cls.MAX_BIG_SYMS else "native"

    @classmethod
    def big_only_reason(cls, LqP: int, mal: int) -> str | None:
        """Why every row of a run takes the long-genome path, or None:
        mal > 13 (no dense 4^mal join table) or a query bucket `LqP` above
        the group path's MAX_Q."""
        if mal > 13:
            return f"min anchor length {mal} > 13 (no dense 4^mal join table)"
        if LqP > cls.MAX_Q:
            return f"query bucket {LqP} exceeds {cls.MAX_Q}"
        return None

    def __init__(self, codes, params, devices=None, shape=None):
        """`shape`, when given, is ``query_shape(codes, mrd)`` already
        worked out by the caller."""
        self.codes = codes
        self.params = params
        self.cfg = cfg = ParseCfg.from_params(params)
        n = len(codes)
        self.devices = [torch.device(d) for d in devices] if devices else \
            [torch.device("cuda", torch.cuda.current_device())]
        self.dszs, self.LqP = (shape if shape is not None
                               else query_shape(codes, cfg.mrd))
        nr_all = 2 * self.dszs.astype(np.int64) + cfg.mrd   # 2L + 3 mrd
        #: every row takes the long-genome path (the query bucket exceeds
        #: the group path's, or no dense 4^mal join table)
        self.all_big = self.big_only_reason(self.LqP, cfg.mal) is not None
        self.paths = [self.row_path(int(v), self.all_big) for v in nr_all]
        nrs = nr_all[[p == "group" for p in self.paths]]
        nr_ok = int(nrs.max()) if len(nrs) else 4096
        self.LrP_ref = _bucket(nr_ok + 1024)
        self.KaP_ref = _bucket(nr_ok + 256, lo=1024)
        nrs = nr_all[[p == "big" for p in self.paths]]
        self.LrP_big = _bucket(int(nrs.max()) + 1024) if len(nrs) else 0
        self.KaP_big = _bucket(self.LrP_big + 256, lo=1024) if len(nrs) else 0
        #: events per long-genome pair (pallas_engine.py:2511)
        self.EV_CAP_BIG = max(self.EV_CAP, self.LqP // 32)
        self.G_big = self.B_big = 0         # set by big_launch_shape
        # queries per dispatch: a dispatch lasts about as long as its
        # slowest pair, so 256 cost little more than the JAX engine's 64
        # (28.17 vs 27.17 ms at G = 4; dispatch_probe.py, NVIDIA H100 80GB
        # HBM3, 700.00 W; PERF.md)
        self.B = min(256, _bucket(n, lo=8))
        n_pad = self.n_pad = -(-n // self.B) * self.B
        qp_padded = query_rows(codes, self.LqP, n_pad)
        dszs_pad = np.full(n_pad, cfg.msl, np.int32)   # padding rows: no-op
        dszs_pad[:n] = self.dszs
        # one copy per distinct device: entries that repeat a device share
        # its read-only query matrix
        self.Q = {d: torch.from_numpy(qp_padded).to(d)
                  for d in dict.fromkeys(self.devices)}
        self.DSZ = {d: torch.from_numpy(dszs_pad).to(d) for d in self.Q}
        #: the device routes by the path names of their rows (``row_path``)
        self.routes = {"group": GroupRoute(self), "big": BigRoute(self)}

    def ref_rows(self, r_list, device):
        """(packed rows (G, W) uint8 on `device`, symbol counts (G,)) of
        the references `r_list` for an index build (``_RefSet``): their
        rows of the query matrix, copied on the device; r = -1 is a dummy
        slot of DUMMY_SYMS A codes (a zero row)."""
        Q = self.Q[torch.device(device)]
        rows = torch.stack([Q[int(r)] if r >= 0 else Q.new_zeros(Q.shape[1])
                            for r in r_list])
        lens = np.array([self.dszs[r] - self.cfg.mrd if r >= 0 else
                         DUMMY_SYMS for r in r_list], np.int64)
        return rows, lens

    def gather_qrows(self, idx, device=None):
        """Packed query rows and lengths of an arbitrary row set (the
        sparse-filter dispatch path)."""
        dev = device or self.devices[0]
        it = torch.as_tensor(np.asarray(idx, np.int64), device=dev)
        return self.Q[dev][it], self.DSZ[dev][it]

    def plan(self, filter_csr=None, share: int = 1) -> Plan:
        """The run's ``plan.Plan``: rows by ``paths``, each device route's
        rows cut by its ``layout`` (the long-genome route's sizes its
        launches for `share` processes, ``big_launch_shape``), in the
        order of ``routes``; logs the routing."""
        cfg, p = self.cfg, self.params
        if self.all_big:
            _warn(p, f"lz-ani-torch: {self.big_only_reason(self.LqP, cfg.mal)}"
                  f"; every row takes the long-genome kernel")
        rows, idle = route_rows(self.paths, filter_csr)
        pl = Plan(rows, idle, {
            name: route.layout(len(rows[name]), share, filter_csr is not None)
            for name, route in self.routes.items() if rows.get(name)},
            self.n_pad)
        for r, _ in pl.native:
            dsz = int(self.dszs[r])
            _warn(p, f"lz-ani-torch: reference {r} ({dsz - cfg.mrd} bp): "
                  f"composite of {2 * dsz + cfg.mrd} symbols exceeds "
                  f"{self.MAX_BIG_SYMS}; row runs on the native engine")
        for name, lay in pl.layouts.items():
            route = self.routes[name]
            _warn(p, f"lz-ani-torch: {route.label}: {len(rows[name])} rows, "
                  f"{lay.G} references x {lay.width} queries per launch, "
                  f"event cap {route.ev_cap}", 2)
        return pl

    # ---- one reference x a query range (pallas_engine.py:2584-2647) -----

    def build_index(self, r: int, device=None) -> GroupIndex:
        """Device index of reference r alone (G = 1, at its own length
        buckets; built on the device)."""
        dev = device or self.devices[0]
        return GroupIndex(*self.ref_rows([r], dev), self.params, dev)

    def dispatch_range(self, r: int, lo: int, device=None, idx=None):
        """Prep + kernel for reference r x the B queries [lo, lo + B): (ev
        (B, EV_CAP + 1, 8), nev (B,), overflow (B,)) on the device, not
        synchronised; `idx` is ``build_index(r)``, made when not given."""
        dev = device or self.devices[0]
        if idx is None:
            idx = self.build_index(r, dev)
        ev, nev, overflow = self.routes["group"].dispatch(idx, [r], lo, dev)
        return ev[0], nev[0], overflow[0]

    def collect(self, handles):
        """Download a ``dispatch_range`` -> B event logs, None where the
        pair must be parsed natively (as ``GroupRoute.collect``)."""
        ev, nev, overflow = handles
        return self.routes["group"].collect(
            (ev[None], nev[None], overflow[None]))[0]

    def run_range(self, r: int, lo: int):
        return self.collect(self.dispatch_range(r, lo))

    # ---- long-genome launches ----------------------------------------------

    def big_launch_shape(self, n_big: int, device=None, share: int = 1):
        """Set and return (G_big, B_big): references and queries per
        long-genome launch (the JAX package caps B_big at 4 for a TPU
        watchdog): the most pairs whose buffers fit a quarter of the free
        memory of `device`, else of the tightest device, split among the
        entries that repeat it and the `share` processes that drive it
        (each reads the free memory at its own start); B_big a power of
        two <= B. A launch lasts about as long as its slowest pair, a
        warp's (the bacterial set's 48 pairs: 1.7 ms of device time;
        dispatch_probe.py --big, NVIDIA H100 80GB HBM3, 700.00 W)."""
        budgets = []
        for dev in dict.fromkeys([torch.device(device)] if device is not None
                                 else self.devices):
            free = (torch.cuda.mem_get_info(dev)[0] // 4
                    if dev.type == "cuda" else self.CPU_BIG_BUDGET)
            budgets.append(free // (max(1, share)
                                    * max(1, self.devices.count(dev))))
        budget = min(budgets)
        LqP, LrP = self.LqP, self.LrP_big
        # candidate planes + next_hit, the event buffer, the pair order
        per_pair = 12 * LqP + 32 * (self.EV_CAP_BIG + 1) + 4
        # codes, keys, search bounds and cummin transients of one query,
        # its bit planes (3 bits a symbol) and length in the kernel's
        # scratch
        per_query = 48 * LqP + 3 * LqP // 8 + 4
        # packed, uint8 and int32 buffers, sorted keys, position list,
        # the bit planes in the kernel's scratch
        per_ref = 13 * LrP + 4 * self.KaP_big + 3 * LrP // 8
        B = self.B
        while B > 1 and B * (per_query + per_pair) + per_ref > budget:
            B //= 2
        G = (budget - B * per_query) // (per_ref + B * per_pair)
        self.G_big, self.B_big = max(1, min(n_big, G)), B
        return self.G_big, self.B_big


class _Route:
    """A device route of ``CudaAll2All`` (``routes``): ``all2all_cuda``
    and the hybrid drive each unit through it. ``layout`` (how its rows
    are cut, ``plan.Layout``), ``build`` (a group's index on a device),
    ``dispatch`` (a unit's prep and launch: the references `r_list` of
    index `idx` x the queries [lo, lo + ``width``) or the gathered rows
    `qidx`; device tensors (ev, nev[, overflow flags]), nothing
    synchronised; `spans` records ``unit.prep`` / ``dev.prep`` and
    ``unit.launch`` / ``dev.kernel``), ``collect`` (the download),
    ``tally`` (its counters), ``finish`` (a drained unit's counters and
    its pairs left to the replay pool), ``replay_threads`` (a unit's
    replay's)."""

    label = pairs_key = fallbacks_key = ""

    def __init__(self, eng: CudaAll2All):
        self.eng = eng

    def collect(self, handles, spans=OFF) -> EventLogs:
        """``EventLogs`` of a dispatch: a pair has no log, and is parsed
        natively, where nev < 0, nev > ``ev_cap`` or its query row had an
        anchor bucket over CNT_CAP (a group dispatch's overflow flags)."""
        ev, nev, *overflow = handles
        return _download_logs(ev, nev, self.ev_cap, *overflow, spans=spans)

    def finish(self, st: dict, got, pairs, out, rejected: list):
        """A drained unit's counters in `st` (``tally``, ``fold_pairs``)
        and the arguments of its ``UnitReplay`` call, or None where no
        pair is left to the pool: `got` the unit's download (``EventLogs``
        or ``FoldedLogs``: ``FoldedLogs.settle`` writes its triples into
        `out`, the run's (slots, 3) triples, and its rejected logs' (r, q)
        into `rejected`), `pairs` the unit's (g, r, q, slot, b) arrays."""
        nev, unit, folded = got.settle(pairs, out, rejected)
        self.tally(st, pairs[1], pairs[2], nev)
        st["fold_pairs"] += folded
        return unit

    def tally(self, st: dict, pr, pq, nev):
        """Count a drained unit's pairs ((r, q) arrays `pr`, `pq`, log
        lengths `nev`) in the stats `st`: those with a log, and those
        without (nev < 0), each logged at -V 2; returns the latter's
        indices."""
        fb = np.flatnonzero(nev < 0)
        for r, q in zip(pr[fb].tolist(), pq[fb].tolist()):
            _warn(self.eng.params, f"lz-ani-torch: pair ({r},{q}) fell back "
                  f"to the native engine (event/anchor capacity)", 2)
        st[self.pairs_key] += len(nev) - len(fb)
        st[self.fallbacks_key] += len(fb)
        return fb


class GroupRoute(_Route):
    """The group route (``_get_group_step``): GROUP references a group,
    the last padded with dummy slots, a ``GroupIndex``, B queries a unit
    (a sparse filter's wanted queries gathered), the group kernel; a
    unit is one of many, replayed on one thread. Where ``fold`` is set
    (``all2all_cuda`` without a region file), a unit's logs are folded on
    its device instead (``fold_stats``) and only the triples come back
    (``FoldedLogs``); a region file needs the factor list, which only the
    host replay gives."""

    label, pairs_key, fallbacks_key = ("group path", "kernel_pairs",
                                       "cap_fallbacks")
    fold = False
    ev_cap = property(lambda self: self.eng.EV_CAP)
    width = property(lambda self: self.eng.B)

    def layout(self, n_rows, share=1, filtered=False) -> Layout:
        return Layout(self.eng.GROUP, self.width, True, filtered)

    def replay_threads(self, nthreads: int) -> int:
        return 1

    def build(self, r_list, device=None, spans=OFF) -> GroupIndex:
        """r == -1 entries are cheap dummy slots."""
        eng = self.eng
        dev = device or eng.devices[0]
        return GroupIndex(*eng.ref_rows(r_list, dev), eng.params, dev,
                          LrP=eng.LrP_ref, KaP=eng.KaP_ref, spans=spans)

    def args(self, idx: GroupIndex, lo, device=None, qrows=None):
        """Prep of a group dispatch: (the arguments of ``parse_events``
        for the references of `idx` x the B queries [lo, lo + B) or the
        pre-gathered `qrows`, the (G, B) overflow flags)."""
        eng, dev = self.eng, device or self.eng.devices[0]
        if qrows is None:
            qrows = (eng.Q[dev][lo:lo + eng.B], eng.DSZ[dev][lo:lo + eng.B])
        return group_kernel_args(idx, *qrows, eng.LqP, eng.cfg, eng.EV_CAP)

    def dispatch(self, idx, r_list, lo, device=None, qidx=None, spans=OFF):
        """`r_list` is unread: `idx` holds the group. With ``fold``, the
        fold runs on the parse's stream right after it (``dev.fold``) and
        the handle is one (G, B, 5) int32 block: each pair's triple, the
        fold's status (0 ok, -1 a log it rejects) and its skip flag (1: no
        log, parsed natively)."""
        qrows = None if qidx is None else self.eng.gather_qrows(qidx, device)
        with spans.span("unit.prep"), spans.stage("dev.prep"):
            args, overflow = self.args(idx, lo, device, qrows)
        with spans.span("unit.launch"):
            with spans.stage("dev.kernel"):
                ev, nev = parse_events(*args)
            if not self.fold:
                return ev, nev, overflow
            skip, fargs = fold_args(args, ev, nev, overflow)
            with spans.stage("dev.fold"):
                stats, status = fold_stats(*fargs)
            return torch.cat([stats, status[..., None],
                              skip[..., None].to(torch.int32)], 2)

    def collect(self, handles, spans=OFF):
        if self.fold:
            return FoldedLogs.download(handles, spans)
        return super().collect(handles, spans)


class BigRoute(_Route):
    """The long-genome route (``_get_big_step``): G_big references a group
    (``big_launch_shape``), a ``BigIndex``, B_big queries a unit
    (contiguous windows under a filter too, as the JAX engine does), the
    long-genome kernel; a unit is a few megabase pairs, replayed while the
    pool has little else to do, its references over every thread. Its
    fallbacks' (r, q) are listed too (``big_fallback_pairs``)."""

    label, pairs_key, fallbacks_key = ("long-genome path", "big_pairs",
                                       "big_cap_fallbacks")
    ev_cap = property(lambda self: self.eng.EV_CAP_BIG)
    width = property(lambda self: self.eng.B_big)

    def layout(self, n_rows, share=1, filtered=False) -> Layout:
        G, B = self.eng.big_launch_shape(n_rows, share=share)
        return Layout(G, B, False, False)

    def replay_threads(self, nthreads: int) -> int:
        return nthreads

    def tally(self, st, pr, pq, nev):
        fb = super().tally(st, pr, pq, nev)
        st["big_fallback_pairs"] += np.stack([pr[fb], pq[fb]], 1).tolist()
        return fb

    def build(self, r_list, device=None, spans=OFF) -> BigIndex:
        eng = self.eng
        dev = device or eng.devices[0]
        return BigIndex(*eng.ref_rows(r_list, dev), eng.params, dev,
                        LrP=eng.LrP_big, KaP=eng.KaP_big, spans=spans)

    def args(self, idx: BigIndex, r_list, lo, device=None, spans=OFF):
        """Prep of a long-genome dispatch: the arguments of
        ``parse_events_big`` for the references `r_list` of `idx` x the
        B_big queries [lo, lo + B_big). The self pair gets dsz = msl, so a
        megabase self-parse never runs (pallas_engine.py:1888-1891), as do
        padding rows. `spans` records the prep's stages
        (``big_query_prep``)."""
        eng = self.eng
        dev = device or eng.devices[0]
        cfg, B = eng.cfg, eng.B_big
        q = dev_unpack3(eng.Q[dev][lo:lo + B], eng.LqP)
        rows = torch.arange(lo, lo + B, device=dev)
        refs = torch.as_tensor(list(r_list), device=dev)
        dsz = torch.where(rows[None] == refs[:, None], cfg.msl,
                          eng.DSZ[dev][lo:lo + B][None]).to(torch.int32)
        cand, next_hit = big_query_prep(q, dsz, idx.keys, cfg.mal, cfg.msl,
                                        spans)
        return (idx.refbuf, q.to(torch.uint8).contiguous(), idx.poslist,
                cand, next_hit, idx.win, dsz.contiguous(), idx.nrs, cfg,
                eng.EV_CAP_BIG)

    def dispatch(self, idx, r_list, lo, device=None, qidx=None, spans=OFF):
        """`qidx` is None: the route's units are windows."""
        with spans.span("unit.prep"), spans.stage("dev.prep"):
            args = self.args(idx, r_list, lo, device, spans)
        with spans.span("unit.launch"), spans.stage("dev.kernel"):
            return parse_events_big(*args)


class EventLogs:
    """A downloaded dispatch's event logs, compacted: `ev` (N, 8) int32,
    the kept logs' records back to back; `nev` (G, B) int32 log lengths,
    -1 for a pair without a log (parsed natively); `off` (G, B) int64,
    each log's first record in `ev`; `sync_s`, the host seconds the
    download waited for the device. ``logs[g][b]``: a log or None."""

    __slots__ = ("ev", "nev", "off", "sync_s")

    def __init__(self, ev: np.ndarray, nev: np.ndarray, off: np.ndarray,
                 sync_s: float = 0.0):
        self.ev, self.nev, self.off, self.sync_s = ev, nev, off, sync_s

    def __len__(self):
        return len(self.nev)

    def __getitem__(self, g):
        return [None if k < 0 else self.ev[o:o + k] for k, o in
                zip(self.nev[g].tolist(), self.off[g].tolist())]

    def offsets(self, g, b):
        """First record of pair (g, b)'s log in `ev`."""
        return self.off[g, b]

    def settle(self, pairs, out, rejected):
        """(the log lengths of a unit's `pairs`, -1 without a log; the
        arguments of its ``UnitReplay`` call: every pair, its log replayed
        or, without one, parsed natively; 0 pairs folded)."""
        pg, pr, pq, pslot, pb = pairs
        nev = self.nev[pg, pb]
        return nev, (pr, pq, pslot, nev, self.off[pg, pb], self.ev), 0


def _download_logs(ev, nev, cap, overflow=None, spans=OFF) -> EventLogs:
    """``EventLogs`` of a dispatch's (ev, nev): a pair keeps its first nev
    records, and has no log where nev < 0, nev > cap or `overflow[g, b]`
    is set. The kept records are gathered densely on the device first, so
    the copy moves the kept logs' lengths, not G x B times the longest.
    `spans` splits the sync: on a card the wait for the unit's own kernel
    (``unit.sync_own``), then for the work queued after it
    (``unit.sync_ahead``; all of it on the CPU); and records the gather
    (``dev.compact``) and the host's gather and copy (``unit.copy``)."""
    G, B, width = ev.shape[:3]
    keep = (nev >= 0) & (nev <= cap)
    if overflow is not None:
        keep &= ~overflow.to(torch.bool)
    t0 = time.perf_counter()
    t_own = spans.wait_own(t0)
    nev_h = torch.where(keep, nev, -1).to(torch.int32).cpu().numpy()
    t1 = time.perf_counter()
    spans.host("unit.sync_ahead", t_own, t1)
    lens = np.maximum(nev_h, 0).reshape(-1).astype(np.int64)
    off = np.cumsum(lens) - lens
    total = int(lens.sum())
    if total == 0:
        spans.host("unit.copy", t1)
        return EventLogs(np.zeros((0, 8), np.int32), nev_h,
                         off.reshape(G, B), t1 - t0)
    dev = ev.device
    with spans.stage("dev.compact"):
        lens_d = torch.from_numpy(lens).to(dev)
        pair = torch.repeat_interleave(torch.arange(G * B, device=dev),
                                       lens_d, output_size=total)
        rec = (torch.arange(total, device=dev)
               - torch.from_numpy(off).to(dev)[pair])
        block = ev.reshape(G * B * width, 8)[pair * width + rec]
    block = block.cpu().numpy()
    spans.host("unit.copy", t1)
    return EventLogs(block, nev_h, off.reshape(G, B), t1 - t0)


class FoldedLogs:
    """A downloaded dispatch whose logs were folded on the device: `block`
    (G, B, 5) int32, each pair's triple, the fold's status and its skip
    flag (``GroupRoute.dispatch``); `sync_s`, the host seconds the
    download waited for the device."""

    __slots__ = ("block", "sync_s")

    def __init__(self, block: np.ndarray, sync_s: float = 0.0):
        self.block, self.sync_s = block, sync_s

    @classmethod
    def download(cls, block, spans=OFF) -> FoldedLogs:
        """One copy of the device's `block`. `spans` records the wait for
        the unit's own kernels (``unit.sync_own``, on a card), the copy
        with the wait for the work queued after them (``unit.sync_ahead``)
        and the host's part (``unit.copy``)."""
        t0 = time.perf_counter()
        t_own = spans.wait_own(t0)
        out = block.cpu().numpy()
        t1 = time.perf_counter()
        spans.host("unit.sync_ahead", t_own, t1)
        spans.host("unit.copy", t1)
        return cls(out, t1 - t0)

    def settle(self, pairs, out, rejected):
        """Writes the folded triples of a unit's `pairs` into `out` at
        their slots and appends the (r, q) of the logs the fold rejected
        (status -1: a replay mismatch, not repaired) to `rejected`;
        returns (-1 for each pair without a log, else 0; the arguments of
        the ``UnitReplay`` call that parses those pairs natively, or None
        where there are none; the pairs folded)."""
        pg, pr, pq, pslot, pb = pairs
        got = self.block[pg, pb]
        skip = got[:, 4] != 0
        ok, bad = ~skip & (got[:, 3] == 0), ~skip & (got[:, 3] != 0)
        out[pslot[ok]] = got[ok, :3]
        rejected.extend(zip(pr[bad].tolist(), pq[bad].tolist()))
        nev = np.where(skip, -1, 0).astype(np.int32)
        fb = np.flatnonzero(skip)
        unit = (pr[fb], pq[fb], pslot[fb], nev[fb],
                np.zeros(len(fb), np.int64)) if len(fb) else None
        return nev, unit, int(ok.sum())


# ---- all-vs-all ------------------------------------------------------------

def all2all_cuda(codes, params, filter_csr=None, progress=None,
                 replay_threads: int = 0, region_path: str | None = None,
                 device=None, stats: dict | None = None, devices=None,
                 card_share: int = 1):
    """All-vs-all triples through the CUDA engine, laid out as
    ``native_engine.all2all``'s. `device`: the current CUDA device by
    default, a CPU device runs the plain versions (tests); or `devices`,
    entries (repeats allowed) that units go round-robin over, two in
    flight and one live index each. `card_share` processes drive the
    card (``big_launch_shape``). Each downloaded unit is replayed by one
    native call on a pool of `replay_threads` (all cores but one), but a
    group unit of a run without `region_path`: its logs are folded on the
    device (``GroupRoute.fold``), its triples downloaded and written here,
    and only its pairs without a log go to the pool, parsed natively.

    `stats` receives kernel_pairs / big_pairs (pairs parsed from a
    group / long-genome log, folded or replayed), fold_pairs (of
    kernel_pairs, the triples folded on the device), cap_fallbacks /
    big_cap_fallbacks (pairs
    without a log: over EV_CAP / EV_CAP_BIG events, or an anchor bucket
    over CNT_CAP in the row) and big_fallback_pairs (their (r, q)),
    native_rows / native_row_pairs, big_rows, G_big / B_big (a
    long-genome launch), replay_mismatches, dispatches, launches /
    big_launches, device_units (per entry), index_h2d_bytes (what the
    index builds copied from the host), and host clocks: setup_s
    (entry to the first dispatch), dispatch_s (index builds, dispatches)
    and of it win_s (WIN words), download_s and of it download_sync_s
    (the wait for the device, on one stream the next unit's prep and
    kernel too), replay_tail_s (the pool after the last download),
    replay_c_s (inside the replay calls, over threads), replay_wall_s
    (first replay submitted to last finished), replay_pairs; while a torch
    profiler records at entry, ``spans`` (``ops/spans.py``, PERF.md section 3:
    ``engine.*``, each unit's ``unit.*`` and, on a card, ``dev.*``).

    Raises RuntimeError after the run when a kernel log failed the
    cross-check of the replay or of the fold (a wrong stream; those pairs
    are not written).
    """
    from . import parse_kernel

    t_entry = time.perf_counter()
    sp = Spans() if requested() else None
    n = len(codes)
    launches0 = parse_kernel.parse_events.launches
    big_launches0 = parse_kernel.parse_events_big.launches
    st = dict(kernel_pairs=0, fold_pairs=0, cap_fallbacks=0, big_pairs=0,
              big_cap_fallbacks=0, big_fallback_pairs=[], native_rows=0,
              native_row_pairs=0, big_rows=0, G_big=0, B_big=0,
              replay_mismatches=0, dispatches=0, launches=0, big_launches=0,
              device_units=[], index_h2d_bytes=0, setup_s=0.0,
              dispatch_s=0.0, win_s=0.0,
              download_s=0.0, download_sync_s=0.0, replay_tail_s=0.0,
              replay_c_s=0.0, replay_wall_s=0.0, replay_pairs=0)
    if sp is not None:
        st["spans"] = sp.spans
    if stats is not None:
        stats.update(st)

    reason = device_envelope_reason(params)
    if reason is not None:
        _warn(params, f"lz-ani-torch: parameters outside the CUDA kernel "
              f"envelope ({reason}); this run uses the native engine "
              f"(byte-identical output)")
        out = native_engine.all2all(codes, params, filter_csr=filter_csr,
                                    region_path=region_path)
        if stats is not None:
            stats.update(native_rows=n, native_row_pairs=int(
                n * (n - 1) if filter_csr is None else len(filter_csr[1])))
        return out

    devices = _entries(device, devices)
    st["device_units"] = [0] * len(devices)
    out = np.zeros((n, max(n - 1, 0), 3) if filter_csr is None
                   else (len(filter_csr[1]), 3), dtype=np.int32)
    pl, eng = Plan({}, 0, {}, 0), None      # no rows: no engine, no plan
    if n:
        eng = CudaAll2All(codes, params, devices=devices, shape=query_shape(
            codes, ParseCfg.from_params(params).mrd))
        # regions need the factor list: only the host replay gives it
        eng.routes["group"].fold = region_path is None
        pl = eng.plan(filter_csr, card_share)
        st.update(big_rows=len(pl.rows.get("big", ())), G_big=eng.G_big,
                  B_big=eng.B_big)

    nthreads = replay_threads or max(2, (os.cpu_count() or 2) - 1)
    rf = open(region_path, "wb") if region_path else None
    done = [0, pl.seqs_done]        # pairs drained, rows done (Sequences%)
    rejected = []                   # (r, q) of the logs the fold rejected
    try:
        rep = UnitReplay(codes, params, out, rf)
        with ThreadPoolExecutor(max_workers=nthreads) as pool:
            # native rows first: the pool works on them while the device
            # runs the kernel units
            futs = [pool.submit(rep.parse_row, r, *w) for r, w in pl.native]
            st["native_rows"] = len(pl.native)
            st["native_row_pairs"] = sum(len(w[0]) for _, w in pl.native)

            def drain(unit, route, handles, us):
                t0 = time.perf_counter()
                got = route.collect(handles, us)
                st["download_s"] += time.perf_counter() - t0
                st["download_sync_s"] += got.sync_s
                us.resolve()
                left = route.finish(st, got, unit.pairs, rep.out, rejected)
                if left is not None:
                    futs.append(rep.submit(
                        pool, *left, threads=route.replay_threads(nthreads),
                        queued=us.queue, replayed=us.replay))
                done[0] += len(unit.pairs[1])
                done[1] += pl.drained(unit.group)
                if progress is not None:
                    progress(done[0], pl.total_pairs, done[1], n)

            # depth-2 pipeline per device entry: unit k + len(devices) is
            # queued before unit k's logs are downloaded and handed to the
            # replay pool. Each entry keeps one live index (a group's units
            # are consecutive)
            inflight = []
            live = {}    # entry -> (group, its index on the entry's device)
            t_loop = time.perf_counter()
            st["setup_s"] = t_loop - t_entry
            if sp is not None:
                sp.host("engine.setup", None, t_entry, t_loop)
                sp.anchor(devices)
            for k, unit in enumerate(pl.units):
                grp, e = pl.groups[unit.group], k % len(devices)
                route = eng.routes[grp.route]
                t0 = time.perf_counter()
                us = OFF if sp is None else UnitSpans(sp, k, devices[e])
                if live.get(e, (None,))[0] != unit.group:
                    live.pop(e, None)    # freed once `idx` moves on
                    live[e] = (unit.group,
                               route.build(grp.r_list, devices[e], us))
                    us.host("unit.index", t0)
                    st["win_s"] += live[e][1].win_s
                    st["index_h2d_bytes"] += live[e][1].h2d_bytes
                idx = live[e][1]
                handles = route.dispatch(idx, grp.r_list, unit.lo, devices[e],
                                         unit.qidx, us)
                st["dispatch_s"] += time.perf_counter() - t0
                st["dispatches"] += 1
                st["device_units"][e] += 1
                inflight.append((unit, route, handles, us))
                if len(inflight) >= 2 * len(devices):
                    drain(*inflight.pop(0))
            while inflight:
                drain(*inflight.pop(0))
            t0 = time.perf_counter()
            for f in futs:
                f.result()
            t1 = time.perf_counter()
            st["replay_tail_s"] = t1 - t0
            if sp is not None:
                sp.host("engine.loop", None, t_loop, t0)
                sp.host("engine.replay_tail", None, t0, t1)
        if progress is not None:
            progress(pl.total_pairs, pl.total_pairs, n, n)
    finally:
        if rf is not None:
            rf.close()

    mismatched = rep.mismatched + rejected
    st.update(replay_mismatches=len(mismatched),
              replay_c_s=rep.c_s, replay_wall_s=rep.wall_s,
              replay_pairs=rep.pairs,
              launches=parse_kernel.parse_events.launches - launches0,
              big_launches=(parse_kernel.parse_events_big.launches
                            - big_launches0))
    fallbacks = st["cap_fallbacks"] + st["big_cap_fallbacks"]
    if fallbacks:
        _warn(params, f"lz-ani-torch: {fallbacks}/{pl.total_pairs} pairs fell "
              f"back to the native engine (event-buffer or anchor-bucket "
              f"capacity)")
    if stats is not None:
        stats.update(st)
    if st["replay_mismatches"]:
        raise RuntimeError(
            f"lz-ani-torch: {st['replay_mismatches']} kernel event logs "
            f"failed the replay cross-check (first pairs (r, q): "
            f"{mismatched[:5]}); the kernel's output is wrong")
    return out
