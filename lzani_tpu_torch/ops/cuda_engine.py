"""All-vs-all device engine of the port: resident state, plain-torch prep
and the group and long-genome dispatches around the CUDA event-log parse
kernels.

Counterpart of the group and long-genome paths of
``lzani_tpu/ops/pallas_engine.py`` (``PallasAll2All``,
``PallasGroupIndex``, ``_get_group_step``, ``build_big_index``,
``dispatch_big``, ``collect_big``, ``all2all_pallas``). Per run, the
query matrix is packed 3 symbols per byte and kept resident on the
device with a length table. Per group of G = 4 references, the packed
composite buffers, WIN bit tables and lengths are uploaded once, and the
11-mer join (a stable sort plus counts, giving ``ptab = start << 7 |
min(count, 127)`` and ``poslist``) is built once on the device. Each
dispatch covers G references x B queries: it unpacks the queries,
gathers their anchor candidates, flags rows whose candidate count
exceeds CNT_CAP, computes ``next_hit`` by a reverse cummin, and launches
the parse kernel. The event logs come back
to the host compacted (``EventLogs``: the kept records back to back),
and each unit's logs are replayed by one native call on a thread pool
(``finalize.UnitReplay``).

Rows whose composite reference exceeds MAX_REF_SYMS, and every row when
the query bucket exceeds MAX_Q or mal > 13 (no dense 4^mal table), take
the long-genome path instead: per group of G_big references a
``BigIndex`` holds the sorted two-word-key join (``big.py``), and each
dispatch of G_big references x B_big queries builds a two-plane
candidate table with unbounded counts and launches the big kernel. Only
rows above MAX_BIG_SYMS run on the native engine.

The per-reference API of the JAX package runs on the group kernel too,
as groups of G = 1 with the join and the prep on the device:
``CudaRefIndex`` (``PallasRefIndex``: one reference x a batch of query
sequences) and ``CudaAll2All.dispatch_range`` / ``collect`` /
``run_range`` (one reference x B queries of the engine).

Everything here is plain PyTorch on an explicit ``torch.device``; the
only kernels written by hand are ``parse_kernel.parse_events`` and
``parse_kernel.parse_events_big``.
"""

from __future__ import annotations

import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..core import native_engine
from .anchor_tables import SAT, win_words
from .big import big_query_prep, big_ref_join
from .finalize import NO_PAIRS, UnitReplay, row_wanted, unit_pairs
from .parse import ParseCfg
from .parse_kernel import parse_events, parse_events_big
from .prep import SYM_N_REF, SYM_N_SEQ, query_buffer_np, ref_buffer_np
from .spans import OFF, Spans, UnitSpans, requested


# ---------------------------------------------------------------------------
# host helpers (numpy; copies of pallas_engine.py:214-249, 1059-1068)
# ---------------------------------------------------------------------------

def _pad128(n):
    return -(-n // 128) * 128


def _bucket(n, lo=4096):
    """Power-of-two shape bucket."""
    b = lo
    while b < n:
        b *= 2
    return b


def pack3_rows(codes: np.ndarray) -> np.ndarray:
    """(R, L) uint8 codes (values 0..5) -> (R, ceil(L/3)) radix-216 bytes
    (the io/packing.py three-in-byte layout, row-wise)."""
    R, L = codes.shape
    Lp = -(-L // 3)
    c = np.zeros((R, Lp * 3), np.uint8)
    c[:, :L] = codes
    c = c.reshape(R, Lp, 3)
    out = c[:, :, 0] * np.uint8(36)       # at most 5 * 43 = 215: no wrap
    out += c[:, :, 1] * np.uint8(6)
    out += c[:, :, 2]
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


# ---------------------------------------------------------------------------
# device prep (plain torch; pallas_engine.py:228-235, 1783-1795, 2094-2145)
# ---------------------------------------------------------------------------

def dev_unpack3(packed: torch.Tensor, L: int) -> torch.Tensor:
    """(R, Lp) radix-216 uint8 bytes -> (R, L) int32 codes."""
    p = packed.to(torch.int32)
    out = torch.stack([p // 36, (p // 6) % 6, p % 6], dim=-1)
    return out.reshape(p.shape[0], -1)[:, :L]


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


# ---------------------------------------------------------------------------
# envelope and routing
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# resident state
# ---------------------------------------------------------------------------

class GroupIndex:
    """Device state of a group of G references sharing the run-wide shape
    buckets (counterpart of PallasGroupIndex): packed composite buffers,
    WIN bit tables, composite lengths, plus the unpacked buffers and the
    anchor join, built once on the device. `spans` (``spans.UnitSpans``)
    records the join's device time as ``dev.join``; ``win_s`` holds the
    host seconds the WIN words took (``anchor_tables.win_words``)."""

    def __init__(self, codes_list, params, device, LrP: int | None = None,
                 KaP: int | None = None, spans=OFF):
        cfg = ParseCfg.from_params(params)
        G = self.G = len(codes_list)
        rbs = [ref_buffer_np(c, cfg.mrd) for c in codes_list]
        nrs = np.array([len(rb) for rb in rbs], np.int32)
        mx = int(nrs.max())
        self.LrP = LrP if LrP is not None else _bucket(mx + 1024)
        self.KaP = KaP if KaP is not None else _bucket(mx + 256, lo=1024)
        assert self.LrP >= mx + 1024 and self.KaP >= mx + 256
        bufs = np.full((G, self.LrP), SYM_N_REF, np.uint8)
        for g, rb in enumerate(rbs):
            bufs[g, :len(rb)] = rb
        t0 = time.perf_counter()
        wfs = win_words(nrs, cfg.mal, cfg.msl, cfg.mrd, cfg.mqd)  # (G, WinP)
        self.win_s = time.perf_counter() - t0
        self.WinP = wfs.shape[1]
        dev = torch.device(device)
        self.win = torch.from_numpy(wfs).to(dev)
        self.nrs = torch.from_numpy(nrs).to(dev)
        refbuf = self._upload(bufs, dev)
        with spans.stage("dev.join"):
            self._join(refbuf, cfg)

    def _upload(self, bufs, dev):
        """Upload the (G, LrP) uint8 buffers in the packed transfer form
        (``refbuf_p``) and unpack them on the device; returns the codes
        the join reads."""
        rbp = pack3_rows(bufs)
        rbp_padded = np.zeros((self.G, _pad128(rbp.shape[1])), np.uint8)
        rbp_padded[:, :rbp.shape[1]] = rbp
        self.refbuf_p = torch.from_numpy(rbp_padded).to(dev)
        refbuf = dev_unpack3(self.refbuf_p, self.LrP)
        self.refbuf = refbuf.to(torch.uint8).contiguous()
        return refbuf

    def _join(self, refbuf, cfg):
        self.ptab, self.poslist = group_join(refbuf, cfg.mal, self.KaP)


class BigIndex(GroupIndex):
    """Device state of G long-genome references at the run's big buckets
    (counterpart of ``build_big_index``): the buffers, WIN tables and
    lengths of ``GroupIndex``, with the sorted join in place of the dense
    table: ``keys`` (G, LrP) int64 sorted k-mer keys and ``poslist``
    (G, KaP) int32 positions in the same order."""

    def _upload(self, bufs, dev):
        """The buffers go up as they are (no ``refbuf_p``): at megabase
        sizes packing them on the host costs more than the transfer it
        saves."""
        self.refbuf = torch.from_numpy(bufs).to(dev)
        return self.refbuf

    def _join(self, refbuf, cfg):
        self.keys, self.poslist = big_ref_join(refbuf, cfg.mal, self.KaP)


class CudaRefIndex:
    """One reference for the event-log kernel (counterpart of
    ``PallasRefIndex``, pallas_engine.py:1195-1336): a one-reference
    ``GroupIndex`` (buffer, WIN table, the join built on the device); each
    query batch goes through ``query_prep`` and one launch of
    ``parse_events`` (G = 1 reference x B = len(queries)). `device`
    defaults to the current CUDA device; a CPU device runs the kernel's
    plain version (tests)."""

    #: records per query of the JAX package's buffer; logs of more than
    #: MAXEV - 16 events fall back to the native engine, as there
    MAXEV = 2176

    def __init__(self, codes: np.ndarray, params, device=None):
        self.cfg = ParseCfg.from_params(params)
        self.device = (torch.device(device) if device is not None else
                       torch.device("cuda", torch.cuda.current_device()))
        self.gidx = GroupIndex([codes], params, self.device)

    def batch_args(self, queries: list):
        """(arguments of ``parse_events``, (1, B) overflow flags) of one
        batch: a query with an anchor bucket over CNT_CAP is flagged."""
        qbs = [query_buffer_np(q, self.cfg.mrd) for q in queries]
        dsz = np.array([len(qb) for qb in qbs], np.int32)
        LqP = _bucket(int(dsz.max()) + 1024)
        rows = np.full((len(qbs), LqP), SYM_N_SEQ, np.uint8)
        for b, qb in enumerate(qbs):
            rows[b, :len(qb)] = qb
        return self.rows_args(torch.from_numpy(pack3_rows(rows)).to(
            self.device), torch.from_numpy(dsz).to(self.device), LqP)

    def rows_args(self, q_rows, dsz, LqP: int):
        """``batch_args`` of query rows already on the device: (B, W)
        uint8 rows packed 3 symbols per byte (``pack3_rows``, W >= LqP / 3)
        and their (B,) int32 lengths with the mrd guard, at query bucket
        `LqP`."""
        cfg, gi = self.cfg, self.gidx
        qbuf, cand, next_hit, overflow = query_prep(
            q_rows, dsz, gi.ptab, LqP, cfg.mal, cfg.msl, CudaAll2All.CNT_CAP)
        return ((gi.refbuf, qbuf, gi.poslist, cand, next_hit, gi.win,
                 dsz.contiguous(), gi.nrs, cfg, self.MAXEV - 16), overflow)

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


def state_from_jax(q_packed, dsz, refbuf_p, win, nrs, device, big=None):
    """Carry the JAX engine's resident state over: numpy copies of
    ``PallasAll2All.Q`` / ``.DSZ`` (one device's entries) and
    ``PallasGroupIndex.refbuf_p`` / ``.win`` / ``.nrs`` become the port's
    ``CudaAll2All.Q`` / ``.DSZ`` and ``GroupIndex`` tensors on `device`
    (same layouts, byte for byte).

    `big`, when given, is a list of ``PallasAll2All.build_big_index``
    results as numpy arrays, one per reference: dicts with ``refbuf``
    (1, LrP) int32, ``khi`` / ``klo`` (LrP,) int32 sorted key words,
    ``pos`` (1, KaP) int32, ``win`` (1, WinP) int32 (its
    ``gidx.win``) and ``nr``. They become one ``BigIndex`` under
    ``"big"``: the key ``khi << 30 | klo`` (the JAX join's invalid
    entry, khi = 2^30 and klo = 0, is the port's KEY_INVALID)."""
    dev = torch.device(device)

    def put(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)

    state = {"Q": put(q_packed, np.uint8), "DSZ": put(dsz, np.int32),
             "refbuf_p": put(refbuf_p, np.uint8), "win": put(win, np.int32),
             "nrs": put(nrs, np.int32)}
    if big:
        bidx = BigIndex.__new__(BigIndex)
        bidx.G = len(big)
        bidx.refbuf = put(np.concatenate([d["refbuf"] for d in big]),
                          np.uint8)
        bidx.LrP = bidx.refbuf.shape[1]
        keys = np.stack([(np.asarray(d["khi"], np.int64) << 30)
                         | np.asarray(d["klo"], np.int64) for d in big])
        bidx.keys = put(keys, np.int64)
        bidx.poslist = put(np.concatenate([d["pos"] for d in big]), np.int32)
        bidx.KaP = bidx.poslist.shape[1]
        bidx.win = put(np.concatenate([d["win"] for d in big]), np.int32)
        bidx.WinP = bidx.win.shape[1]
        bidx.nrs = put([d["nr"] for d in big], np.int32)
        state["big"] = bidx
    return state


class CudaAll2All:
    """All-vs-all group engine (counterpart of PallasAll2All, group path):
    one resident query matrix per device, one dispatch per (group, query
    block). Work units are independent; with several devices they are
    round-robined (``device_for``)."""

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
        # queries per dispatch. One warp per pair: a dispatch lasts about
        # as long as its slowest pair, so 256 queries (1024 pairs) cost
        # little more per launch than the JAX engine's 64: 28.17 vs 27.17
        # ms at G = 4 on chip_smoke.py's 256-genome set, whose heaviest
        # pair alone takes 25.7-26.3 ms (dispatch_probe.py; NVIDIA H100
        # 80GB HBM3, 700.00 W; PERF.md)
        self.B = min(256, _bucket(n, lo=8))
        n_pad = -(-n // self.B) * self.B
        qb = np.full((n_pad, self.LqP), SYM_N_SEQ, np.uint8)
        for i, c in enumerate(codes):
            qb[i, :self.dszs[i]] = query_buffer_np(c, cfg.mrd)
        self.n_pad = n_pad
        qp = pack3_rows(qb)
        qp_padded = np.zeros((n_pad, _pad128(qp.shape[1])), np.uint8)
        qp_padded[:, :qp.shape[1]] = qp
        dszs_pad = np.full(n_pad, cfg.msl, np.int32)   # padding rows: no-op
        dszs_pad[:n] = self.dszs
        # one copy per distinct device: entries that repeat a device share
        # its read-only query matrix
        self.Q = {d: torch.from_numpy(qp_padded).to(d)
                  for d in dict.fromkeys(self.devices)}
        self.DSZ = {d: torch.from_numpy(dszs_pad).to(d) for d in self.Q}

    def device_for(self, k: int):
        """Device of work unit k: entry k % len(devices) (round-robin)."""
        return self.devices[k % len(self.devices)]

    def build_group_index(self, r_list, device=None,
                          spans=OFF) -> GroupIndex:
        """Device index of a reference group; r == -1 entries are cheap
        dummy slots that pad the final group to G."""
        dummy = np.zeros(16, np.uint8)
        return GroupIndex([self.codes[r] if r >= 0 else dummy
                           for r in r_list], self.params,
                          device or self.devices[0],
                          LrP=self.LrP_ref, KaP=self.KaP_ref, spans=spans)

    def gather_qrows(self, idx, device=None):
        """Packed query rows and lengths of an arbitrary row set (the
        sparse-filter dispatch path)."""
        dev = device or self.devices[0]
        it = torch.as_tensor(np.asarray(idx, np.int64), device=dev)
        return self.Q[dev][it], self.DSZ[dev][it]

    def group_args(self, gidx: GroupIndex, lo, device=None, qrows=None):
        """Prep of a group dispatch: (the arguments of ``parse_events``
        for the references of `gidx` x the B queries [lo, lo + B) or the
        pre-gathered `qrows`, the (G, B) overflow flags)."""
        dev = device or self.devices[0]
        cfg, B = self.cfg, self.B
        if qrows is None:
            qrows = (self.Q[dev][lo:lo + B], self.DSZ[dev][lo:lo + B])
        q_rows, dsz_b = qrows
        qbuf, cand, next_hit, overflow = query_prep(
            q_rows, dsz_b, gidx.ptab, self.LqP, cfg.mal, cfg.msl,
            self.CNT_CAP)
        return ((gidx.refbuf, qbuf, gidx.poslist, cand, next_hit, gidx.win,
                 dsz_b.contiguous(), gidx.nrs, cfg, self.EV_CAP), overflow)

    def dispatch_group(self, gidx: GroupIndex, lo, device=None, qrows=None,
                       spans=OFF):
        """Prep + kernel (``group_args``). Returns device tensors (ev, nev,
        overflow); nothing is synchronised. `spans` records the prep and
        the launch (``unit.prep`` / ``dev.prep``, ``unit.launch`` /
        ``dev.kernel``)."""
        with spans.span("unit.prep"), spans.stage("dev.prep"):
            args, overflow = self.group_args(gidx, lo, device, qrows)
        with spans.span("unit.launch"), spans.stage("dev.kernel"):
            return (*parse_events(*args), overflow)

    def collect_group(self, handles, spans=OFF):
        """Download a dispatch -> out[g][b]: an (n, 8) int32 event log, or
        None where the pair must be parsed natively (nev < 0, nev >
        EV_CAP, or an anchor bucket over CNT_CAP in the query row)."""
        ev, nev, overflow = handles
        return _download_logs(ev, nev, self.EV_CAP, overflow, spans)

    # ---- one reference x a query range (pallas_engine.py:2584-2647) -----

    def build_index(self, r: int, device=None) -> GroupIndex:
        """Device index of reference r alone (G = 1, at its own length
        buckets; the join is built on the device)."""
        return GroupIndex([self.codes[r]], self.params,
                          device or self.devices[0])

    def dispatch_range(self, r: int, lo: int, device=None, idx=None):
        """Prep + kernel for reference r x the B queries [lo, lo + B):
        device tensors (ev (B, EV_CAP + 1, 8), nev (B,), overflow (B,));
        nothing is synchronised. `idx` is ``build_index(r)``, made here
        when not given."""
        dev = device or self.devices[0]
        if idx is None:
            idx = self.build_index(r, dev)
        ev, nev, overflow = self.dispatch_group(idx, lo, dev)
        return ev[0], nev[0], overflow[0]

    def collect(self, handles):
        """Download a ``dispatch_range`` -> B event logs, None where the
        pair must be parsed natively (as ``collect_group``)."""
        ev, nev, overflow = handles
        return self.collect_group((ev[None], nev[None], overflow[None]))[0]

    def run_range(self, r: int, lo: int):
        return self.collect(self.dispatch_range(r, lo))

    # ---- long-genome path ----------------------------------------------

    def big_launch_shape(self, n_big: int, device=None, share: int = 1):
        """Set and return (G_big, B_big): references and queries per
        long-genome launch. The JAX package caps B_big at 4 to guard a TPU
        watchdog; here both come from memory: the most pairs whose buffers
        fit a quarter of the card's free memory (each entry keeps two
        launches in flight), B_big a power of two <= B. Each pair is a
        warp of its own, so a launch lasts about as long as its slowest
        pair, and more pairs per launch cost little until the warps
        outnumber what the SMs hold at once (the bacterial set's 48 pairs:
        one launch of 1.7 ms of device time; dispatch_probe.py --big,
        NVIDIA H100 80GB HBM3, 700.00 W).

        Sized for `device`, or else for the tightest of the engine's
        devices. A device's quarter is split among the entries that
        repeat it and the `share` processes that drive it (each process
        reads the free memory at its own start, so without the split two
        processes on one card would each size for the whole of it)."""
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

    def build_big_index(self, r_list, device=None, spans=OFF) -> BigIndex:
        """Device index of a group of long-genome references (any G)."""
        return BigIndex([self.codes[r] for r in r_list], self.params,
                        device or self.devices[0], LrP=self.LrP_big,
                        KaP=self.KaP_big, spans=spans)

    def big_args(self, bidx: BigIndex, r_list, lo, device=None):
        """Prep of a long-genome dispatch: the arguments of
        ``parse_events_big`` for the references `r_list` of `bidx` x the
        B_big queries [lo, lo + B_big). The self pair gets dsz = msl, so a
        megabase self-parse never runs (pallas_engine.py:1888-1891), as do
        padding rows."""
        dev = device or self.devices[0]
        cfg, B = self.cfg, self.B_big
        q = dev_unpack3(self.Q[dev][lo:lo + B], self.LqP)
        rows = torch.arange(lo, lo + B, device=dev)
        refs = torch.as_tensor(list(r_list), device=dev)
        dsz = torch.where(rows[None] == refs[:, None], cfg.msl,
                          self.DSZ[dev][lo:lo + B][None]).to(torch.int32)
        cand, next_hit = big_query_prep(q, dsz, bidx.keys, cfg.mal, cfg.msl)
        return (bidx.refbuf, q.to(torch.uint8).contiguous(), bidx.poslist,
                cand, next_hit, bidx.win, dsz.contiguous(), bidx.nrs, cfg,
                self.EV_CAP_BIG)

    def dispatch_big(self, bidx: BigIndex, r_list, lo, device=None,
                     spans=OFF):
        """Prep + big kernel (``big_args``). Returns device tensors (ev,
        nev); nothing is synchronised. `spans` as ``dispatch_group``."""
        with spans.span("unit.prep"), spans.stage("dev.prep"):
            args = self.big_args(bidx, r_list, lo, device)
        with spans.span("unit.launch"), spans.stage("dev.kernel"):
            return parse_events_big(*args)

    def collect_big(self, handles, spans=OFF):
        """Download a long-genome dispatch -> out[g][b]: an event log, or
        None where the pair must be parsed natively (nev < 0 or nev >
        EV_CAP_BIG: a capacity fallback)."""
        ev, nev = handles
        return _download_logs(ev, nev, self.EV_CAP_BIG, spans=spans)


class EventLogs:
    """A downloaded dispatch's event logs, compacted: `ev`, the (N, 8)
    int32 host block of every kept log's records back to back, `nev`,
    the (G, B) int32 log lengths, -1 where the pair has no log and is
    parsed natively, `off`, the (G, B) int64 first record of each log
    in `ev`, and `sync_s`, the host seconds the download waited for the
    device before its copy. ``logs[g][b]`` is pair (g, b)'s (n, 8) log,
    or None."""

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


def _download_logs(ev, nev, cap, overflow=None, spans=OFF) -> EventLogs:
    """``EventLogs`` of a dispatch's (ev, nev): a pair keeps its first nev
    records, and has no log where nev < 0, nev > cap or `overflow[g, b]`
    is set. The kept records are gathered densely on the device first,
    so the copy moves the sum of the kept logs' lengths, not G x B times
    the longest.

    `spans` (``spans.UnitSpans``) splits the sync in two: on a card the
    host first waits for the unit's own kernel (``unit.sync_own``), then
    the copy of the lengths waits for the work queued after it
    (``unit.sync_ahead``; the whole sync on the CPU). It also records
    the gather's device time (``dev.compact``) and the host's gather and
    copy (``unit.copy``)."""
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


# ---------------------------------------------------------------------------
# all-vs-all
# ---------------------------------------------------------------------------

def all2all_cuda(codes, params, filter_csr=None, progress=None,
                 replay_threads: int = 0, region_path: str | None = None,
                 device=None, stats: dict | None = None, devices=None,
                 card_share: int = 1):
    """All-vs-all triples through the CUDA engine; layout matches
    ``native_engine.all2all`` (dense (n, n-1, 3), or (nnz, 3) aligned to
    the filter CSR). `device` defaults to the current CUDA device; a CPU
    device runs the kernels' plain versions (tests).

    `devices`, in place of `device`, is a list of device entries: work
    units go round-robin over the entries (``CudaAll2All.device_for``),
    and each entry keeps two units in flight and one live reference
    index. Entries may repeat a device (``["cpu", "cpu"]`` in the tests,
    two entries on one card). `card_share` is the number of processes
    that drive the same card (``big_launch_shape``).

    Rows are routed as the JAX package routes them (``row_path``): the
    group path, the long-genome path, or (composites above MAX_BIG_SYMS)
    the native engine, logged.

    `stats`, when given, receives: kernel_pairs / big_pairs (pairs
    replayed from a group / long-genome kernel log), cap_fallbacks (group
    pairs whose log exceeded EV_CAP or whose row had an anchor bucket over
    CNT_CAP), big_cap_fallbacks and big_fallback_pairs (long-genome pairs
    whose log exceeded EV_CAP_BIG, and their (r, q)), native_rows and
    native_row_pairs (rows routed to the native engine), big_rows,
    G_big and B_big (references and queries per long-genome launch),
    replay_mismatches (logs the replay rejected), dispatches,
    launches / big_launches (kernel launches of each path),
    device_units (the units each device entry ran), and the host clocks
    of the run: setup_s (entry to the first dispatch), dispatch_s and
    download_s (the main thread's seconds in index builds and
    dispatches, and in downloads, the sync included), win_s (of
    dispatch_s, the index builds' WIN words), download_sync_s
    (of download_s, the sync: the wait for the device, which on the one
    stream also covers the next unit's prep and kernel), replay_tail_s
    (its wait for the replay pool after the last download), replay_c_s
    (the seconds inside the native replay calls, summed over the pool's
    threads), replay_wall_s (first replay task submitted to last one
    finished) and replay_pairs (pairs replayed or parsed by the pool).

    When a torch profiler is recording at entry, `stats` also receives
    ``spans``: the call's spans (``ops/spans.py``; PERF.md names them
    and the metrics that read them). Host spans: ``engine.setup`` (entry
    to the first dispatch), ``engine.loop`` (from there to the end of
    the last download), ``engine.replay_tail``; per unit ``unit.index``
    (an index build), ``unit.prep``, ``unit.launch``, ``unit.sync_own``
    (on a card: the wait for the unit's own kernel), ``unit.sync_ahead``
    (the rest of its sync), ``unit.copy`` (the gather and copy of the
    kept records), and on a pool thread ``unit.queue`` (submission to
    the start of its replay). On a card, per unit, the device spans
    ``dev.join``, ``dev.prep``, ``dev.kernel`` and ``dev.compact``, on
    the host's clock. Without them no event, sync or list is added.

    Each downloaded unit is replayed by one native call
    (``finalize.UnitReplay``) on a pool of `replay_threads` threads (all
    cores but one by default), which run in parallel: the call releases
    the interpreter lock. A long-genome unit's call spreads its
    references over that many native threads.

    Raises RuntimeError after the run when any kernel log failed the
    replay's cross-check: the kernel computed a wrong stream, and those
    pairs' outputs are not written.
    """
    from . import parse_kernel

    t_entry = time.perf_counter()
    sp = Spans() if requested() else None
    verbosity = getattr(params, "verbosity_level", 1)

    def _warn(msg, level=1):
        if verbosity >= level:
            print(msg, file=sys.stderr)

    n = len(codes)
    cfg = ParseCfg.from_params(params)
    launches0 = parse_kernel.parse_events.launches
    big_launches0 = parse_kernel.parse_events_big.launches
    st = dict(kernel_pairs=0, cap_fallbacks=0, big_pairs=0,
              big_cap_fallbacks=0, big_fallback_pairs=[], native_rows=0,
              native_row_pairs=0, big_rows=0, G_big=0, B_big=0,
              replay_mismatches=0, dispatches=0, launches=0, big_launches=0,
              device_units=[], setup_s=0.0, dispatch_s=0.0, win_s=0.0,
              download_s=0.0, download_sync_s=0.0, replay_tail_s=0.0,
              replay_c_s=0.0, replay_wall_s=0.0, replay_pairs=0)
    if sp is not None:
        st["spans"] = sp.spans
    if stats is not None:
        stats.update(st)

    reason = device_envelope_reason(params)
    if reason is not None:
        _warn(f"lz-ani-torch: parameters outside the CUDA kernel envelope "
              f"({reason}); this run uses the native engine (byte-identical "
              f"output)")
        out = native_engine.all2all(codes, params, filter_csr=filter_csr,
                                    region_path=region_path)
        if stats is not None:
            stats.update(native_rows=n, native_row_pairs=int(
                n * (n - 1) if filter_csr is None else len(filter_csr[1])))
        return out

    if devices is None:
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("all2all_cuda: no CUDA device")
            device = torch.device("cuda", torch.cuda.current_device())
        devices = [device]
    elif device is not None or not devices:
        raise ValueError("all2all_cuda: give `device` or a non-empty "
                         "`devices`, not both")
    devices = [torch.device(d) for d in devices]
    st["device_units"] = [0] * len(devices)

    if filter_csr is None:
        out = np.zeros((n, max(n - 1, 0), 3), dtype=np.int32)
    else:
        indptr, ids = filter_csr
        out = np.zeros((len(ids), 3), dtype=np.int32)

    eng = (CudaAll2All(codes, params, devices=devices,
                       shape=query_shape(codes, cfg.mrd)) if n else None)
    if n and eng.all_big:
        why = eng.big_only_reason(eng.LqP, cfg.mal)
        _warn(f"lz-ani-torch: {why}; every row takes the long-genome "
              f"kernel")
    rows = {"group": [], "big": [], "native": []}
    idle_rows = 0   # rows with no pair to compute (another process's)
    for r in range(n):
        qs, slots = row_wanted(r, n, filter_csr)
        if not len(qs):
            idle_rows += 1
            continue
        if eng.paths[r] == "native":
            _warn(f"lz-ani-torch: reference {r} ({int(eng.dszs[r]) - cfg.mrd}"
                  f" bp): composite of {2 * int(eng.dszs[r]) + cfg.mrd} "
                  f"symbols exceeds {CudaAll2All.MAX_BIG_SYMS}; row runs on "
                  f"the native engine")
        rows[eng.paths[r]].append((r, (qs, slots)))

    # groups: (kind, r_list, wanteds). Group-path groups are padded to G
    # with dummy references (r = -1); long-genome groups are not
    groups = []
    G = CudaAll2All.GROUP
    for i0 in range(0, len(rows["group"]), G):
        chunk = rows["group"][i0:i0 + G]
        pad = G - len(chunk)
        groups.append(("group", [r for r, _ in chunk] + [-1] * pad,
                       [w for _, w in chunk] + [NO_PAIRS] * pad))
    if rows["big"]:
        G_big, B_big = eng.big_launch_shape(len(rows["big"]),
                                            share=card_share)
        st.update(G_big=G_big, B_big=B_big)
        _warn(f"lz-ani-torch: long-genome path: {len(rows['big'])} rows, "
              f"{G_big} references x {B_big} queries per launch, event cap "
              f"{eng.EV_CAP_BIG}", level=2)
        for i0 in range(0, len(rows["big"]), G_big):
            chunk = rows["big"][i0:i0 + G_big]
            groups.append(("big", [r for r, _ in chunk],
                           [w for _, w in chunk]))

    # units: (gi, lo, gathered query rows or None, pairs (g, r, q, slot, b))
    units = []
    for gi, (kind, r_list, wanteds) in enumerate(groups):
        if kind == "big" or filter_csr is None:
            # contiguous query windows (the long-genome path uses them
            # under a filter too, as the JAX engine does)
            width = eng.B_big if kind == "big" else eng.B
            for lo in range(0, eng.n_pad, width):
                pairs = unit_pairs(r_list, wanteds, lambda qs: (
                    (qs >= lo) & (qs < lo + width), qs - lo))
                if len(pairs[0]):
                    units.append((gi, lo, None, pairs))
        else:
            # sparse filter: dispatch the group's wanted queries gathered
            # densely (pallas_engine.py:1545-1560)
            uq = np.unique(np.concatenate([qs for qs, _ in wanteds]))
            for c0 in range(0, len(uq), eng.B):
                chunk = uq[c0:c0 + eng.B]
                idx = np.full(eng.B, chunk[-1], np.int64)
                idx[:len(chunk)] = chunk
                pairs = unit_pairs(r_list, wanteds, lambda qs: (
                    np.isin(qs, chunk), np.searchsorted(chunk, qs)))
                units.append((gi, None, idx, pairs))

    # the Sequences% counter: a reference row counts when its last unit
    # drains (pallas_engine.py:1575-1580); rows without units count now,
    # those with no pair at all too
    group_rem = [0] * len(groups)
    for gi, _, _, _ in units:
        group_rem[gi] += 1
    group_nreal = [sum(r >= 0 for r in rl) for _, rl, _ in groups]
    total_pairs = (sum(len(u[3][0]) for u in units)
                   + sum(len(w[0]) for _, w in rows["native"]))
    seqs_done = idle_rows + sum(group_nreal[gi] for gi in range(len(groups))
                                if group_rem[gi] == 0)

    nthreads = replay_threads or max(2, (os.cpu_count() or 2) - 1)
    rf = open(region_path, "wb") if region_path else None
    try:
        rep = UnitReplay(codes, params, out, rf)
        done_pairs = 0
        with ThreadPoolExecutor(max_workers=nthreads) as pool:
            futs = []
            # native rows first: the pool works on them while the device
            # runs the kernel units
            for r, (qs, slots) in rows["native"]:
                futs.append(pool.submit(rep.parse_row, r, qs, slots))
                st["native_row_pairs"] += len(qs)
            st["native_rows"] = len(rows["native"])
            st["big_rows"] = len(rows["big"])

            def drain(unit, handles, us):
                nonlocal done_pairs, seqs_done
                gi, _, _, (pg, pr, pq, pslot, pb) = unit
                big = groups[gi][0] == "big"
                t0 = time.perf_counter()
                logs = (eng.collect_big(handles, us) if big
                        else eng.collect_group(handles, us))
                st["download_s"] += time.perf_counter() - t0
                st["download_sync_s"] += logs.sync_s
                us.resolve()
                nev = logs.nev[pg, pb]
                fb = np.flatnonzero(nev < 0)
                for r, q in zip(pr[fb].tolist(), pq[fb].tolist()):
                    if big:
                        st["big_fallback_pairs"].append([r, q])
                    _warn(f"lz-ani-torch: pair ({r},{q}) fell back to the "
                          f"native engine (event/anchor capacity)", level=2)
                st["big_cap_fallbacks" if big else "cap_fallbacks"] += len(fb)
                st["big_pairs" if big else "kernel_pairs"] += len(nev) - len(fb)
                # a long-genome unit is a few megabase pairs, replayed
                # while the pool has little else to do: its references go
                # to several threads; a group unit is one of many, one
                # thread each
                futs.append(rep.submit(pool, pr, pq, pslot, nev,
                                       logs.offsets(pg, pb), logs.ev,
                                       threads=nthreads if big else 1,
                                       queued=us.queue))
                done_pairs += len(pr)
                group_rem[gi] -= 1
                if group_rem[gi] == 0:
                    seqs_done += group_nreal[gi]
                if progress is not None:
                    progress(done_pairs, total_pairs, seqs_done, n)

            # depth-2 pipeline per device entry: unit k + len(devices) is
            # queued before unit k's logs are downloaded and handed to the
            # replay pool. Units go round-robin over the entries, and each
            # entry keeps one live index (a group's units are consecutive)
            n_ent = len(devices)
            inflight = []
            live = {}    # entry -> (group, its index on the entry's device)
            t_loop = time.perf_counter()
            st["setup_s"] = t_loop - t_entry
            if sp is not None:
                sp.host("engine.setup", None, t_entry, t_loop)
                sp.anchor(devices)
            for k, unit in enumerate(units):
                gi, lo, qidx, _ = unit
                kind, r_list, _ = groups[gi]
                t0 = time.perf_counter()
                e, dev = k % n_ent, eng.device_for(k)
                us = OFF if sp is None else UnitSpans(sp, k, dev)
                if live.get(e, (None,))[0] != gi:
                    live.pop(e, None)            # free the previous index
                    live[e] = (gi, eng.build_big_index(r_list, dev, us)
                               if kind == "big"
                               else eng.build_group_index(r_list, dev, us))
                    us.host("unit.index", t0)
                    st["win_s"] += live[e][1].win_s
                idx = live[e][1]
                if kind == "big":
                    handles = eng.dispatch_big(idx, r_list, lo, dev, us)
                elif qidx is not None:
                    handles = eng.dispatch_group(
                        idx, None, dev, qrows=eng.gather_qrows(qidx, dev),
                        spans=us)
                else:
                    handles = eng.dispatch_group(idx, lo, dev, spans=us)
                st["dispatch_s"] += time.perf_counter() - t0
                st["dispatches"] += 1
                st["device_units"][e] += 1
                inflight.append((unit, handles, us))
                if len(inflight) >= 2 * n_ent:
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
            progress(total_pairs, total_pairs, n, n)
    finally:
        if rf is not None:
            rf.close()

    st.update(replay_mismatches=rep.replay_mismatches,
              replay_c_s=rep.c_s, replay_wall_s=rep.wall_s,
              replay_pairs=rep.pairs)
    st["launches"] = parse_kernel.parse_events.launches - launches0
    st["big_launches"] = parse_kernel.parse_events_big.launches - big_launches0
    fallbacks = st["cap_fallbacks"] + st["big_cap_fallbacks"]
    if fallbacks:
        _warn(f"lz-ani-torch: {fallbacks}/{total_pairs} pairs fell back to "
              f"the native engine (event-buffer or anchor-bucket capacity)")
    if stats is not None:
        stats.update(st)
    if st["replay_mismatches"]:
        raise RuntimeError(
            f"lz-ani-torch: {st['replay_mismatches']} kernel event logs "
            f"failed the replay cross-check (first pairs (r, q): "
            f"{rep.mismatched[:5]}); the kernel's output is wrong")
    return out
