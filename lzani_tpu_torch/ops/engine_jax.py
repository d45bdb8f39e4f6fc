"""The automaton backend of the port (``--backend jax``): every pair's
stats triple computed on the device, with no host replay.

Counterpart of ``lzani_tpu/ops/engine_jax.py``, with the same public
names. There, one XLA automaton (``make_pair_parser``) parses each pair
and folds its factors into the triple. Here two hand-written kernels do
it per query batch: the event-log parse (``parse_kernel.parse_events``,
through ``CudaRefIndex``) and the fold of each log into its factors and
triple (``fold_stats.fold_stats``); only the (B, 3) triples come back to
the host. What is not ported is the XLA schedule of the same parse: the
linear-probe anchor hash table (``prep.build_anchor_table``), the seed
buckets (``prep.build_seed_buckets``) and the while-loop automaton. The
port's direct-address join gives the same anchors
(``tests/test_torch_prep.py``).

A pair the kernels do not serve runs on the native engine and counts as
a capacity fallback: an anchor bucket over CNT_CAP in its query row, an
unfinished parse (nev = -1), or more than MAXEV - 16 events. A log that
the fold rejects (status -1) is a replay mismatch: its pair is not
repaired, and the run raises once it is over. Rows that the CUDA engine
would send to its long-genome path raise at once (this backend has no
long-genome route; ``--backend cuda`` has), as the JAX backend refuses
sequences over its accelerator budget (``lzani_tpu/matcher.py``).

`device` None means the current CUDA device; a CPU device runs the
kernels' plain versions (tests). A list of device entries (a mesh,
``parallel/mesh.py``) splits each query batch over them.
"""

from __future__ import annotations

import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from ..core import native_engine
from . import fold_stats as fold_kernel, parse_kernel
from .cuda_engine import (CudaAll2All, CudaRefIndex,
                          device_envelope_reason, fold_args, query_shape)
from .fold_stats import fold_stats
from .parse import ParseCfg
from .parse_kernel import parse_events
from .prep import SYM_N_REF, ref_buffer_np
from .spans import OFF, Spans, UnitSpans, requested


class Batch(NamedTuple):
    """One collected batch: `stats` (B, 3) int32 with the fallbacks'
    native triples filled in, the batch positions of the capacity
    fallbacks and of the rejected logs, and with factors `fac` (B, F, 4)
    and `nfac` (B,), else None."""
    stats: np.ndarray
    fallbacks: np.ndarray
    mismatched: np.ndarray
    fac: np.ndarray | None = None
    nfac: np.ndarray | None = None


def _device(device):
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("--backend jax: no CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


class RefIndexJax:
    """One reference on the device (``CudaRefIndex``: its buffer, WIN
    table and anchor join) and the batch parse: one ``parse_events``
    launch and one ``fold_stats`` launch per query batch."""

    MAXEV = CudaRefIndex.MAXEV

    def __init__(self, codes: np.ndarray, params, device=None):
        self.codes = codes
        self.params = params
        self.cfg = ParseCfg.from_params(params)
        self.index = CudaRefIndex(codes, params, _device(device))
        self.device = self.index.device

    def dispatch(self, args, overflow, want_factors: bool = False,
                 spans=OFF):
        """Launch the parse and the fold on ``CudaRefIndex.batch_args`` or
        ``rows_args`` output; device tensors, nothing synchronised.
        `spans` records ``row.launch`` and the stages ``dev.kernel`` (the
        parse) and ``dev.fold``."""
        with spans.span("row.launch"):
            with spans.stage("dev.kernel"):
                ev, nev = parse_events(*args)
            skip, fargs = fold_args(args, ev, nev, overflow)
            with spans.stage("dev.fold"):
                out = fold_stats(*fargs, want_factors)
        return skip, out

    def collect(self, handles, query, spans=OFF) -> Batch:
        """Download a ``dispatch`` and parse its fallbacks natively;
        `query(b)` gives the codes of the batch's query b (only the
        fallbacks' are read: a run's codes may unpack on each access).
        `spans` records the copies, with the wait for the device, as
        ``row.download``, then puts the device stages on the host's clock,
        and records the native parses as ``row.fallback`` when there are
        any."""
        skip, out = handles
        with spans.span("row.download"):
            stats = out[0][0].cpu().numpy().copy()
            status = out[1][0].cpu().numpy()
            fallbacks = np.flatnonzero(skip[0].cpu().numpy())
            fac = nfac = None
            if len(out) == 4:
                fac = out[2][0].cpu().numpy().copy()
                nfac = out[3][0].cpu().numpy().copy()
        spans.resolve()
        t0 = time.perf_counter()
        for b in fallbacks:
            q = query(b)
            stats[b] = native_engine.parse_pair(self.codes, q,
                                                self.params)[0]
            if fac is not None:
                f = native_engine.parse_factors(self.codes, q, self.params)
                fac[b, :len(f)] = f
                nfac[b] = len(f)
        if len(fallbacks):
            spans.host("row.fallback", t0)
        return Batch(stats, fallbacks, np.flatnonzero(status == -1), fac,
                     nfac)

    def parse_batch(self, qcodes: list, params, want_factors: bool = False):
        """Triples (B, 3) int32 of a query batch, or (triples, factors
        (B, F, 4), factor counts (B,)) with `want_factors` (the JAX
        method's outputs, as numpy). Raises on a rejected log."""
        if ParseCfg.from_params(params) != self.cfg:
            raise ValueError("parse_batch: parameters differ from the "
                             "index's")
        args, overflow = self.index.batch_args(qcodes)
        res = self.collect(self.dispatch(args, overflow, want_factors),
                           qcodes.__getitem__)
        if len(res.mismatched):
            raise RuntimeError(f"fold_stats rejected the event logs of "
                               f"queries {res.mismatched.tolist()}")
        return (res.stats, res.fac, res.nfac) if want_factors else res.stats


def ref_index_from_jax(refbuf, ref_true, params, device=None) -> RefIndexJax:
    """The port's index of the reference held by the JAX package's
    ``RefIndexJax``: numpy copies of its ``refbuf`` (the composite buffer,
    N-padded) and ``ref_true`` (the composite length). Raises when the
    buffer is not a composite of these parameters."""
    mrd = ParseCfg.from_params(params).mrd
    buf = np.asarray(refbuf, np.uint8).reshape(-1)
    n_true = int(ref_true)
    L, odd = divmod(n_true - 3 * mrd, 2)
    codes = buf[:max(L, 0)].copy()
    if (odd or L < 0 or n_true > len(buf)
            or not np.array_equal(ref_buffer_np(codes, mrd), buf[:n_true])
            or (buf[n_true:] != SYM_N_REF).any()):
        raise ValueError("ref_index_from_jax: not a composite reference "
                         "buffer of these parameters")
    return RefIndexJax(codes, params, device)


def parse_pair_jax(ref_codes: np.ndarray, q_codes: np.ndarray, params,
                   want_factors: bool = False, device=None):
    """Single-pair entry point: the stats triple, or (triple, factors
    (n, 4)) with `want_factors`."""
    out = RefIndexJax(ref_codes, params, device).parse_batch(
        [q_codes], params, want_factors)
    if want_factors:
        stats, fac, nfac = out
        return tuple(int(x) for x in stats[0]), fac[0, :int(nfac[0])]
    return tuple(int(x) for x in out[0])


def check_routes(codes, params, rows):
    """Raise unless every reference row in `rows` takes the CUDA engine's
    group path (``CudaAll2All.row_path``) and the parameters lie inside
    the kernels' envelope. Returns the run's ``query_shape``: the query
    lengths (+ mrd) and the query bucket."""
    why = device_envelope_reason(params)
    if why is not None:
        raise RuntimeError(f"--backend jax: parameters outside the CUDA "
                           f"kernels' envelope ({why}); use --backend cuda, "
                           f"which runs them on the native engine")
    cfg = ParseCfg.from_params(params)
    dszs, LqP = query_shape(codes, cfg.mrd)
    all_big = CudaAll2All.big_only_reason(LqP, cfg.mal)
    for r in rows:
        nr = 2 * int(dszs[r]) + cfg.mrd
        if CudaAll2All.row_path(nr, all_big is not None) != "group":
            raise RuntimeError(
                f"--backend jax: reference {r} ({int(dszs[r]) - cfg.mrd} bp) "
                f"takes the long-genome path "
                f"({all_big or f'composite of {nr} symbols'}), which this "
                f"backend does not have; use --backend cuda")
    return dszs, LqP


def row_queries(r, n, filter_csr):
    """Query ids of reference row r: every other row, or the filter's."""
    if filter_csr is None:
        return [q for q in range(n) if q != r]
    indptr, ids = filter_csr
    return [int(q) for q in ids[indptr[r]:indptr[r + 1]]]


def parse_split(indexes: dict, mesh, n_lanes: int, args_of, query,
                spans=None) -> Batch:
    """One batch of `n_lanes` queries cut into contiguous shards, one per
    entry of `mesh` (the last shards may be short or empty), each shard's
    parse and fold launched on its entry's device before any shard is read
    back, the results gathered in lane order. `indexes[device]` is the
    reference's ``RefIndexJax`` on that device, `args_of(index, lo, hi)`
    the (``parse_events`` arguments, overflow flags) of lanes [lo, hi) on
    its device and `query(b)` the codes of lane b (fallbacks only).
    `spans[device]`, when given, records each shard's ``row.args``
    (`args_of`) and its launch and download."""
    per = -(-n_lanes // len(mesh))
    shards = []
    for k, dev in enumerate(mesh):
        lo, hi = k * per, min((k + 1) * per, n_lanes)
        if lo < hi:
            idx, us = indexes[dev], OFF if spans is None else spans[dev]
            with us.span("row.args"):
                args = args_of(idx, lo, hi)
            shards.append((lo, idx, idx.dispatch(*args, spans=us), us))
    parts = [(lo, idx.collect(h, lambda b, lo=lo: query(lo + b), us))
             for lo, idx, h, us in shards]
    return Batch(np.concatenate([p.stats for _, p in parts]),
                 *(np.concatenate([lo + getattr(p, key) for lo, p in parts])
                   for key in ("fallbacks", "mismatched")))


def all2all_jax(codes: list, params, filter_csr=None, batch_size: int = 512,
                progress=None, device=None, stats: dict | None = None
                ) -> np.ndarray:
    """All-vs-all triples; layout matches ``native_engine.all2all`` (dense
    (n, n-1, 3) or (nnz, 3) aligned to the filter CSR). One index per
    reference row, its queries sorted by length in batches of
    `batch_size`; `progress(pairs_done, total_pairs, rows_done, n)` after
    each row. `device` may be a list of device entries (a mesh): each
    batch is then split over them (``parse_split``), with one copy of the
    queries and of each row's index per distinct device.

    `stats`, when given, receives: rows and batches (parsed), fold_pairs
    (triples folded on the device), cap_fallbacks (pairs parsed on the
    native engine), replay_mismatches (logs the fold rejected), launches
    and fold_launches (kernel launches of the parse and of the fold);
    while a torch profiler records at entry, ``spans`` (``ops/spans.py``,
    PERF.md section 3), each under its reference row's index: the host's
    ``row.index`` (the row's ``RefIndexJax`` builds), ``row.args``,
    ``row.launch``, ``row.download`` and ``row.fallback`` (``parse_split``),
    and on a card the device's ``dev.kernel`` and ``dev.fold``."""
    n = len(codes)
    if filter_csr is None:
        out = np.zeros((n, max(n - 1, 0), 3), dtype=np.int32)
        total_pairs = n * (n - 1)
    else:
        indptr, ids = filter_csr
        out = np.zeros((len(ids), 3), dtype=np.int32)
        total_pairs = len(ids)
    launches0 = parse_kernel.parse_events.launches
    folds0 = fold_kernel.fold_stats.launches
    st = dict(rows=0, batches=0, fold_pairs=0, cap_fallbacks=0,
              replay_mismatches=0, launches=0, fold_launches=0)
    sp = Spans() if requested() else None
    if sp is not None:
        st["spans"] = sp.spans
    mismatched = []
    pairs_done = 0
    queries = [row_queries(r, n, filter_csr) for r in range(n)]
    eng = None
    if any(queries):
        mesh = (tuple(torch.device(d) for d in device)
                if isinstance(device, (list, tuple)) else (_device(device),))
        shape = check_routes(codes, params, [r for r in range(n)
                                             if queries[r]])
        dszs = shape[0]
        # the packed queries stay on each device for the whole run
        eng = CudaAll2All(codes, params, devices=list(mesh), shape=shape)
        if sp is not None:
            sp.anchor(mesh)
    for r in range(n):
        q_ids = queries[r]
        if q_ids:
            us = None if sp is None else {d: UnitSpans(sp, r, d)
                                          for d in dict.fromkeys(mesh)}
            t0 = time.perf_counter()
            indexes = {d: RefIndexJax(codes[r], params, d)
                       for d in dict.fromkeys(mesh)}
            if sp is not None:
                sp.host("row.index", r, t0)
            st["rows"] += 1
            order = sorted(range(len(q_ids)), key=lambda k: dszs[q_ids[k]])
            for s in range(0, len(order), batch_size):
                sel = order[s:s + batch_size]
                qs = [q_ids[k] for k in sel]
                res = parse_split(
                    indexes, mesh, len(qs),
                    lambda idx, lo, hi: idx.index.rows_args(
                        *eng.gather_qrows(qs[lo:hi], idx.device), eng.LqP),
                    lambda b: codes[qs[b]], us)
                st["batches"] += 1
                st["cap_fallbacks"] += len(res.fallbacks)
                st["fold_pairs"] += (len(qs) - len(res.fallbacks)
                                     - len(res.mismatched))
                mismatched += [(r, qs[b]) for b in res.mismatched]
                for row, k in enumerate(sel):
                    q = q_ids[k]
                    if filter_csr is None:
                        out[r, q - 1 if q > r else q] = res.stats[row]
                    else:
                        out[int(indptr[r]) + k] = res.stats[row]
            pairs_done += len(q_ids)
        if progress is not None:
            progress(pairs_done, total_pairs, r + 1, n)
    st.update(replay_mismatches=len(mismatched),
              launches=parse_kernel.parse_events.launches - launches0,
              fold_launches=fold_kernel.fold_stats.launches - folds0)
    if stats is not None:
        stats.update(st)
    if st["cap_fallbacks"] and getattr(params, "verbosity_level", 1) >= 1:
        print(f"lz-ani-torch: {st['cap_fallbacks']}/{total_pairs} pairs fell "
              f"back to the native engine (event-buffer or anchor-bucket "
              f"capacity)", file=sys.stderr)
    if mismatched:
        raise RuntimeError(
            f"lz-ani-torch: {len(mismatched)} kernel event logs failed the "
            f"fold's cross-check (first pairs (r, q): {mismatched[:5]}); the "
            f"kernel's output is wrong")
    return out
