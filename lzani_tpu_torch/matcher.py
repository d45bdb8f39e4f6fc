"""All-vs-all orchestration of the port: load -> filter -> reorder ->
match -> store.

The port's own copy of ``lzani_tpu/matcher.py`` (the phase sequence of
the reference's ``CLZMatcher::run_all2all``, lz_matcher.cpp:582-617)
with two backends: ``native`` (the C++ host engine) and ``cuda`` (the
CUDA device engine, ``ops/cuda_engine.all2all_cuda``); ``auto`` means
``cuda``. The JAX package's ``pallas``, ``hybrid`` and ``jax`` backends
and its multi-host block are not part of the port.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

import numpy as np

from .io.fasta import SequenceStore, load_store
from .io.kmerdb_filter import PairFilter
from .output import (ALN_HEADER, ResultMatrix, alignment_lines,
                     derive_ids_path, ids_file_lines, single_txt_lines)
from .params import Params


class Matcher:
    """One all-vs-all run. After a cuda run, ``engine_stats`` holds the
    engine's counters (see ``all2all_cuda``)."""

    def __init__(self, params: Params, device=None):
        self.params = params
        #: engine device for ``cuda``; None = the current CUDA device. A
        #: CPU device runs the kernels' plain versions (tests only).
        self.device = device
        self.store: SequenceStore | None = None
        self.filter: PairFilter | None = None
        self.times: list[tuple[float, str]] = []
        self.engine_stats: dict | None = None
        self._device_setup: threading.Thread | None = None

    def _log(self, msg: str, level: int = 1) -> None:
        if self.params.verbosity_level >= level:
            print(msg, file=sys.stderr)

    def _mark(self, label: str) -> None:
        self.times.append((time.perf_counter(), label))

    def _start_device(self):
        """For the cuda backend on a card: a started thread that creates
        the CUDA context and loads the kernels' and the native engine's
        libraries while the sequences load (no kernel is launched), or
        None."""
        if self.params.backend not in ("cuda", "auto"):
            return None
        import torch

        if self.device is None and not torch.cuda.is_available():
            return None                 # all2all_cuda says why it stops
        dev = (torch.device("cuda", torch.cuda.current_device())
               if self.device is None else torch.device(self.device))
        if dev.type != "cuda":
            return None

        def setup():
            from .core import native_engine
            from .ops import parse_kernel

            torch.empty(1, device=dev)
            parse_kernel.load()
            native_engine.get_lib()

        th = threading.Thread(target=setup, daemon=True)
        th.start()
        return th

    def run_all2all(self) -> bool:
        p = self.params
        p.adjust_threads()
        self._mark("")
        self._device_setup = self._start_device()

        self._log("Loading sequences")
        self.store = load_store(p)
        self._mark("Loading sequences")

        if p.filter_file_name:
            self._log("Loading filter data")
            self.filter = PairFilter.load(p.filter_file_name, p.filter_thr)
            self._log(f"Filter size: {self.filter.total}")
        self._mark("Loading filter")

        if self.filter is not None:
            if self.filter.names != self.store.names:
                print("Input sequences and filter sequences are different!",
                      file=sys.stderr)
                return False
        self._mark("Comparing sequence and filter compatibility")

        self._log("Reordering sequences")
        remap = self.store.reorder()
        if self.filter is not None:
            self.filter.reorder(remap)
        self._mark("Reordering sequences")

        self._log("All2all sparse")
        triples, csr, region_path = self._do_matching()
        self._mark("LZ matching")

        self._log("Storing results")
        ok = self._store_results(triples, csr, region_path)
        self._mark("Storing results")

        if p.verbosity_level >= 2:
            self._show_timings()
        return ok

    # ------------------------------------------------------------------
    def _make_progress_cb(self):
        """Sequences%+Pairs% progress line of the device backend — the
        two counters the reference prints at -V 2 (lz_matcher.cpp:187-264):
        Sequences = reference rows completed, Pairs = directed pairs
        completed."""
        if self.params.verbosity_level < 2:
            return None
        state = {"last": ""}

        def prog_cb(done, total, seqs_done=0, total_seqs=0):
            s = (f"Sequences: {100 * seqs_done // max(total_seqs, 1)}%    "
                 f"Pairs: {100 * done // max(total, 1)}%")
            if s != state["last"]:
                print(s + "       ", end="\r", file=sys.stderr, flush=True)
                state["last"] = s

        return prog_cb

    def _do_matching(self):
        p = self.params
        region_path = None
        if p.output_alignment_file_name:
            region_path = p.output_alignment_file_name + ".regions.tmp"
        csr = None
        if self.filter is not None:
            csr = self.filter.indptr_ids(len(self.store))

        if p.backend == "native":
            triples = self._match_native(csr, region_path)
        elif p.backend in ("cuda", "auto"):
            from .ops.cuda_engine import all2all_cuda

            if self._device_setup is not None:
                self._device_setup.join()
            stats: dict = {}
            triples = all2all_cuda(self.store.codes, p, filter_csr=csr,
                                   region_path=region_path,
                                   progress=self._make_progress_cb(),
                                   replay_threads=p.no_threads,
                                   device=self.device, stats=stats)
            self.engine_stats = stats
            self._log(f"lz-ani-torch engine: {json.dumps(stats)}", level=2)
        else:
            raise ValueError(f"Unknown backend: {p.backend}")
        return triples, csr, region_path

    def _match_native(self, csr, region_path):
        """The native engine's threaded all-vs-all, with the reference's
        progress line at -V 2 (a monitor thread reads its counters)."""
        from .core import native_engine

        p = self.params
        prog = mon = None
        if p.verbosity_level >= 2:
            n = len(self.store)
            total_pairs = ((self.filter.total if self.filter else 0)
                           or n * (n - 1))
            prog = np.zeros(2, dtype=np.int64)
            stop = threading.Event()

            def monitor():
                last = ""
                while not stop.is_set():
                    s = (f"Sequences: {100 * prog[0] // max(n, 1)}%    "
                         f"Pairs: {100 * prog[1] // max(total_pairs, 1)}%")
                    if s != last:
                        print(s + "       ", end="\r", file=sys.stderr,
                              flush=True)
                        last = s
                    stop.wait(0.2)

            mon = threading.Thread(target=monitor, daemon=True)
            mon.start()
        try:
            return native_engine.all2all(self.store.codes, p,
                                         filter_csr=csr,
                                         region_path=region_path,
                                         progress=prog)
        finally:
            if mon is not None:
                stop.set()
                mon.join()

    # ------------------------------------------------------------------
    def _store_results(self, triples, csr, region_path) -> bool:
        p = self.params
        store = self.store
        if p.output_type == "single_txt":
            if csr is None:
                rm = ResultMatrix.from_dense(triples)
            else:
                rm = ResultMatrix.from_csr(len(store), csr[0], csr[1],
                                           triples)
            with open(p.output_file_name, "w", encoding="latin-1") as fh:
                fh.writelines(single_txt_lines(p, store, rm))
        else:
            ids_path = (p.output_ids_file_name
                        or derive_ids_path(p.output_file_name))
            with open(ids_path, "w", encoding="latin-1") as fh:
                fh.writelines(ids_file_lines(store, p.max_dist_in_ref))
            # threaded native formatter streams the TSV in ref-id order
            # (byte-identical to output.results_tsv_lines)
            from .core.native_engine import format_results
            format_results(p.output_file_name, p, store, triples,
                           filter_csr=csr)

        if p.output_alignment_file_name:
            from .core.native_engine import read_region_dump
            with open(p.output_alignment_file_name, "w",
                      encoding="latin-1") as fh:
                fh.write(ALN_HEADER)
                fh.writelines(
                    alignment_lines(p, store, read_region_dump(region_path)))
            os.unlink(region_path)

        return True

    def _show_timings(self) -> None:
        print("Timings", file=sys.stderr)
        for i in range(1, len(self.times)):
            dt = self.times[i][0] - self.times[i - 1][0]
            print(f"{self.times[i][1]} : {dt}s", file=sys.stderr)
        total = self.times[-1][0] - self.times[0][0]
        print(f"Total time: {total}s", file=sys.stderr)
