"""All-vs-all orchestration of the port: load -> filter -> reorder ->
match -> store.

The port's own copy of ``lzani_tpu/matcher.py`` (the phase sequence of
the reference's ``CLZMatcher::run_all2all``, lz_matcher.cpp:582-617)
with four backends: ``native`` (the C++ host engine), ``cuda`` (the
CUDA device engine, ``ops/cuda_engine.all2all_cuda``), ``hybrid`` (the
native pool and the CUDA engine on one shared row queue,
``ops/hybrid.all2all_hybrid``) and ``jax`` (the automaton backend: the
triples folded on the device, ``ops/engine_jax.all2all_jax``). As in the
JAX package, ``auto`` means ``hybrid``; ``pallas``, the JAX package's
name of the event-log engine, means ``cuda``.

A multi-process launch (the JAX package's ``JAX_COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``, ``parallel.distributed``)
runs the same phases in every process: each computes its stride share of
the reference rows with the selected backend, on its own card
(``cuda:(process id % cards)``), the triples and region records are
gathered to process 0 over gloo, and process 0 alone writes the outputs.
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


#: backend names that mean another backend
ALIASES = {"auto": "hybrid", "pallas": "cuda"}


class Matcher:
    """One all-vs-all run. After a cuda, hybrid or jax run,
    ``engine_stats`` holds the engine's counters (see ``all2all_cuda``,
    ``all2all_hybrid`` and ``all2all_jax``)."""

    def __init__(self, params: Params, device=None):
        self.params = params
        #: engine device for every backend but ``native``; None = the
        #: current CUDA device. A CPU device runs the kernels' plain versions
        #: (tests only).
        self.device = device
        self.store: SequenceStore | None = None
        self.filter: PairFilter | None = None
        self.times: list[tuple[float, str]] = []
        self.engine_stats: dict | None = None
        self._device_setup: threading.Thread | None = None
        #: this process's place in a multi-process launch, and whether it
        #: joined the launch's process group
        self.process_id, self.num_processes = 0, 1
        self._joined = False
        #: processes of the launch that drive this process's card
        self.card_share = 1

    def _log(self, msg: str, level: int = 1) -> None:
        if self.params.verbosity_level >= level:
            print(msg, file=sys.stderr)

    def _mark(self, label: str) -> None:
        self.times.append((time.perf_counter(), label))

    def _join_launch(self) -> None:
        """In a multi-process launch (JAX_COORDINATOR_ADDRESS set): join
        the process group and, unless the caller chose the device, take
        card process_id % cards for every backend but ``native`` (the
        counterpart of the JAX package's ``jax.local_devices()[:1]``).
        Without the variable nothing is imported: a native run loads no
        torch."""
        from .parallel import distributed

        if not os.environ.get(distributed.ENV_ADDRESS):
            return
        self.process_id, self.num_processes = distributed.init_distributed()
        self._joined = True
        if self.num_processes == 1:
            return
        if self.device is None and self.params.backend != "native":
            from .utils import cudadev

            n_cards = cudadev.cuda_device_count()
            if n_cards:
                self.device = f"cuda:{self.process_id % n_cards}"
        self.card_share = distributed.card_share(self.device)

    def _backend(self) -> str:
        return ALIASES.get(self.params.backend, self.params.backend)

    def _start_device(self):
        """For the cuda and jax backends on a card: a started thread that
        creates the CUDA context and loads the kernels' and the native
        engine's libraries while the sequences load (no kernel is
        launched), or None. The hybrid backend's warm-up thread decides
        that itself, so a run too short for the device never imports
        torch; a jax run with an aln file is a native run."""
        backend = self._backend()
        if backend not in ("cuda", "jax") or (
                backend == "jax" and self.params.output_alignment_file_name):
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
            from .ops import fold_stats, parse_kernel

            torch.empty(1, device=dev)
            parse_kernel.load()
            if backend == "jax":
                fold_stats.load()
            native_engine.get_lib()

        th = threading.Thread(target=setup, daemon=True)
        th.start()
        return th

    def run_all2all(self) -> bool:
        p = self.params
        p.adjust_threads()
        self._mark("")
        self._join_launch()
        if self.num_processes > 1:
            self._mark("Joining the launch's processes")
        try:
            return self._run_phases()
        finally:
            if self._joined:
                from .parallel import distributed

                distributed.shutdown()

    def _run_phases(self) -> bool:
        p = self.params
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

        # a multi-process launch: this process's share of the rows
        eng_csr, eng_region, slots = csr, region_path, None
        if self.num_processes > 1:
            from .parallel import distributed

            n = len(self.store)
            rows = distributed.partition_refs(n, self.num_processes,
                                              self.process_id)
            indptr, ids, slots = distributed.local_filter_csr(rows, n, csr)
            eng_csr = (indptr, ids)
            if region_path:
                eng_region = region_path + f".h{self.process_id}"
            self._log(f"multi-host: process {self.process_id}/"
                      f"{self.num_processes} owns {len(rows)} reference rows "
                      f"({len(ids)} pairs)")

        backend = self._backend()
        if backend == "native":
            triples = self._match_native(eng_csr, eng_region)
        elif backend == "hybrid":
            # torch-free at import: the warm-up thread imports torch
            from .ops.hybrid import all2all_hybrid

            stats = {}
            triples = all2all_hybrid(self.store.codes, p, filter_csr=eng_csr,
                                     region_path=eng_region,
                                     progress=self._make_progress_cb(),
                                     device=self.device, stats=stats)
            self.engine_stats = stats
            self._log(f"lz-ani-torch engine: {json.dumps(stats)}", level=2)
        elif backend == "cuda":
            from .ops.cuda_engine import all2all_cuda

            if self._device_setup is not None:
                self._device_setup.join()
            stats: dict = {}
            triples = all2all_cuda(self.store.codes, p, filter_csr=eng_csr,
                                   region_path=eng_region,
                                   progress=self._make_progress_cb(),
                                   replay_threads=p.no_threads,
                                   device=self.device, stats=stats,
                                   card_share=self.card_share)
            self.engine_stats = stats
            self._log(f"lz-ani-torch engine: {json.dumps(stats)}", level=2)
        elif backend == "jax" and region_path:
            # the automaton has no regions path: one native pass serves
            # the triples and the regions (lzani_tpu/matcher.py)
            self._log("--backend jax has no alignment-regions path; this "
                      "run is served by the native engine (one pass)")
            triples = self._match_native(eng_csr, eng_region)
        elif backend == "jax":
            from .ops.engine_jax import all2all_jax

            if self._device_setup is not None:
                self._device_setup.join()
            stats = {}
            triples = all2all_jax(self.store.codes, p, filter_csr=eng_csr,
                                  progress=self._make_progress_cb(),
                                  device=self.device, stats=stats)
            self.engine_stats = stats
            self._log(f"lz-ani-torch engine: {json.dumps(stats)}", level=2)
        else:
            raise ValueError(f"Unknown backend: {p.backend}")
        if self.num_processes > 1:
            triples = self._merge(triples, slots, csr, region_path,
                                  eng_region)
        return triples, csr, region_path

    def _merge(self, triples, slots, csr, region_path, eng_region):
        """Gather every process's share to process 0 (``gather_merge``),
        then leave the process group. Process 0 gets the whole result in
        the single-process layout and writes the joined region records to
        `region_path`; the other processes get None."""
        from .parallel import distributed

        blob = b""
        if eng_region and os.path.exists(eng_region):
            with open(eng_region, "rb") as fh:
                blob = fh.read()
            os.remove(eng_region)
        n = len(self.store)
        total = n * (n - 1) if csr is None else int(csr[0][-1])
        flat, blob = distributed.gather_merge(slots, triples, total, blob)
        distributed.shutdown()
        self._log(f"multi-host: merged triples from {self.num_processes} "
                  f"processes")
        if flat is None:
            return None
        if region_path:
            with open(region_path, "wb") as fh:
                fh.write(blob)
        return flat if csr is not None else flat.reshape(n, max(n - 1, 0), 3)

    def _match_native(self, csr, region_path):
        """The native engine's threaded all-vs-all, with the reference's
        progress line at -V 2 (a monitor thread reads its counters)."""
        from .core import native_engine

        p = self.params
        prog = mon = None
        if p.verbosity_level >= 2:
            n = len(self.store)
            total_pairs = n * (n - 1) if csr is None else len(csr[1])
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
        if self.process_id != 0:
            # process 0 writes the outputs; region_path is its file
            self._log("multi-host: outputs written by process 0; this "
                      "process skips the store phase")
            return True
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
