"""FASTA ingest and the in-memory sequence store.

Replaces the reference's ``CSeqReservoir`` (reference src/seq_reservoir.{h,cpp}).
Sequences are encoded to 6-symbol codes (A=0, C=1, G=2, T=3, query-N=5; the
reference's ref-N=4 substitution happens inside the engines) and held PACKED
at the reference's 3-codes-per-byte density (seq_reservoir.cpp:22-58 +
memory_monotonic.h:137-184 parity — 1/3 B per symbol). ``store.codes`` is a
``PackedCodes`` view: list-like for the Python engines (items unpack
transiently on access), zero-copy for the native all2all
(``lza_all2all_packed`` unpacks per reference row / per query inside the
worker, the reference's own schedule, parser.cpp:16-50). The loaders read
files in chunks through one native pass (``lza_ingest_*`` in
``csrc/lzani_core.cpp``) that finds the records, drops the line ends,
codes and packs; ``encode_dna`` and ``pack3`` are its tests' oracle.

Semantics preserved:
  * DNA code map: ACGTacgt -> 0..3, everything else -> 5 (seq_reservoir.h:241-248)
  * multisample mode: one item per '>' record, named by the header cut at the
    first space (seq_reservoir.cpp:156-212, name cut :77-81)
  * per-file mode: one item per FILE named by file name, contigs joined with
    ``max_dist_in_ref`` separator symbols that code to 5 (seq_reservoir.cpp:90-153)
  * ``no_parts`` is always 1 — the reference hardcodes it in append()
    (seq_reservoir.cpp:86), which makes the ids-file length correction a no-op
  * longest-first stable reorder with key (len - 2*no_parts) desc, name asc
    (seq_reservoir.cpp:215-251)
"""

from __future__ import annotations

import gzip
import os
import time

import numpy as np

from .packing import PackedCodes, pack3

CODE_A, CODE_C, CODE_G, CODE_T = 0, 1, 2, 3
CODE_N_REF = 4
CODE_N_SEQ = 5

#: bytes a load reads and parses at a time
INGEST_CHUNK = 4 << 20

_DNA_CODE = np.full(256, CODE_N_SEQ, dtype=np.uint8)
for _ch, _code in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    _DNA_CODE[ord(_ch)] = _code
    _DNA_CODE[ord(_ch.lower())] = _code


def encode_dna(seq_bytes: bytes) -> np.ndarray:
    """Map raw sequence bytes to 6-symbol codes (the oracle of the native
    ingest's coding)."""
    return _DNA_CODE[np.frombuffer(seq_bytes, dtype=np.uint8)]


def _open_bin(path: str):
    """Binary stream (plain, or inflated by Python's gzip); the native
    pass reads raw bytes and only header names are decoded (latin-1 = 1:1
    byte mapping)."""
    with open(path, "rb") as fh:
        magic = fh.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")
    return open(path, "rb")


def _cut_at_space(name: str) -> str:
    p = name.find(" ")
    return name if p < 0 else name[:p]


class SequenceStore:
    """Ordered collection of encoded sequences with names and lengths.

    Sequences are held PACKED at the reference's 3-codes-per-byte density
    (U3 parity: memory_monotonic.h:137-184 + seq_reservoir.cpp:22-58 —
    1/3 B per symbol instead of the 1 B unpacked array this store kept
    through round 3). ``store.codes`` is a :class:`PackedCodes` view:
    engines index/iterate it like a list (items unpack transiently), and
    the native all2all consumes the arena zero-copy via
    ``lza_all2all_packed``, unpacking per reference row / per query inside
    the worker exactly like the reference (parser.cpp:16-50).
    """

    def __init__(self):
        self.names: list[str] = []
        self.no_parts: list[int] = []
        self._packed: list[np.ndarray] = []   # per-item packed bytes
        self._slens: list[int] = []
        self._view: PackedCodes | None = None
        #: what the loads read (bytes, after gzip) and their seconds, from
        #: the first read to the last item stored
        self.ingest_bytes = 0
        self.ingest_s = 0.0

    def __len__(self) -> int:
        return len(self.names)

    @property
    def lengths(self) -> list[int]:
        return list(self._slens)

    @property
    def codes(self) -> PackedCodes:
        if self._view is None:
            self._view = PackedCodes(
                list(self._packed), np.array(self._slens, np.int64))
        return self._view

    @codes.setter
    def codes(self, lst) -> None:
        """Replace contents from a list of unpacked arrays (test hook)."""
        self._packed = [pack3(np.ascontiguousarray(c, np.uint8))
                        for c in lst]
        self._slens = [len(c) for c in lst]
        self._view = None

    def add(self, name: str, codes: np.ndarray) -> None:
        self.names.append(_cut_at_space(name))
        c = np.ascontiguousarray(codes, dtype=np.uint8)
        self._packed.append(pack3(c))
        self._slens.append(len(c))
        self.no_parts.append(1)
        self._view = None

    def load_multifasta(self, paths: list[str],
                        chunk: int = INGEST_CHUNK) -> None:
        """One item per '>' record, named by its header."""
        self._ingest(paths, False, 0, chunk)

    def load_fasta_per_file(self, paths: list[str], sep_len: int,
                            chunk: int = INGEST_CHUNK) -> None:
        """One item per FILE, named by the file's name; contigs joined with
        ``sep_len`` N-separators. Mirrors the reference exactly: a
        separator is appended on each '>' line whenever the accumulated
        sequence is non-empty (seq_reservoir.cpp:112-130), so empty records
        between non-empty ones still produce separators, and lines before
        the first header are sequence."""
        self._ingest(paths, True, sep_len, chunk)

    def _ingest(self, paths: list[str], per_file: bool, sep_len: int,
                chunk: int) -> None:
        """Read each file in chunks of `chunk` bytes (after gzip) through
        the native parser (``native_engine.FastaIngest``: one pass that
        finds the records, drops the line ends, codes and packs), so that
        ingest memory is the packed arena plus one chunk. Each finished
        record becomes an item, its packed bytes a view of the arena of
        the chunk that finished it."""
        from ..core.native_engine import FastaIngest

        t0 = time.perf_counter()
        buf = np.empty(chunk, np.uint8)
        for path in paths:
            name = os.path.basename(path) if per_file else None
            with _open_bin(path) as fh, FastaIngest(per_file, sep_len) as ing:
                while True:
                    n = fh.readinto(buf)
                    self.ingest_bytes += n
                    got = ing.feed(buf, n, final=n == 0)
                    if got is not None:
                        self._append(name, *got)
                    if n == 0:
                        break
        self.ingest_s += time.perf_counter() - t0

    def _append(self, name, names, name_offs, packed, offs, slens) -> None:
        no, po = name_offs.tolist(), offs.tolist()
        for i in range(len(slens)):
            self.names.append(names[no[i]:no[i + 1]] if name is None
                              else name)
            self._packed.append(packed[po[i]:po[i + 1]])
        self._slens += slens.tolist()
        self.no_parts += [1] * len(slens)
        self._view = None

    def reorder(self) -> np.ndarray:
        """Stable longest-first sort; returns ``reordering_map`` with
        ``new_id = map[old_id]`` (reference: reorder_items, seq_reservoir.cpp:215-251)."""
        n = len(self)
        order = sorted(
            range(n),
            key=lambda i: (-(self._slens[i] - 2 * self.no_parts[i]),
                           self.names[i].encode('latin-1'), i),
        )
        self.names = [self.names[i] for i in order]
        self._packed = [self._packed[i] for i in order]
        self._slens = [self._slens[i] for i in order]
        self.no_parts = [self.no_parts[i] for i in order]
        self._view = None
        remap = np.empty(n, dtype=np.uint32)
        for new_id, old_id in enumerate(order):
            remap[old_id] = new_id
        return remap


def load_store(params) -> SequenceStore:
    store = SequenceStore()
    if params.multisample_fasta:
        store.load_multifasta(params.input_file_names)
    else:
        store.load_fasta_per_file(params.input_file_names, params.max_dist_in_ref)
    return store
