"""FASTA ingest and the in-memory sequence store.

Replaces the reference's ``CSeqReservoir`` (reference src/seq_reservoir.{h,cpp}).
Sequences are encoded to 6-symbol codes (A=0, C=1, G=2, T=3, query-N=5; the
reference's ref-N=4 substitution happens inside the engines) and held PACKED
at the reference's 3-codes-per-byte density (seq_reservoir.cpp:22-58 +
memory_monotonic.h:137-184 parity — 1/3 B per symbol). ``store.codes`` is a
``PackedCodes`` view: list-like for the Python engines (items unpack
transiently on access), zero-copy for the native all2all
(``lza_all2all_packed`` unpacks per reference row / per query inside the
worker, the reference's own schedule, parser.cpp:16-50).

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

import numpy as np

from .packing import PackedCodes, pack3

CODE_A, CODE_C, CODE_G, CODE_T = 0, 1, 2, 3
CODE_N_REF = 4
CODE_N_SEQ = 5

_DNA_CODE = np.full(256, CODE_N_SEQ, dtype=np.uint8)
for _ch, _code in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    _DNA_CODE[ord(_ch)] = _code
    _DNA_CODE[ord(_ch.lower())] = _code


def encode_dna(seq_bytes: bytes) -> np.ndarray:
    """Map raw sequence bytes to 6-symbol codes."""
    return _DNA_CODE[np.frombuffer(seq_bytes, dtype=np.uint8)]


def _open_bin(path: str):
    """Binary line stream (plain or gzip); the loaders work on raw bytes
    and only decode header names (latin-1 = 1:1 byte mapping), so the hot
    path never round-trips sequence data through str."""
    with open(path, "rb") as fh:
        magic = fh.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")
    return open(path, "rb")


def _record_spans(data: bytes):
    """Yield (header_start, header_line_end, body_end) for each '>' record.
    A '>' opens a header only at the start of a line (matching the
    reference's per-line first-char test)."""
    n = len(data)
    pos = 0
    # find the first header: '>' at offset 0 or right after a newline
    if data[:1] == b">":
        start = 0
    else:
        p = data.find(b"\n>")
        start = -1 if p < 0 else p + 1
    while start >= 0:
        hdr_end = data.find(b"\n", start)
        if hdr_end < 0:
            yield start, n, n
            return
        p = data.find(b"\n>", hdr_end)
        body_end = n if p < 0 else p + 1
        yield start, hdr_end, body_end
        start = -1 if p < 0 else p + 1


def _iter_records(fh, chunk: int = 32 << 20):
    """Stream b'>hdr\\n<body>' records from a binary file object with
    bounded memory (one chunk + one record). Content before the first
    header is dropped — the same semantics as _record_spans; a '>' opens
    a header only at the start of a line."""
    buf = bytearray()
    seen_header = False
    while True:
        data = fh.read(chunk)
        if not data:
            break
        buf += data
        if not seen_header:
            if buf[:1] == b">":
                seen_header = True
            else:
                p = buf.find(b"\n>")
                if p < 0:
                    del buf[:-1]  # keep 1 byte: "\n>" may span the boundary
                    continue
                del buf[:p + 1]
                seen_header = True
        while True:
            p = buf.find(b"\n>")
            if p < 0:
                break
            yield bytes(buf[:p + 1])
            del buf[:p + 1]
    if seen_header and buf:
        yield bytes(buf)


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

    def load_multifasta(self, paths: list[str]) -> None:
        """One item per '>' record, named by its header. Bulk parser: one
        Python iteration per RECORD, not per line (header scan via
        bytes.find, newline strip via bytes.translate) — the line loop the
        reference affords in C++ (seq_reservoir.cpp:156-212) would dominate
        ingest at the 10k-genome scale in Python. Files stream in bounded
        chunks so ingest RSS is (packed arena + one record), not the file."""
        for path in paths:
            with _open_bin(path) as fh:
                for rec in _iter_records(fh):
                    hdr_end = rec.find(b"\n")
                    if hdr_end < 0:
                        hdr_end = len(rec)
                    name = rec[1:hdr_end].rstrip(b"\r").decode("latin-1")
                    if not name:
                        continue  # reference: empty header never stored
                    body = rec[hdr_end:].translate(None, b"\r\n")
                    self.add(name, encode_dna(body))

    def load_fasta_per_file(self, paths: list[str], sep_len: int) -> None:
        """One item per FILE; contigs joined with ``sep_len`` N-separators.
        Mirrors the reference exactly: a separator is appended on each '>'
        line whenever the accumulated sequence is non-empty
        (seq_reservoir.cpp:112-130), so empty records between non-empty
        ones still produce separators."""
        sep = b"\x00" * sep_len  # NUL codes to 5 (CODE_N_SEQ) like any non-ACGT
        for path in paths:
            with _open_bin(path) as fh:
                data = fh.read()
            chunks: list[bytes] = []
            total = 0
            spans = list(_record_spans(data))
            # lines before the first header are sequence (reference parity)
            pre_end = spans[0][0] if spans else len(data)
            pre = data[:pre_end].translate(None, b"\r\n")
            if pre:
                chunks.append(pre)
                total += len(pre)
            for start, hdr_end, body_end in spans:
                if total:
                    chunks.append(sep)
                    total += sep_len
                body = data[hdr_end:body_end].translate(None, b"\r\n")
                chunks.append(body)
                total += len(body)
            self.add(os.path.basename(path), encode_dna(b"".join(chunks)))

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
