"""kmer-db sparse pair-filter parsing.

Equivalent of the reference's ``CFilter`` (reference src/filter.{h,cpp}):
  * header line = comma-separated sequence names with the first token dropped
    (filter.cpp:34-44)
  * each following row: ``name,<id>:<val>,...`` with **1-based** ids
    (filter.cpp:75); keep entries with ``val >= thr``; symmetrize (:80-82)
  * rows shorter than 3 characters are skipped and do not consume a row id
    (filter.cpp:104-112)
  * after the longest-first reorder, rows are permuted and every stored id is
    renumbered through the reordering map (filter.cpp:301-345)

The production loader hands the decompressed body to the threaded native
tokenizer (``lza_parse_kmerdb`` — the analog of the reference's
reader+N-parser pipeline, filter.cpp:95-246) and keeps the symmetrized
result in CSR form; the pure-Python ``load_py`` is retained as the
reference implementation for differential tests.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass, field

import numpy as np


def _split_drop_trailing_empty(s: str) -> list[str]:
    """Reference ``split`` (utils.cpp:16-37): keeps interior empty tokens,
    drops only a trailing empty one."""
    parts = s.split(",")
    if parts and parts[-1] == "":
        parts.pop()
    return parts


def _read_raw(path: str) -> bytes:
    with open(path, "rb") as fh:
        head = fh.read(2)
        rest = fh.read()
    raw = head + rest
    if head == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    return raw


@dataclass
class PairFilter:
    names: list[str] = field(default_factory=list)
    indptr: np.ndarray = field(
        default_factory=lambda: np.zeros(1, np.int64))
    ids: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    total: int = 0

    def is_empty(self) -> bool:
        return self.total == 0

    @property
    def rows(self) -> list[list[int]]:
        """Materialized row lists (tests/small-scale use only)."""
        return [self.ids[self.indptr[i]:self.indptr[i + 1]].tolist()
                for i in range(len(self.indptr) - 1)]

    @staticmethod
    def load(path: str, thr: float) -> "PairFilter":
        raw = _read_raw(path)
        nl = raw.find(b"\n")
        header_b = raw if nl < 0 else raw[:nl]
        body = b"" if nl < 0 else raw[nl + 1:]
        header = header_b.decode("latin-1").rstrip("\r")
        names = _split_drop_trailing_empty(header)
        if len(names) <= 2:
            raise ValueError("Incorrect kmer-db filter file")
        names = names[1:]
        n = len(names)

        from ..core import native_engine
        indptr, ids = native_engine.parse_kmerdb_csr(body, thr, n)
        return PairFilter(names=names, indptr=indptr, ids=ids,
                          total=int(indptr[-1]))

    @staticmethod
    def load_py(path: str, thr: float) -> "PairFilter":
        """Single-threaded pure-Python loader (reference implementation
        for the differential test of the native tokenizer)."""
        with open(path, "rb") as fh:
            magic = fh.read(2)
        if magic == b"\x1f\x8b":
            fh = gzip.open(path, "rt", encoding="latin-1")
        else:
            fh = open(path, "rt", encoding="latin-1")
        with fh:
            header = fh.readline().rstrip("\n").rstrip("\r")
            names = _split_drop_trailing_empty(header)
            if len(names) <= 2:
                raise ValueError("Incorrect kmer-db filter file")
            names = names[1:]

            rows: list[list[int]] = [[] for _ in names]
            row_id = 0
            for line in fh:
                line = line.rstrip("\n").rstrip("\r")
                if len(line) <= 2:
                    continue
                for tok in _split_drop_trailing_empty(line):
                    elem = tok.split(":")
                    if len(elem) != 2:
                        continue
                    val = float(elem[1])
                    if val >= thr:
                        other = int(elem[0]) - 1  # kmer-db ids are 1-based
                        rows[row_id].append(other)
                        rows[other].append(row_id)
                row_id += 1

        n = len(names)
        indptr = np.zeros(n + 1, np.int64)
        for i, row in enumerate(rows):
            indptr[i + 1] = indptr[i] + len(row)
        ids = np.zeros(int(indptr[-1]), np.int32)
        for i, row in enumerate(rows):
            ids[indptr[i]:indptr[i + 1]] = row
        return PairFilter(names=names, indptr=indptr, ids=ids,
                          total=int(indptr[-1]))

    def reorder(self, remap: np.ndarray) -> None:
        """Permute rows and renumber ids through the longest-first
        reordering map (filter.cpp:301-345) — vectorized."""
        remap = np.asarray(remap, np.int64)
        n = len(self.indptr) - 1
        lens = np.diff(self.indptr)
        new_lens = np.zeros_like(lens)
        new_lens[remap[:n]] = lens
        new_indptr = np.zeros(n + 1, np.int64)
        np.cumsum(new_lens, out=new_indptr[1:])
        if len(self.ids):
            dest = (np.repeat(new_indptr[remap[:n]], lens)
                    + np.arange(len(self.ids))
                    - np.repeat(self.indptr[:-1], lens))
            new_ids = np.zeros_like(self.ids)
            new_ids[dest] = remap[self.ids].astype(np.int32)
        else:
            new_ids = self.ids
        self.indptr = new_indptr
        self.ids = new_ids

    def indptr_ids(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        """CSR layout for the engines."""
        assert len(self.indptr) - 1 == n
        return self.indptr, self.ids
