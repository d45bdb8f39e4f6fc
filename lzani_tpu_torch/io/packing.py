"""Packed symbol storage: three 6-valued codes per byte (radix 216).

Reference parity: the reservoir's three-in-byte packing and the
`seq_view` positional codec (reference src/seq_reservoir.h:30-186,
seq_reservoir.cpp:22-58). The reference packs to cut the resident set of
large genome collections by 3x and unpacks per pair in the hot loop; here
the same radix-216 layout is the DEVICE transfer/storage codec: the
production driver lays the query matrix out from the items' bytes
(ops/cuda_engine.query_rows), sends it once, derives each reference's
composite buffer from its rows on the device (dev_ref_buffers) and
expands to int32 on device per dispatch (dev_unpack3), so device-resident
bytes/symbol match the reference's 1/3 B density and uploads shrink 3x.

Codes are 0..5 (A,C,G,T, N_ref, N_seq — defs.h:24-30); byte value is
c0*36 + c1*6 + c2, trailing slots padded with 0 and resolved by the
stored length.
"""

from __future__ import annotations

import numpy as np

_POW = np.array([36, 6, 1], np.uint16)

# decode LUT: byte -> 3 codes (the reference builds triples[256][4] at
# static init, seq_reservoir.h:38-53)
_LUT = np.zeros((256, 3), np.uint8)
for _b in range(216):
    _LUT[_b] = (_b // 36, (_b // 6) % 6, _b % 6)


def pack3(codes: np.ndarray) -> np.ndarray:
    """uint8 codes (values 0..5) -> packed uint8, 3 per byte."""
    n = len(codes)
    pad = (-n) % 3
    c = np.concatenate([codes, np.zeros(pad, np.uint8)]).reshape(-1, 3)
    return (c.astype(np.uint16) * _POW).sum(1).astype(np.uint8)


def unpack3(packed: np.ndarray, n: int) -> np.ndarray:
    """Packed uint8 -> first n codes."""
    return _LUT[packed].reshape(-1)[:n].copy()


class PackedCodes:
    """List-like view over per-item 3-in-byte packed chunks (U3 parity:
    memory_monotonic.h:137-184 + the reservoir's packed density).

    ``codes[i]`` unpacks on demand (tiny thread-safe MRU memo — the hybrid
    finalizer touches the same reference for many pairs in a row); the
    native engine consumes the per-item pointer table zero-copy via
    ``lza_all2all_packed`` (an item may be a view into the packed arena of
    the ingest chunk that finished it; no arena of the whole store is
    built, so ingest peak RSS is the packed bytes plus one chunk).
    Slicing returns a sub-view sharing the chunks.
    """

    __slots__ = ("chunks", "slens", "_ptrs", "_memo", "_lock")

    _MEMO_CAP = 8

    def __init__(self, chunks: list, slens: np.ndarray):
        self.chunks = chunks
        self.slens = np.ascontiguousarray(slens, np.int64)
        self._ptrs = None
        self._memo: dict[int, np.ndarray] = {}
        import threading
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.slens)

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self.chunks)

    @property
    def ptrs(self) -> np.ndarray:
        """uint64 per-item data pointers for the native engine."""
        if self._ptrs is None:
            self._ptrs = np.array(
                [c.ctypes.data for c in self.chunks], np.uint64)
        return self._ptrs

    def seq_len(self, i: int) -> int:
        """O(1) symbol length (no unpack)."""
        return int(self.slens[i])

    def _unpack(self, i: int) -> np.ndarray:
        return unpack3(self.chunks[i], int(self.slens[i]))

    def __getitem__(self, i):
        if isinstance(i, slice):
            return PackedCodes(self.chunks[i], self.slens[i])
        if i < 0:
            i += len(self.slens)
        with self._lock:
            c = self._memo.get(i)
            if c is not None:
                return c
        c = self._unpack(i)
        with self._lock:
            if len(self._memo) >= self._MEMO_CAP:
                self._memo.pop(next(iter(self._memo)))
            self._memo[i] = c
        return c

    def __iter__(self):
        # bulk iteration bypasses the memo (one transient unpack at a time)
        for i in range(len(self.slens)):
            yield self._unpack(i)


def pack_items(codes_list) -> PackedCodes:
    """Pack a list of uint8 code arrays into a PackedCodes view."""
    chunks = [pack3(np.ascontiguousarray(c, np.uint8)) for c in codes_list]
    slens = np.array([len(c) for c in codes_list], np.int64)
    return PackedCodes(chunks, slens)


class PackedSeq:
    """A packed sequence with transparent code access."""

    __slots__ = ("data", "n")

    def __init__(self, codes: np.ndarray):
        self.data = pack3(np.ascontiguousarray(codes, np.uint8))
        self.n = len(codes)

    def __len__(self) -> int:
        return self.n

    def codes(self) -> np.ndarray:
        return unpack3(self.data, self.n)

    def __getitem__(self, i: int) -> int:
        b = self.data[i // 3]
        return int(_LUT[b, i % 3])

    @property
    def nbytes(self) -> int:
        return self.data.nbytes
