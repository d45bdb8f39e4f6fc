"""The work of an all-vs-all parse, counted from the genomes and the pair
set alone (never from the program's buffers), and the least time a card
could take for it.

Operations: one symbol comparison per query position of every pair.
Bytes: every symbol of the genomes those pairs touch, read once at 3 bits,
and each pair's (matches, literals, components) triple of 12 bytes,
written once. The least time is the larger of compares over the peak
compare rate and bytes over the peak bandwidth (``peaks.json``).
"""

from __future__ import annotations

import json
import os

import numpy as np

PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "peaks.json")


def all_pairs_work(lengths) -> tuple[float, float, int]:
    """(compares, bytes, pairs) of every ordered pair of a collection of
    genomes with these lengths: each genome is the query of n - 1 pairs."""
    ln = np.asarray(lengths, np.float64)
    n = len(ln)
    pairs = n * (n - 1)
    return float(ln.sum() * (n - 1)), float(ln.sum() * 3 / 8 + 12 * pairs), \
        pairs


def peaks(kind: str) -> dict | None:
    """The peak rates of the card named `kind`, or None."""
    with open(PEAKS) as fh:
        return json.load(fh).get(kind)


def least_seconds(compares: float, nbytes: float, peak: dict):
    """(least seconds, the bound that sets it: "compares" or "bytes")."""
    tc = compares / peak["compares_per_s"]
    tb = nbytes / peak["hbm_bytes_per_s"]
    return (tc, "compares") if tc >= tb else (tb, "bytes")
