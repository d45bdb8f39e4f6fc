"""The work count behind kernels.roofline, on cases worked by hand."""

import pytest

from benchmark import work


def test_all_pairs_work_by_hand():
    # genomes of 10, 20 and 30 symbols: 6 ordered pairs; each genome is
    # the query of 2 pairs: compares 2 * (10 + 20 + 30) = 120; bytes: 60
    # symbols at 3 bits = 22.5, plus 6 triples of 12 bytes = 72
    c, b, pairs = work.all_pairs_work([10, 20, 30])
    assert (c, b, pairs) == (120.0, 94.5, 6)
    assert work.all_pairs_work([5]) == (0.0, 1.875, 0)


def test_least_seconds_takes_the_larger_bound():
    peak = {"compares_per_s": 10.0, "hbm_bytes_per_s": 2.0}
    assert work.least_seconds(100.0, 10.0, peak) == (10.0, "compares")
    assert work.least_seconds(10.0, 100.0, peak) == (50.0, "bytes")


def test_the_h100_peaks():
    peak = work.peaks("NVIDIA H100 80GB HBM3")
    assert peak["hbm_bytes_per_s"] == pytest.approx(3.35e12)
    assert peak["compares_per_s"] == pytest.approx(67e12)
    assert work.peaks("a card not in the table") is None
