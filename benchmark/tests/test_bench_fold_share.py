"""engine.fold_share on stub runs: 100 where every kernel pair of every
job was folded on the card, the share over the window's jobs where some
were not, and None without kernel pairs or without the fold's counter
(a program that does not fold)."""

import pytest

from benchmark import harness


class _Job:
    def __init__(self, stats, error=None):
        self.stats, self.error = stats, error


class _Run:
    def __init__(self, jobs):
        self.jobs = jobs

    ok_jobs = property(lambda self: [j for j in self.jobs
                                     if j.error is None])


def _read(jobs):
    return harness.load_reader(harness.ROOT, "engine.fold_share")(_Run(jobs))


def test_every_kernel_pair_folded_reads_100():
    jobs = [_Job({"kernel_pairs": 65_000, "fold_pairs": 65_000}),
            _Job({"kernel_pairs": 64_990, "fold_pairs": 64_990})]
    assert _read(jobs) == 100.0


def test_the_share_is_taken_over_the_window():
    jobs = [_Job({"kernel_pairs": 300, "fold_pairs": 300}),
            _Job({"kernel_pairs": 100, "fold_pairs": 0}),
            _Job({"kernel_pairs": 100, "fold_pairs": 0}, error="failed")]
    assert _read(jobs) == pytest.approx(75.0)


def test_no_kernel_pairs_or_no_counter_reads_none():
    assert _read([]) is None
    assert _read([_Job({"kernel_pairs": 0, "fold_pairs": 0})]) is None
    # a long-genome cell: its pairs are big_pairs
    assert _read([_Job({"kernel_pairs": 0, "fold_pairs": 0,
                        "big_pairs": 48})]) is None
    # a program without the fold's counter
    assert _read([_Job({"kernel_pairs": 65_280})]) is None
