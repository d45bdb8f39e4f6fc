"""``correct`` comes out false when the timed path is broken underneath,
and true when it is not. The harness runs a whole (small) cell on the CPU
with the kernels' plain versions, skipping only its look for a card; each
fault is planted in the cuda engine's answers, where they are produced:
the engine returning its output unchanged, half of the batch left out,
and one answer altered. (A cell on one card has no exchange between
cards to leave out.) The control, the reference in float32, fails the
same comparison, in a viral and a bacterial cell."""

import json
import os
import time

import numpy as np
import pytest

from benchmark import check, control, generate, harness
from benchmark.reference import tsv
from benchmark.tests import tiny
from lzani_tpu_torch.ops import cuda_engine

SEED = 2**31 + 11


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    root = tiny.make_root(tmp_path_factory.mktemp("root"))
    return harness.load_cell(root, "tiny")


def _run(cell, trace=False):
    return harness.run(cell, SEED, 0.01, trace, time.perf_counter(),
                       device="cpu")


def _longest_related(cell):
    """The sampled pair the check always holds, in the tool's ids."""
    cfg = cell["config"]
    names, codes, fam = generate.collection(SEED, 0, cfg["collection"],
                                            cell["traffic"])
    a, b = check.draw_sample(SEED, 0, fam, [len(c) for c in codes], 0, 0)[0]
    order = tsv.reorder(names, [len(c) for c in codes])
    return order.index(a), order.index(b)


def _plant(monkeypatch, fault):
    real = cuda_engine.all2all_cuda

    def broken(codes, params, **kw):
        return fault(real(codes, params, **kw))
    monkeypatch.setattr(cuda_engine, "all2all_cuda", broken)


def test_a_sound_run_is_correct(cell):
    out = _run(cell, trace=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] == 90 and out["failed"] == 0
    assert out["metrics"]["bench_jobs"]["value"] == 1.0
    assert list(out)[-1] == "checks"


def test_output_left_unchanged_is_not_correct(cell, monkeypatch):
    _plant(monkeypatch, np.zeros_like)
    assert not _run(cell)["correct"]


def test_half_the_batch_left_out_is_not_correct(cell, monkeypatch):
    def half(out):
        out[1::2] = 0
        return out
    _plant(monkeypatch, half)
    assert not _run(cell)["correct"]


def test_one_answer_altered_is_not_correct(cell, monkeypatch):
    r, q = _longest_related(cell)

    def alter(out):
        out[r, q - 1 if q > r else q, 0] += 1
        return out
    _plant(monkeypatch, alter)
    out = _run(cell)
    assert not out["correct"]
    assert out["checks"]["sampled_lines_differ"]["value"] >= 1


def test_control_in_float32_is_not_correct():
    """The control at a size a test run holds: 30 viral genomes of 5-15
    kb, 25 sampled pairs a collection, on three seeds; the reference in
    double, put in the same place, passes."""
    cell = harness.load_cell(harness.ROOT, "viral-cuda")
    cell["config"] = dict(cell["config"], collection={
        "genomes": 30, "min_len": 5000, "max_len": 15000})
    cell["traffic"] = dict(cell["traffic"], families=5)
    for seed in (1, 2, 3):
        nums = control.control_numbers(cell, seed)
        assert nums["sampled_lines_differ"] > 0, seed
        assert control.control_numbers(cell, seed, "float64")[
            "sampled_lines_differ"] == 0


def test_bacterial_control_in_float32_is_not_correct():
    """The check of the bacterial configuration and mix, kept for a later
    cell (``bacterial-tuned`` x ``species``: 21 pairs of one species and 2
    random ones a collection, on worker processes), at a size a test run
    holds: species of 60 and 90 kb, 16 genomes a collection, three
    seeds."""
    cell = harness.load_cell(harness.ROOT, "viral-cuda")
    with open(os.path.join(harness.BENCH_DIR, "configs",
                           "bacterial-tuned.json")) as fh:
        config = json.load(fh)
    with open(os.path.join(harness.BENCH_DIR, "traffic",
                           "species.json")) as fh:
        cell["traffic"] = json.load(fh)
    cell["config"] = dict(config, collection={
        "species_lengths": [60000, 90000]},
        check=dict(config["check"], workers=2))
    for seed in (1, 2, 3):
        nums = control.control_numbers(cell, seed)
        assert nums["pairs"] == 2 * (1 + 20 + 2)
        assert nums["sampled_lines_differ"] > 0, seed
