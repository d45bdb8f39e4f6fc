"""The automaton backend's cell (``viral-fold``: ``viral-automaton`` x
``families``). On the CPU, a small copy of the cell with ``"backend":
"jax"`` runs through the harness with the kernels' plain versions: a
sound traced run is correct, counts every pair and reports the row
loop's span readings; a fault planted in ``all2all_jax``'s triples makes
it incorrect. On a card (marked ``cuda``), one short run of the cell
through the benchmark's command, untraced and traced, each correct;
traced, its five readings are there and the roofline share lies in
(0, 100]. Run on a card:

    python -m pytest -p no:cacheprovider -m cuda \\
        benchmark/tests/test_bench_automaton.py
"""

import json
import subprocess
import sys
import time

import pytest

from benchmark import harness
from benchmark.tests import tiny
from lzani_tpu_torch.ops import engine_jax

SEED = 2**31 + 23
#: the cell's readings; the device's read None on the CPU
HOST_METRICS = {"automaton.index_s", "automaton.download_s"}
DEVICE_METRICS = {"kernels.row_parse_device_s", "kernels.fold_device_s",
                  "kernels.automaton_roofline"}


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    cell = harness.load_cell(tiny.make_root(tmp_path_factory.mktemp("root")),
                             "tiny")
    cell["config"] = dict(cell["config"], backend="jax")
    return cell


def _run(cell, trace=False):
    return harness.run(cell, SEED, 0.01, trace, time.perf_counter(),
                       device="cpu")


def test_the_cell_is_the_viral_deployment_on_the_automaton_backend():
    """``viral-fold`` runs ``viral-default``'s parameters, collection,
    warm job and check on the same traffic as ``viral-cuda``, with only
    the backend changed."""
    fold = harness.load_cell(harness.ROOT, "viral-fold")
    cuda = harness.load_cell(harness.ROOT, "viral-cuda")
    assert fold["config"]["backend"] == "jax"
    assert fold["traffic"] == cuda["traffic"]
    for key in ("params", "threads", "output", "collection", "warm_genomes",
                "check"):
        assert fold["config"][key] == cuda["config"][key], key
    # a deployment of its own: it names the Vclust paper, where viral-default
    # names the Vclust repository
    assert fold["config"]["source"] != cuda["config"]["source"]
    assert fold["cell"]["chips"] == 1
    assert {m["name"] for m in fold["per_layer"]} == HOST_METRICS | \
        DEVICE_METRICS
    assert [m["name"] for m in fold["end_to_end"]] == ["pairs_per_s",
                                                       "setup_s"]


def test_a_sound_automaton_run_is_correct(cell):
    out = _run(cell, trace=True)
    assert out["correct"], out["checks"]
    assert all(v["value"] == 0 for v in out["checks"].values())
    assert out["attempted"] == 90 and out["failed"] == 0
    got = out["metrics"]
    for m in HOST_METRICS:
        assert got[m]["unit"] == "s" and got[m]["value"] > 0, m
    assert not DEVICE_METRICS & set(got)


def test_one_automaton_triple_altered_is_not_correct(cell, monkeypatch):
    real = engine_jax.all2all_jax

    def broken(codes, params, **kw):
        out = real(codes, params, **kw)
        out[..., 0] += 1
        return out
    monkeypatch.setattr(engine_jax, "all2all_jax", broken)
    out = _run(cell)
    assert not out["correct"]
    assert out["checks"]["sampled_lines_differ"]["value"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_automaton_run_on_the_card_is_correct(trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "viral-fold",
         "--seed", str(2**31 + 201 + trace), "--seconds", "1", "--trace",
         str(trace)],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["failed"] == 0
    got = {k: v["value"] for k, v in out["metrics"].items()}
    if not trace:
        assert set(got) == {"pairs_per_s", "setup_s"}
        return
    assert set(got) == HOST_METRICS | DEVICE_METRICS, sorted(got)
    assert 0 < got["kernels.automaton_roofline"] <= 100
    assert all(got[m] > 0 for m in got)
