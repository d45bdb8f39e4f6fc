"""On a card: one short run of each cell through the benchmark's
command, its result line correct. Without a card: the command exits with a
code other than 0 and prints no result."""

import json
import subprocess
import sys

import pytest

from benchmark import harness


def _run(workload, seconds):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", "2147483659", "--seconds", str(seconds), "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = _run("viral-cuda", 1)
    assert res.returncode != 0 and res.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["viral-cuda", "viral-dissim-cuda"])
def test_a_short_run_on_the_card_is_correct(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = _run(workload, 1)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert set(out["metrics"]) == {"pairs_per_s", "setup_s"}
