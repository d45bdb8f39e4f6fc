"""On a card: one short run of the long-genome cell ``bacterial-cuda``
through the benchmark's command, untraced and traced, its result line
correct; traced, the long-genome path's six readings are all there, its
device stages inside the engine's join and prep, and the kernel's
roofline share between 0 and 100%. Run on a card:

    python -m pytest -p no:cacheprovider -m cuda \\
        benchmark/tests/test_bench_bacterial.py
"""

import json
import subprocess
import sys

import pytest

from benchmark import harness

BIG_METRICS = {"big.kmers_device_s", "big.sort_device_s",
               "big.search_device_s", "big.next_hit_device_s",
               "replay.big_wall_s", "kernels.big_roofline"}


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_bacterial_run_on_the_card_is_correct(trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "bacterial-cuda",
         "--seed", str(2**31 + 101 + trace), "--seconds", "1", "--trace",
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
    assert set(got) == BIG_METRICS, sorted(got)
    assert 0 < got["kernels.big_roofline"] < 100
    assert all(got[m] > 0 for m in BIG_METRICS)
