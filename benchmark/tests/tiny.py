"""A small cell in a directory of its own, for the tests: a copy of the
repository's ``BENCHMARK.json`` with one more configuration, mix, cell and
metric, each in a new file, found by the harness by name."""

from __future__ import annotations

import json
import os
import shutil

from benchmark import harness

NEW_METRIC = '''"""bench_jobs: jobs in the window (a metric a later change adds)."""


def read(run):
    return float(len(run.jobs))
'''


def make_root(path, genomes=10, min_len=2000, max_len=5000, families=3,
              related=3, random=3) -> str:
    """`path` as a checkout with a cell ``tiny`` (configuration
    ``viral-tiny``, mix ``fam3``) and a per-layer metric ``bench_jobs``,
    none of them in the repository; returns the root."""
    root = str(path)
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    bench = os.path.join(root, "benchmark")
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(harness.BENCH_DIR, sub),
                        os.path.join(bench, sub))
    with open(os.path.join(bench, "configs", "viral-default.json")) as fh:
        cfg = json.load(fh)
    cfg.update(name="viral-tiny", warm_genomes=4,
               collection={"genomes": genomes, "min_len": min_len,
                           "max_len": max_len},
               check={"related": related, "random": random})
    with open(os.path.join(bench, "configs", "viral-tiny.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(bench, "traffic", "families.json")) as fh:
        mix = json.load(fh)
    mix.update(families=families, unrelated_share=0.2)
    with open(os.path.join(bench, "traffic", "fam3.json"), "w") as fh:
        json.dump(mix, fh)
    with open(os.path.join(bench, "metrics", "bench_jobs.py"), "w") as fh:
        fh.write(NEW_METRIC)
    spec["configs"].append({"name": "viral-tiny", "source": "test",
                            "file": "benchmark/configs/viral-tiny.json",
                            "reduced": ["genomes"], "why": "tests"})
    spec["workloads"].append({"name": "tiny", "config": "viral-tiny",
                              "traffic": "fam3", "chips": 1, "why": "tests"})
    for m in spec["per_layer"]:
        m["workloads"].append("tiny")
    spec["per_layer"].append({"name": "bench_jobs", "unit": "jobs",
                              "better": "higher", "source": "host_clock",
                              "layer": "matcher: ingest and reorder",
                              "moves": "pairs_per_s", "workloads": ["tiny"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)
    return root
