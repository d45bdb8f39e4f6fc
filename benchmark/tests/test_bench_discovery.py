"""The harness finds a configuration, a traffic mix, a cell and a metric
by name, so a later change adds them as new files and entries; and the
repository's BENCHMARK.json keeps to the form its schema sets."""

import json
import os
import re

from benchmark import harness
from benchmark.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_new_files_are_found_by_name(tmp_path):
    root = tiny.make_root(tmp_path)
    cell = harness.load_cell(root, "tiny")
    assert cell["config"]["name"] == "viral-tiny"
    assert cell["traffic"]["families"] == 3
    assert [m["name"] for m in cell["per_layer"]][-1] == "bench_jobs"
    assert [m["name"] for m in cell["end_to_end"]] == ["pairs_per_s",
                                                       "setup_s"]
    read = harness.load_reader(root, "bench_jobs")

    class _Run:
        jobs = [1, 2, 3]
    assert read(_Run()) == 3.0
    # the repository's own cells still load, from the new root too
    assert harness.load_cell(root, "viral-cuda")["config"]["name"] == \
        "viral-default"


def test_benchmark_json_keeps_its_form():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert all(PATH.match(p) and os.path.isdir(os.path.join(harness.ROOT, p))
               for p in spec["paths"])
    assert 1 <= spec["run_seconds"] <= 51
    names = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        with open(os.path.join(harness.ROOT, c["file"])) as fh:
            body = json.load(fh)
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert set(c["reduced"]) <= set(body["reduced"])
        names.add(c["name"])
    cells = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and NAME.match(w["name"])
        assert os.path.exists(os.path.join(
            harness.BENCH_DIR, "traffic", w["traffic"] + ".json"))
        cells.add(w["name"])
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(harness.BENCH_DIR, "metrics",
                                           m["name"] + ".py"))
        assert set(m.get("workloads", cells)) <= cells
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
