"""The port's multi-process CLI launch, the counterpart of
tests/test_multihost_cli.py: two processes run the same
``lzani_tpu_torch.cli.run(argv, device="cpu")`` invocation with the JAX
package's launch variables set, each computes its stride share of the
reference rows with the selected backend, the triples and region records
are gathered to process 0 over gloo, and process 0's outputs must equal a
single-process ``--backend native`` run: TSV and ids byte for byte, the
aln file as a set. Process 1 writes no file. A launch whose coordinator
cannot be reached, or one of whose processes fails, exits non-zero."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from lzani_tpu_torch.synth import write_fasta

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# FAIL_PROCESS: that process's native engine raises (a failed rank);
# RENDEZVOUS_S: the rendezvous limit, shortened for the unreachable case
RUNNER = """
import os, sys
from datetime import timedelta
from lzani_tpu_torch.cli import run
from lzani_tpu_torch.core import native_engine
from lzani_tpu_torch.parallel import distributed

if os.environ.get("FAIL_PROCESS", "-") == os.environ.get("JAX_PROCESS_ID"):
    def failed(*args, **kwargs):
        raise RuntimeError("injected failure")
    native_engine.all2all = failed
if os.environ.get("RENDEZVOUS_S"):
    distributed.RENDEZVOUS_TIMEOUT = timedelta(
        seconds=float(os.environ["RENDEZVOUS_S"]))
raise SystemExit(run(sys.argv[1:], device="cpu")[0])
"""


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """tests/test_multihost_cli.py's set: 7 relatives of a 900 bp base
    and one unrelated genome."""
    rng = np.random.RandomState(5)
    base = rng.randint(0, 4, 900).astype(np.uint8)
    codes = []
    for i in range(7):
        c = base.copy()
        m = rng.rand(len(c)) < 0.02 * (i + 1)
        c[m] = (c[m] + rng.randint(1, 4, m.sum())) % 4
        codes.append(c[: 900 - 40 * i])
    codes.append(rng.randint(0, 4, 500).astype(np.uint8))
    d = tmp_path_factory.mktemp("tmh")
    path = str(d / "set.fna")
    write_fasta(path, [f"s{k:04d}" for k in range(len(codes))], codes)
    single = str(d / "single.tsv")
    res = _start(["all2all", "--in-fasta", path, "--out", single,
                  "--out-alignment", single + ".aln", "-t", "2", "-V", "0",
                  "--backend", "native"], {}).communicate(timeout=300)
    assert os.path.exists(single), res[1][-2000:]
    return path, single


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(args, env):
    e = {k: v for k, v in os.environ.items()
         if k != "PYTHONPATH" and not k.startswith("JAX_")}
    e.update(env)
    return subprocess.Popen([sys.executable, "-c", RUNNER] + args, cwd=REPO,
                            env=e, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _launch(fasta_path, outs, backend, extra_env=None):
    """Start both processes of a launch; returns [(rc, stderr)]."""
    port = _free_port()
    procs = []
    for pid in range(2):
        env = {"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
               "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": str(pid),
               "LZANI_TPU_HYBRID_GREEDY": "1", **(extra_env or {})}
        procs.append(_start(["all2all", "--in-fasta", fasta_path, "--out",
                             outs[pid], "--out-alignment", outs[pid] + ".aln",
                             "-t", "2", "-V", "1", "--backend", backend],
                            env))
    errs = [p.communicate(timeout=300)[1] for p in procs]
    return [(p.returncode, err) for p, err in zip(procs, errs)]


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("backend", ["native", "cuda", "hybrid"])
def test_two_process_cli_matches_single_native(backend, fasta, tmp_path):
    path, single = fasta
    outs = [str(tmp_path / f"p{pid}.tsv") for pid in range(2)]
    res = _launch(path, outs, backend)
    for pid, (rc, err) in enumerate(res):
        assert rc == 0, err[-2000:]
        assert f"multi-host: process {pid}/2 owns 4 reference rows" in err
        assert "multi-host: merged triples from 2 processes" in err
    assert _read(outs[0]) == _read(single)
    assert _read(outs[0][:-4] + ".ids.tsv") == _read(single[:-4] + ".ids.tsv")
    la = _read(single + ".aln").splitlines()
    lb = _read(outs[0] + ".aln").splitlines()
    assert la[0] == lb[0] and sorted(la[1:]) == sorted(lb[1:])
    # process 1 wrote nothing, and no share's region file is left
    assert sorted(os.listdir(tmp_path)) == ["p0.ids.tsv", "p0.tsv",
                                            "p0.tsv.aln"]


def test_a_failed_process_fails_the_launch(fasta, tmp_path):
    path, _ = fasta
    outs = [str(tmp_path / f"p{pid}.tsv") for pid in range(2)]
    res = _launch(path, outs, "native", {"FAIL_PROCESS": "1"})
    assert res[1][0] != 0 and "injected failure" in res[1][1]
    assert res[0][0] != 0, res[0][1][-2000:]
    assert not os.listdir(tmp_path)


def test_an_unreachable_coordinator_fails_the_launch(fasta, tmp_path):
    """Process 1 alone: the rendezvous times out and the CLI exits
    non-zero; it never runs single-process."""
    path, _ = fasta
    out = str(tmp_path / "p1.tsv")
    p = _start(["all2all", "--in-fasta", path, "--out", out, "-V", "1",
                "--backend", "native"],
               {"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{_free_port()}",
                "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "1",
                "RENDEZVOUS_S": "2"})
    _, err = p.communicate(timeout=120)
    assert p.returncode != 0
    assert "multi-host" not in err
    assert not os.listdir(tmp_path)
