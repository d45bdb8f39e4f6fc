"""The port's CLI accepts every backend name of the JAX package's CLI:
``jax`` (the automaton backend, triples folded on the device) and
``pallas`` (the event-log engine, ``cuda``), each byte-equal to the
native backend on the CPU device (the kernels' plain versions), with
and without a kmer-db filter; ``jax`` with an aln file is one native
pass; without a card both exit 1."""
import os

import numpy as np
import pytest
import torch

from lzani_tpu import cli as jcli
from lzani_tpu_torch import cli as tcli
from lzani_tpu_torch.synth import mutate, write_fasta
from lzani_tpu_torch.utils import cudadev

CPU = torch.device("cpu")
CANDIDATES = ["native", "cuda", "pallas", "jax", "hybrid", "auto", "tpu",
              "xla", "cpu", "gpu", "torch", "triton", "JAX", ""]


def _accepted(parse):
    names = set()
    for name in CANDIDATES:
        try:
            parse(["all2all", "--in-fasta", "x.fna", "--out", "y.tsv",
                   "--backend", name])
        except SystemExit:
            continue
        names.add(name)
    return names


def test_backend_names_equal_the_jax_clis():
    """The JAX CLI's names, and the port's own name of its event-log
    engine."""
    jax_names = _accepted(jcli.parse_args)
    assert jax_names == {"native", "pallas", "jax", "hybrid", "auto"}
    assert _accepted(tcli.parse_args) == jax_names | {"cuda"}
    assert set(tcli.BACKENDS) == jax_names | {"cuda"}


def _inputs(tmp_path, seed=5):
    """A FASTA of five related 700 bp genomes and an unrelated one, and a
    kmer-db filter over them (threshold 0.2 keeps 6 of its 9 entries: 12
    ordered pairs, every row with one at least)."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 4, 700).astype(np.uint8)
    codes = [mutate(rng, base, 0.01 + 0.03 * k, n_ns=k % 2, indels=k % 3)
             for k in range(5)] + [rng.randint(0, 4, 350).astype(np.uint8)]
    names = [f"s{k}" for k in range(len(codes))]
    fa = str(tmp_path / "in.fna")
    write_fasta(fa, names, codes)
    flt = str(tmp_path / "flt.txt")
    with open(flt, "w") as fh:
        fh.write("kmer-length: 18 fraction: 1," + ",".join(names) + "\n")
        fh.write("s0,2:0.9,3:0.5,6:0.1\n")
        fh.write("s1,4:0.3,5:0.25\n")
        fh.write("s2,5:0.05\n")
        fh.write("s3,6:0.4,1:0.6\n")
        fh.write("s4,1:0.1\n")
        fh.write("s5,\n")
    return fa, flt


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _same(a, b, aln=False):
    assert _read(a) == _read(b)
    assert _read(a[:-4] + ".ids.tsv") == _read(b[:-4] + ".ids.tsv")
    if aln:
        la, lb = _read(a + ".aln").splitlines(), _read(b + ".aln").splitlines()
        assert la[0] == lb[0] and sorted(la[1:]) == sorted(lb[1:])


@pytest.mark.parametrize("filtered", [False, True], ids=["dense", "kmerdb"])
def test_cli_jax_equals_native(tmp_path, filtered):
    fa, flt = _inputs(tmp_path)
    extra = ["--flt-kmerdb", flt, "0.2"] if filtered else []
    a, b = str(tmp_path / "n.tsv"), str(tmp_path / "j.tsv")
    common = ["--in-fasta", fa, "-t", "2", "-V", "0", *extra]
    assert tcli.main(["all2all", "--out", a, *common, "--backend",
                      "native"]) == 0
    rc, m = tcli.run(["all2all", "--out", b, *common, "--backend", "jax"],
                     device=CPU)
    assert rc == 0 and m.params.backend == "jax"
    _same(a, b)
    st = m.engine_stats
    pairs = 12 if filtered else 30
    assert st["fold_pairs"] + st["cap_fallbacks"] == pairs
    assert st["replay_mismatches"] == 0 and st["rows"] == 6


def test_cli_jax_with_alignment_is_one_native_pass(tmp_path, capsys):
    fa, _ = _inputs(tmp_path, seed=6)
    a, b = str(tmp_path / "n.tsv"), str(tmp_path / "j.tsv")
    common = ["--in-fasta", fa, "-t", "2", "-V", "1"]
    assert tcli.main(["all2all", "--out", a, "--out-alignment", a + ".aln",
                      *common, "--backend", "native"]) == 0
    capsys.readouterr()
    rc, m = tcli.run(["all2all", "--out", b, "--out-alignment", b + ".aln",
                      *common, "--backend", "jax"], device=CPU)
    assert rc == 0 and m._device_setup is None
    assert set(m.engine_stats) == {"ingest_bytes", "ingest_records",
                                   "ingest_s"}
    assert "served by the native engine (one pass)" in capsys.readouterr().err
    _same(a, b, aln=True)
    assert not os.path.exists(b + ".aln.regions.tmp")


def test_cli_pallas_equals_cuda(tmp_path):
    fa, flt = _inputs(tmp_path, seed=7)
    outs = {}
    for backend in ("cuda", "pallas"):
        out = str(tmp_path / f"{backend}.tsv")
        rc, m = tcli.run(["all2all", "--in-fasta", fa, "--out", out,
                          "--out-alignment", out + ".aln", "-t", "2", "-V",
                          "0", "--flt-kmerdb", flt, "0.2", "--backend",
                          backend], device=CPU)
        assert rc == 0 and m.params.backend == backend
        assert m.engine_stats["kernel_pairs"] == 12
        assert m.engine_stats["replay_mismatches"] == 0
        outs[backend] = out
    _same(outs["cuda"], outs["pallas"], aln=True)


@pytest.mark.parametrize("backend", ["jax", "pallas"])
def test_cli_without_a_card_exits_1(backend, tmp_path, monkeypatch, capsys):
    fa, _ = _inputs(tmp_path)
    monkeypatch.setattr(cudadev, "cuda_device_count", lambda: 0)
    out = tmp_path / "o.tsv"
    assert tcli.main(["all2all", "--in-fasta", fa, "--out", str(out),
                      "--backend", backend]) == 1
    assert (f"--backend {backend} needs a CUDA device"
            in capsys.readouterr().err)
    assert not out.exists()
