"""The port's own copies of the JAX package's host layer equal the
originals: ``parse_args`` on a set of argv lists, ``textnum`` on random
values, the native engine (its own build of ``csrc/lzani_core.cpp``) on
``synth.small_family`` with random parameters, and the port's
``--backend native`` CLI against ``lzani_tpu.cli --backend native`` (TSV
and ids byte-equal, aln as a set)."""
import dataclasses
import os

import numpy as np
import pytest

from lzani_tpu import cli as jcli
from lzani_tpu.core import native_engine as jne
from lzani_tpu.utils import textnum as jtn
from lzani_tpu_torch import cli as tcli
from lzani_tpu_torch.core import native_engine as tne
from lzani_tpu_torch.params import Params
from lzani_tpu_torch.synth import (mutate, rand_params, small_family,
                                   write_fasta)
from lzani_tpu_torch.utils import textnum as ttn

ARGVS = [
    ["all2all", "--in-fasta", "x.fna", "--out", "y.tsv"],
    ["all2all", "--in-fasta", "x.fna", "-o", "y.tsv", "-a", "20", "-s",
     "11", "-g", "80", "-r", "33", "-q", "29", "--aw", "12", "--am", "5",
     "--ar", "2", "-t", "3", "-V", "2"],
    ["all2all", "--in-fasta", "x.fna", "--out", "y.txt", "--out-type",
     "single-txt", "--out-format", "complete", "--out-in-percent", "true",
     "--out-filter", "ani", "0.9", "--out-filter", "qcov", "0.5",
     "--multisample-fasta", "false", "--out-ids", "i.tsv",
     "--out-alignment", "a.tsv", "--flt-kmerdb", "f.txt", "0.2"],
    ["all2all", "--in-fasta", "x.fna", "--out", "y.tsv", "--out-format",
     "lite,rlen,qlen"],
    ["all2all", "--in-fasta", "x.fna", "--out", "y.tsv", "--backend",
     "native"],
    ["all2all", "--out", "y.tsv"],                           # no input
    ["all2all", "--in-fasta", "x.fna", "--bogus"],           # unknown flag
    ["all2all", "--in-fasta", "x.fna", "--out-format", "nope"],
    ["all2all", "--in-fasta", "x.fna", "--out-filter", "len_ratio", "1"],
    ["all2all", "--in-fasta", "x.fna", "--out-type", "csv"],
    ["all2all", "--in-fasta", "x.fna", "--multisample-fasta", "yes"],
    ["one2all", "--in-fasta", "x.fna"],                      # unknown mode
    ["--version"],
]


def _outcome(parse, argv):
    """Params fields (backend aside) or the exit code."""
    try:
        p = parse(argv)
    except SystemExit as e:
        return ("exit", e.code)
    if p is None:
        return None
    return {k: v for k, v in dataclasses.asdict(p).items() if k != "backend"}


@pytest.mark.parametrize("k", range(len(ARGVS)))
def test_parse_args_equals_the_original(k, capsys):
    argv = ARGVS[k]
    want = _outcome(jcli.parse_args, argv)
    want_err = capsys.readouterr().err
    got = _outcome(tcli.parse_args, argv)
    got_err = capsys.readouterr().err
    assert got == want
    if not (want_err.startswith("lz-ani-tpu") or "backend" in want_err):
        assert got_err == want_err


def test_textnum_equals_the_original():
    rng = np.random.RandomState(5)
    vals = np.concatenate([rng.rand(400), rng.rand(200) * 10.0 ** rng.randint(
        -12, 12, 200), -rng.rand(50), [0.0, 1.0, 0.5, 1e-5, 9.9999995e-5,
                                       float("nan"), float("inf"), 123456.5]])
    for v in vals:
        for prec in (1, 4, 6, 15):
            assert ttn.format_real(float(v), prec) == jtn.format_real(
                float(v), prec), (v, prec)
    for v in rng.randint(-10 ** 9, 10 ** 9, 50):
        assert ttn.format_int(int(v)) == jtn.format_int(int(v))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_native_engine_equals_the_original(seed, tmp_path):
    rng = np.random.RandomState(seed)
    codes = small_family(seed)
    codes.append(mutate(rng, codes[0], 0.1, n_ns=3, indels=4))
    p = rand_params(rng)
    rp_t, rp_j = str(tmp_path / "t.regions"), str(tmp_path / "j.regions")
    assert np.array_equal(tne.all2all(codes, p, region_path=rp_t),
                          jne.all2all(codes, p, region_path=rp_j))
    regs = lambda m, path: sorted((r, q, regs.tobytes())
                                  for r, q, regs in m.read_region_dump(path))
    assert regs(tne, rp_t) == regs(jne, rp_j)
    for r, q in ((0, 1), (1, 0), (0, 3), (4, 6), (6, 0)):
        ev = tne.parse_event_log(codes[r], codes[q], p)
        assert np.array_equal(ev, jne.parse_event_log(codes[r], codes[q], p))
        got = tne.replay_events(codes[r], codes[q], p, ev, want_regions=True)
        want = jne.replay_events(codes[r], codes[q], p, ev, want_regions=True)
        assert got[0] == want[0] and np.array_equal(got[1], want[1])


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("extra", [
    [],
    ["--out-type", "single-txt"],
    ["--out-format", "complete", "--out-in-percent", "true", "--out-filter",
     "ani", "0.9", "--mal", "9", "--msl", "5"]])
def test_native_cli_equals_the_original(extra, tmp_path, monkeypatch):
    rng = np.random.RandomState(9)
    base = rng.randint(0, 4, 1800).astype(np.uint8)
    codes = [mutate(rng, base, r, n_ns=k, indels=k) for k, r in
             enumerate((0.0, 0.02, 0.05, 0.12))]
    codes.append(rng.randint(0, 4, 900).astype(np.uint8))
    write_fasta(str(tmp_path / "in.fna"),
                [f"s{k} descr" for k in range(len(codes))], codes)
    # the same relative names: single-txt output embeds them
    argv = ["all2all", "--in-fasta", "../in.fna", "--out", "o.tsv",
            "--out-alignment", "o.aln", "-t", "2", "-V", "0", "--backend",
            "native"] + extra
    for sub, main in (("a", jcli.main), ("b", tcli.main)):
        (tmp_path / sub).mkdir()
        monkeypatch.chdir(tmp_path / sub)
        assert main(argv) == 0
    a, b = str(tmp_path / "a" / "o.tsv"), str(tmp_path / "b" / "o.tsv")
    assert _read(a) == _read(b)
    if "single-txt" not in extra:
        assert _read(a[:-4] + ".ids.tsv") == _read(b[:-4] + ".ids.tsv")
    la = _read(a[:-4] + ".aln").splitlines()
    lb = _read(b[:-4] + ".aln").splitlines()
    assert la[0] == lb[0] and sorted(la[1:]) == sorted(lb[1:])
    assert len(la) > 1


def test_native_build_lands_in_the_port(tmp_path):
    path = tne.build.build_gxx("lzani_core", [tne._SRC])
    assert os.path.dirname(path) == tne.build.BUILD_DIR
    assert os.path.basename(path).startswith("liblzani_core_")
    assert Params().backend == "auto"
