"""The port's FASTA ingest (one native pass, ``lza_ingest_*``) stores what
the JAX package's ``SequenceStore`` stores: names, lengths, packed bytes,
``no_parts`` and the reorder map, in multisample and per-file mode, on
edge inputs fed in chunks as small as one byte; on a seeded random file
the packed bytes equal ``pack3(encode_dna(...))``; the CLI's ids file and
TSV equal the JAX package's CLI for per-file and gzip inputs; the
matcher's ingest counters and the benchmark's reader of them."""
import gzip
import os

import numpy as np
import pytest
import torch

from benchmark import harness
from lzani_tpu import cli as jcli
from lzani_tpu.io.fasta import SequenceStore as JaxStore
from lzani_tpu_torch import cli as tcli
from lzani_tpu_torch.io.fasta import SequenceStore, encode_dna
from lzani_tpu_torch.io.packing import pack3
from lzani_tpu_torch.matcher import Matcher
from lzani_tpu_torch.synth import mutate, write_fasta

CASES = {
    "lowercase_iupac": b">a x\nacgtACGTRYKMSWBDHVUryk\nNNNNNNNNNNnnnn\n"
                       b"AC\x00GT AC\tGT-.*\n>b\nnnnnACGTNNNN\n",
    "crlf": b">a one\r\nACGT\r\nAC\r\n>b\r\nGG\rTT\r\n>c\r\r\nA\r\n",
    "lf_no_final_newline": b">a\nACGT\nAC\n>b\nACG",
    "gt_mid_line": b">a\nAC>GT\n>>b>c d\nAA>\n>\t\nC\n",
    "before_first_header": b"ACGT\nxx>y\n\n>a\nAC\n>b\nG\n",
    "empty_header": b">\nACGT\n>\r\nAA\n> space\nCC\n>ok\nT\n",
    "empty_records": b">a\n>b\nAC\n>c\n\n>d\n",
    "header_only": b">only one",
    "header_only_newline": b">only\n",
    "empty_file": b"",
    "sequence_only": b"ACGT\nACGT\n",
    "blank_lines": b"\n\n>a\n\nAC\n\n\nGT\n\n>b\n\n",
}
CHUNKS = (1, 2, 3, 7, 64, 1 << 20)
SEP = 3


def _packed(store):
    return [bytes(c) for c in store.codes.chunks]


def _same(port, ref):
    assert port.names == ref.names
    assert port.lengths == ref.lengths
    assert _packed(port) == _packed(ref)
    assert port.no_parts == ref.no_parts == [1] * len(ref)
    assert np.array_equal(port.reorder(), ref.reorder())
    assert port.names == ref.names and _packed(port) == _packed(ref)


def _load(store, paths, per_file, **kw):
    if per_file:
        store.load_fasta_per_file(paths, SEP, **kw)
    else:
        store.load_multifasta(paths, **kw)
    return store


@pytest.mark.parametrize("per_file", [False, True], ids=["multi", "per_file"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_ingest_equals_the_jax_store(case, per_file, tmp_path):
    path = str(tmp_path / f"{case}.fna")
    with open(path, "wb") as fh:
        fh.write(CASES[case])
    for chunk in CHUNKS:
        _same(_load(SequenceStore(), [path], per_file, chunk=chunk),
              _load(JaxStore(), [path], per_file))


@pytest.mark.parametrize("per_file", [False, True], ids=["multi", "per_file"])
def test_gzip_and_several_files_equal_the_jax_store(per_file, tmp_path):
    """A gzip file beside plain ones: each file is parsed from its own
    line start, and the gzip file is inflated before the same pass."""
    paths = []
    for k, case in enumerate(("crlf", "gt_mid_line", "before_first_header")):
        path = str(tmp_path / f"f{k}.fna")
        if k == 1:
            path += ".gz"
            with gzip.open(path, "wb") as fh:
                fh.write(CASES[case])
        else:
            with open(path, "wb") as fh:
                fh.write(CASES[case])
        paths.append(path)
    for chunk in (1, 5, 1 << 20):
        port = _load(SequenceStore(), paths, per_file, chunk=chunk)
        assert port.ingest_bytes == sum(len(CASES[c]) for c in (
            "crlf", "gt_mid_line", "before_first_header"))
        _same(port, _load(JaxStore(), paths, per_file))


def _random_fasta(rng, n_rec):
    """(file bytes, names, sequence bytes): records of 0-5,000 symbols of
    a mixed alphabet, lines of random width, LF or CRLF ends."""
    alphabet = np.frombuffer(b"ACGTACGTacgtNnRYKMswX-\x00 \t", np.uint8)
    out, names, seqs = [], [], []
    for k in range(n_rec):
        name = f"r{k}_{rng.randint(1 << 30)}"
        seq = alphabet[rng.randint(0, len(alphabet),
                                   rng.randint(0, 5001))].tobytes()
        seq = seq.replace(b">", b"")
        width = int(rng.randint(1, 120))
        end = b"\r\n" if rng.rand() < 0.3 else b"\n"
        lines = [seq[i:i + width] for i in range(0, len(seq), width)]
        out.append(f">{name} descr {k}".encode() + end +
                   b"".join(ln + end for ln in lines))
        names.append(name)
        seqs.append(seq)
    return b"".join(out), names, seqs


def test_random_file_equals_encode_and_pack3(tmp_path):
    rng = np.random.RandomState(20261018)
    data, names, seqs = _random_fasta(rng, 60)
    path = str(tmp_path / "r.fna")
    with open(path, "wb") as fh:
        fh.write(data)
    want = [pack3(encode_dna(s)).tobytes() for s in seqs]
    for chunk in (997, 4096, 1 << 20):
        s = SequenceStore()
        s.load_multifasta([path], chunk=chunk)
        assert s.names == names
        assert s.lengths == [len(x) for x in seqs]
        assert _packed(s) == want
        assert s.ingest_bytes == len(data)
    s = SequenceStore()
    s.load_fasta_per_file([path], 40, chunk=1000)
    sep = b"\x00" * 40
    joined = b"".join((sep if k and sum(map(len, seqs[:k])) else b"") + x
                      for k, x in enumerate(seqs))
    assert s.names == ["r.fna"] and _packed(s) == [
        pack3(encode_dna(joined)).tobytes()]


def _collection(tmp_path, rng):
    base = rng.randint(0, 4, 1500).astype(np.uint8)
    codes = [mutate(rng, base, r, n_ns=k, indels=k)
             for k, r in enumerate((0.0, 0.03, 0.08))]
    codes.append(rng.randint(0, 4, 700).astype(np.uint8))
    return codes


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("layout", ["multisample", "per_file", "gzip"])
def test_cli_outputs_equal_the_jax_cli(layout, tmp_path, monkeypatch):
    """The ids file and the TSV of the port's native CLI equal the JAX
    package's for a multisample file, a per-file run over a directory
    (contigs, an empty record) and a gzip input."""
    rng = np.random.RandomState(17)
    codes = _collection(tmp_path, rng)
    names = [f"s{k} descr" for k in range(len(codes))]
    src = tmp_path / "in"
    src.mkdir()
    if layout == "per_file":
        for k in range(len(codes)):
            half = len(codes[k]) // 2
            write_fasta(str(src / f"g{k}.fna"), [f"c{k}a", f"c{k}b", "e"],
                        [codes[k][:half], codes[k][half:], codes[k][:0]])
        inp = ["--in-dir", "../in", "--multisample-fasta", "false"]
    else:
        fa = str(src / "x.fna")
        write_fasta(fa, names, codes)
        if layout == "gzip":
            with open(fa, "rb") as fh, gzip.open(fa + ".gz", "wb") as gz:
                gz.write(fh.read())
            os.remove(fa)
            fa += ".gz"
        inp = ["--in-fasta", "../in/" + os.path.basename(fa)]
    argv = ["all2all", *inp, "--out", "o.tsv", "-t", "2", "-V", "0",
            "--backend", "native"]
    for sub, main in (("a", jcli.main), ("b", tcli.main)):
        (tmp_path / sub).mkdir()
        monkeypatch.chdir(tmp_path / sub)
        assert main(argv) == 0
    for name in ("o.tsv", "o.ids.tsv"):
        a, b = _read(tmp_path / "a" / name), _read(tmp_path / "b" / name)
        assert a == b and a.count(b"\n") > 1


@pytest.mark.parametrize("backend", ["native", "cuda"])
def test_matcher_reports_the_ingest_counters(backend, tmp_path, capsys):
    rng = np.random.RandomState(3)
    codes = _collection(tmp_path, rng)
    fa = str(tmp_path / "x.fna")
    write_fasta(fa, [f"s{k}" for k in range(len(codes))], codes)
    rc, m = tcli.run(["all2all", "--in-fasta", fa, "--out",
                      str(tmp_path / "o.tsv"), "-t", "2", "-V", "2",
                      "--backend", backend], device=torch.device("cpu"))
    assert rc == 0
    st = m.engine_stats
    assert st["ingest_bytes"] == os.path.getsize(fa)
    assert st["ingest_records"] == len(m.store) == len(codes)
    assert st["ingest_s"] > 0
    from lzani_tpu_torch.utils.runinfo import engine_stats
    assert engine_stats(capsys.readouterr().err) == st


def test_matcher_counts_bytes_after_gzip(tmp_path):
    fa = str(tmp_path / "x.fna.gz")
    with gzip.open(fa, "wb") as fh:
        fh.write(CASES["lowercase_iupac"])
    m = Matcher(tcli.parse_args(["all2all", "--in-fasta", fa, "--out",
                                 str(tmp_path / "o.tsv"), "-t", "1", "-V",
                                 "0", "--backend", "native"]))
    assert m.run_all2all()
    assert m.engine_stats["ingest_bytes"] == len(CASES["lowercase_iupac"])
    assert m.engine_stats["ingest_records"] == 2


class _Job:
    def __init__(self, stats):
        self.stats = stats


class _Run:
    def __init__(self, jobs):
        self.ok_jobs = jobs


def test_the_reader_of_the_ingest_rate():
    """Bytes over 10^6 x seconds, summed over the jobs; None for a
    program without the counters."""
    read = harness.load_reader(harness.ROOT, "ingest.mb_per_s")
    run = _Run([_Job({"ingest_bytes": 2_000_000, "ingest_s": 0.5}),
                _Job({"ingest_bytes": 4_000_000, "ingest_s": 1.5,
                      "ingest_records": 7})])
    assert read(run) == pytest.approx(3.0)
    assert read(_Run([_Job({"dispatch_s": 1.0})])) is None
    assert read(_Run([])) is None
