"""The port's slice end to end on the CPU (the kernel's plain version):
``all2all_cuda`` triples equal ``native_engine.all2all`` and the JAX
engine (``all2all_pallas`` in interpret mode); filter CSR and alignment
regions agree with the native engine; the port's CLI and matcher write
byte-equal TSV and ids files (the aln file compared as a set)."""
import os

import numpy as np
import pytest
import torch

from lzani_tpu import cli as jcli
from lzani_tpu.core import native_engine as ne
from lzani_tpu.ops.pallas_engine import all2all_pallas
from lzani_tpu.params import Params
from lzani_tpu_torch import cli as tcli
from lzani_tpu_torch.matcher import Matcher
from lzani_tpu_torch.ops import cuda_engine as tce
from lzani_tpu_torch.ops.finalize import Finalizer
from lzani_tpu_torch.synth import mutate, write_fasta
from lzani_tpu_torch.utils import cudadev

CPU = torch.device("cpu")


def _codes(seed, n_fam=4, length=600):
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 4, length).astype(np.uint8)
    codes = [mutate(rng, base, 0.01 + 0.04 * k, n_ns=k % 2, indels=k % 3)
             for k in range(n_fam)]
    codes.append(rng.randint(0, 4, length // 2).astype(np.uint8))
    return codes


def _regions(path):
    return sorted((r, q, tuple(map(tuple, regs)))
                  for r, q, regs in ne.read_region_dump(path))


def test_dense_matches_native_and_pallas():
    codes = _codes(1)
    p = Params()
    st = {}
    got = tce.all2all_cuda(codes, p, device=CPU, stats=st)
    assert np.array_equal(got, ne.all2all(codes, p))
    assert np.array_equal(got, all2all_pallas(codes, p, interpret=True,
                                              ilv=2, sim=True))
    n = len(codes)
    assert st["kernel_pairs"] == n * (n - 1)
    assert st["replay_mismatches"] == 0 and st["native_rows"] == 0
    assert st["cap_fallbacks"] == 0 and st["dispatches"] == 2


def test_filter_and_regions_match_native(tmp_path):
    codes = _codes(2, n_fam=6)
    p = Params()
    rows = [[1, 2, 5], [0, 3], [0], [1, 6], [5], [0, 4], [2]]
    indptr = np.zeros(len(rows) + 1, np.int64)
    ids = []
    for r, qs in enumerate(rows):
        ids.extend(qs)
        indptr[r + 1] = len(ids)
    csr = (indptr, np.array(ids, np.int32))
    rp_n, rp_t = str(tmp_path / "n.regions"), str(tmp_path / "t.regions")
    want = ne.all2all(codes, p, filter_csr=csr, region_path=rp_n)
    st = {}
    got = tce.all2all_cuda(codes, p, filter_csr=csr, region_path=rp_t,
                           device=CPU, stats=st)
    assert np.array_equal(got, want)
    assert _regions(rp_t) == _regions(rp_n)
    assert st["kernel_pairs"] == len(ids) and st["replay_mismatches"] == 0


def test_rows_routed_native_are_counted(monkeypatch):
    codes = _codes(3)
    p = Params()
    # every composite above 1,000 symbols leaves the group path, and the
    # long-genome path takes none of them
    monkeypatch.setattr(tce.CudaAll2All, "MAX_REF_SYMS", 1000)
    monkeypatch.setattr(tce.CudaAll2All, "MAX_BIG_SYMS", 1000)
    st = {}
    got = tce.all2all_cuda(codes, p, device=CPU, stats=st)
    assert np.array_equal(got, ne.all2all(codes, p))
    big = sum(2 * len(c) + 3 * p.max_dist_in_ref > 1000 for c in codes)
    assert 0 < big < len(codes)
    assert st["native_rows"] == big
    assert st["native_row_pairs"] == big * (len(codes) - 1)
    assert st["kernel_pairs"] == (len(codes) - big) * (len(codes) - 1)


def test_finalizer_counts_replay_mismatches():
    """A log the replay's bwd/ext cross-check rejects is recorded and the
    pair is not repaired (the JAX finalizer swallows it silently); a pair
    without a log is parsed natively."""
    codes = _codes(7)
    p = Params()
    out = np.zeros((len(codes), len(codes) - 1, 3), np.int32)
    fin = Finalizer(codes, p, out)
    ev = ne.parse_event_log(codes[0], codes[1], p).copy()
    assert len(ev) > 0
    ev[0, 4] += 1                       # a wrong forward-extension length
    fin(0, 1, ev, (0, 0))
    assert fin.replay_mismatches == 1 and fin.mismatched == [(0, 1)]
    assert tuple(out[0, 0]) == (0, 0, 0)
    fin(0, 2, ne.parse_event_log(codes[0], codes[2], p), (0, 1))
    fin(0, 3, None, (0, 2))
    assert fin.replay_mismatches == 1
    assert tuple(out[0, 1]) == ne.parse_pair(codes[0], codes[2], p)[0]
    assert tuple(out[0, 2]) == ne.parse_pair(codes[0], codes[3], p)[0]


def test_replay_mismatch_fails_the_run(monkeypatch):
    """A kernel whose logs the replay rejects fails all2all_cuda; the
    stats still report how many pairs mismatched."""
    real = tce.parse_events

    def wrong_ext(*args, **kw):
        ev, nev = real(*args, **kw)
        ev[:, :, 0, 4] += 1             # every pair's first extension
        return ev, nev

    monkeypatch.setattr(tce, "parse_events", wrong_ext)
    codes = _codes(8)
    st = {}
    with pytest.raises(RuntimeError, match="replay cross-check"):
        tce.all2all_cuda(codes, Params(), device=CPU, stats=st)
    assert st["replay_mismatches"] > 0
    assert st["replay_mismatches"] <= st["kernel_pairs"]


@pytest.mark.parametrize("mal,msl,why", [
    (28, 7, "outside the CUDA kernel envelope"),   # WIN table saturates
    (14, 9, "no dense 4^mal join table")])         # long-genome routing
def test_parameters_off_the_group_path_run_native(mal, msl, why, capsys):
    """Parameters outside the kernels' envelope run natively; mal > 13
    leaves the group path for the long-genome kernel (the JAX rule)."""
    codes = _codes(4)
    p = Params()
    p.min_anchor_len, p.min_seed_len = mal, msl
    st = {}
    got = tce.all2all_cuda(codes, p, device=CPU, stats=st)
    assert np.array_equal(got, ne.all2all(codes, p))
    assert why in capsys.readouterr().err
    assert st["launches"] == 0 and st["kernel_pairs"] == 0
    n = len(codes)
    if tce.device_envelope_reason(p) is None:
        assert st["native_rows"] == 0 and st["big_rows"] == n
        assert st["big_pairs"] + st["big_cap_fallbacks"] == n * (n - 1)
    else:
        assert st["native_rows"] == n and st["big_rows"] == 0


def _fasta(tmp_path, seed):
    codes = _codes(seed, n_fam=5, length=700)
    path = str(tmp_path / "in.fna")
    write_fasta(path, [f"s{k}" for k in range(len(codes))], codes)
    return path


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_cli_native_matches_reference_cli(tmp_path):
    fa = _fasta(tmp_path, 4)
    a, b = str(tmp_path / "a.tsv"), str(tmp_path / "b.tsv")
    common = ["--in-fasta", fa, "-t", "2", "-V", "0", "--backend", "native"]
    assert jcli.main(["all2all", "--out", a] + common) == 0
    assert tcli.main(["all2all", "--out", b] + common) == 0
    assert _read(a) == _read(b)
    assert _read(a[:-4] + ".ids.tsv") == _read(b[:-4] + ".ids.tsv")


def test_matcher_cuda_path_matches_native_cli(tmp_path):
    """The whole cuda store path (TSV, ids, aln) through the port's Matcher, on
    the CPU device, against the reference CLI's native run."""
    fa = _fasta(tmp_path, 5)
    a, b = str(tmp_path / "a.tsv"), str(tmp_path / "b.tsv")
    assert jcli.main(["all2all", "--in-fasta", fa, "--out", a,
                      "--out-alignment", a + ".aln", "-t", "2", "-V", "0",
                      "--backend", "native"]) == 0
    argv = ["all2all", "--in-fasta", fa, "--out", b, "--out-alignment",
            b + ".aln", "-t", "2", "-V", "0"]
    assert tcli.parse_args(argv).backend == "hybrid"    # auto means hybrid
    rc, m = tcli.run(argv + ["--backend", "cuda"], device=CPU)
    assert rc == 0 and isinstance(m, Matcher)
    assert m.params.backend == "cuda"
    assert _read(a) == _read(b)
    assert _read(a[:-4] + ".ids.tsv") == _read(b[:-4] + ".ids.tsv")
    la = _read(a + ".aln").splitlines()
    lb = _read(b + ".aln").splitlines()
    assert la[0] == lb[0] and sorted(la[1:]) == sorted(lb[1:])
    assert m.engine_stats["replay_mismatches"] == 0
    assert m.engine_stats["kernel_pairs"] == 6 * 5
    assert not os.path.exists(b + ".aln.regions.tmp")


def test_cli_cuda_without_gpu_exits_1(tmp_path, monkeypatch, capsys):
    fa = _fasta(tmp_path, 6)
    monkeypatch.setattr(cudadev, "cuda_device_count", lambda: 0)
    rc = tcli.main(["all2all", "--in-fasta", fa, "--out",
                    str(tmp_path / "o.tsv"), "--backend", "cuda"])
    assert rc == 1
    assert "needs a CUDA device" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "o.tsv")


def test_cli_rejects_unknown_backend(tmp_path):
    with pytest.raises(SystemExit) as e:
        tcli.parse_args(["all2all", "--in-fasta", "x", "--out", "y",
                         "--backend", "tpu"])
    assert e.value.code == 1
