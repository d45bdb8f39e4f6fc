"""The group route's fold on the CPU (the kernels' plain versions): a run
of ``all2all_cuda`` without a region file folds each group unit's event
logs into triples on the unit's device (``GroupRoute.fold``) and
gives the host replay only the pairs without a log; its triples equal
``native_engine.all2all``'s, dense and under a sparse filter. A region
file, the long-genome route and a log the fold rejects keep the rules
they had: regions come from the host replay, long-genome units are
replayed there, and a rejected log fails the run."""
import numpy as np
import pytest
import torch

from lzani_tpu_torch.core import native_engine as tne
from lzani_tpu_torch.ops import cuda_engine as tce
from lzani_tpu_torch.params import Params
from test_torch_plan import _filter, _mixed_set, _route_mixed

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain kernels run many small torch ops: one intra-op thread
    keeps them quick on a host that other test processes share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _total(codes, csr):
    n = len(codes)
    return n * (n - 1) if csr is None else len(csr[1])


def _regions(path):
    return sorted((r, q, tuple(map(tuple, regs)))
                  for r, q, regs in tne.read_region_dump(path))


@pytest.mark.parametrize("sparse", [False, True])
def test_the_fold_route_equals_the_native_engine(sparse):
    """Every pair with a log is folded; the one pair whose query row has
    an anchor bucket over CNT_CAP (the two tandem repeats, in the dense
    run) is parsed natively on the pool."""
    codes, p = _mixed_set(), Params()
    csr = _filter(len(codes), 5) if sparse else None
    st = {}
    out = tce.all2all_cuda(codes, p, filter_csr=csr, device=CPU, stats=st)
    assert np.array_equal(out, tne.all2all(codes, p, filter_csr=csr))
    assert st["fold_pairs"] == st["kernel_pairs"] > 0
    assert st["kernel_pairs"] + st["cap_fallbacks"] == _total(codes, csr)
    assert st["replay_pairs"] == st["cap_fallbacks"]
    assert st["replay_mismatches"] == 0 and st["big_pairs"] == 0


def test_a_region_file_keeps_the_host_replay(tmp_path):
    """Regions need the factor list: with a region file every group unit
    is replayed on the host, and the triples and regions equal the native
    engine's."""
    codes, p = _mixed_set(), Params()
    st = {}
    got, want = str(tmp_path / "cuda.bin"), str(tmp_path / "native.bin")
    out = tce.all2all_cuda(codes, p, device=CPU, stats=st, region_path=got)
    assert np.array_equal(out, tne.all2all(codes, p, region_path=want))
    assert _regions(got) == _regions(want) and _regions(got)
    assert st["fold_pairs"] == 0 and st["kernel_pairs"] > 0
    assert st["replay_pairs"] == _total(codes, None)


@pytest.mark.parametrize("cap,value", [("EV_CAP", 3), ("CNT_CAP", 0)])
def test_a_capacity_fallback_is_parsed_natively(cap, value, monkeypatch):
    """A pair over the event cap, or whose query row has an anchor bucket
    over CNT_CAP, skips the fold and is parsed natively on the pool, and
    is counted as a capacity fallback."""
    monkeypatch.setattr(tce.CudaAll2All, cap, value)
    codes, p = _mixed_set(), Params()
    st = {}
    out = tce.all2all_cuda(codes, p, device=CPU, stats=st)
    assert np.array_equal(out, tne.all2all(codes, p))
    assert st["cap_fallbacks"] > 1
    assert st["replay_pairs"] == st["cap_fallbacks"]
    assert st["fold_pairs"] == st["kernel_pairs"]
    assert st["kernel_pairs"] + st["cap_fallbacks"] == _total(codes, None)


def test_a_log_the_fold_rejects_fails_the_run(monkeypatch):
    """A status of -1 is a replay mismatch: the run raises once it is
    over, naming the pair, and the pair is not repaired on the host."""
    real = tce.fold_stats

    def reject(*args, **kw):
        stats, status = real(*args, **kw)
        status[0, 1] = -1             # the group's first reference x query 1
        return stats, status

    monkeypatch.setattr(tce, "fold_stats", reject)
    codes, p = _mixed_set(), Params()
    st = {}
    with pytest.raises(RuntimeError, match=r"replay cross-check .*\(0, 1\)"):
        tce.all2all_cuda(codes, p, device=CPU, stats=st)
    # one rejected pair a unit, each of them wanted
    assert st["replay_mismatches"] == st["dispatches"] > 0
    assert st["fold_pairs"] == st["kernel_pairs"] - st["dispatches"]
    assert st["replay_pairs"] == st["cap_fallbacks"]


def test_long_genome_rows_still_replay_on_the_host(monkeypatch):
    """On a set that takes all three routes over two entries, the group
    units fold and the long-genome units and the native row go through
    the host replay."""
    codes, p = _mixed_set(), Params()
    _route_mixed(monkeypatch, codes, p)
    st = {}
    out = tce.all2all_cuda(codes, p, devices=[CPU, CPU], stats=st)
    assert np.array_equal(out, tne.all2all(codes, p))
    assert st["big_rows"] == 4 and st["big_pairs"] > 0
    assert st["fold_pairs"] == st["kernel_pairs"] > 0
    assert st["replay_pairs"] == (st["big_pairs"] + st["big_cap_fallbacks"]
                                  + st["cap_fallbacks"]
                                  + st["native_row_pairs"])
    assert st["replay_mismatches"] == 0
