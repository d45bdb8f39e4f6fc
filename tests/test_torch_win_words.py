"""The index builds' WIN words (``anchor_tables.win_words``): a group with
dummy slots holds each reference's own packed table, the seed half is
computed once per (msl, mrd, mqd), the engine counts the words' seconds
as ``win_s``, and the benchmark's reader of that counter."""
import numpy as np
import pytest
import torch

from benchmark import harness
from lzani_tpu_torch.ops import anchor_tables as tat
from lzani_tpu_torch.ops import cuda_engine as tce
from lzani_tpu_torch.params import Params
from lzani_tpu_torch.synth import mutate

CPU = torch.device("cpu")


def _codes(seed, n=5, length=600):
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 4, length).astype(np.uint8)
    return [mutate(rng, base, 0.02 + 0.03 * k, n_ns=k % 2, indels=k % 3)
            for k in range(n)]


def test_group_with_dummy_slots_holds_each_references_table():
    p = Params()
    eng = tce.CudaAll2All(_codes(1), p, devices=[CPU])
    gi = eng.routes["group"].build([0, 1, -1, -1], CPU)
    nrs = gi.nrs.numpy()
    assert nrs[2] == nrs[3] < nrs[0]               # the dummy slots
    cfg = eng.cfg
    want = np.concatenate([tce.pack_bits_i32(tat.build_win_table(
        int(n), cfg.mal, cfg.msl, cfg.mrd, cfg.mqd).reshape(-1), 128)
        for n in nrs])
    assert gi.win.dtype == torch.int32 and gi.WinP == want.shape[1]
    assert np.array_equal(gi.win.numpy(), want)
    assert isinstance(gi.win_s, float) and gi.win_s >= 0


def test_the_seed_half_is_computed_once(monkeypatch):
    calls = []
    fpow = tat.fpow_vec
    monkeypatch.setattr(tat, "fpow_vec",
                        lambda b, e: calls.append(b.shape) or fpow(b, e))
    tat.seed_half.cache_clear()
    a = tat.win_words([900, 4000], 11, 7, 40, 40)
    b = tat.win_words([4000, 900, 152], 11, 7, 40, 40)
    # the first call computes both halves, the second the anchor half alone
    assert sorted(calls) == [(2, 17), (3, 17), (21, 41)]
    assert tat.seed_half.cache_info().misses == 1
    assert np.array_equal(a[::-1], b[:2])
    assert not tat.seed_half(7, 40, 40).flags.writeable


@pytest.mark.parametrize("path", ["group", "big"])
def test_all2all_cuda_counts_the_win_seconds(path):
    p = Params()
    if path == "big":                   # mal > 13: the long-genome path
        p.min_anchor_len, p.min_seed_len = 14, 9
    st = {}
    tce.all2all_cuda(_codes(2), p, device=CPU, stats=st, replay_threads=1)
    assert st["big_rows" if path == "big" else "kernel_pairs"] > 0
    assert isinstance(st["win_s"], float)
    assert 0 <= st["win_s"] <= st["dispatch_s"]


class _Job:
    def __init__(self, stats):
        self.stats = stats


class _Run:
    def __init__(self, jobs):
        self.ok_jobs = jobs


def test_the_reader_of_win_s():
    """The mean per job; None for a program without the counter."""
    read = harness.load_reader(harness.ROOT, "engine.win_s")
    assert read(_Run([_Job({"win_s": 0.01}), _Job({"win_s": 0.03})])) == \
        pytest.approx(0.02)
    assert read(_Run([_Job({"dispatch_s": 1.0})])) is None
    assert read(_Run([])) is None
