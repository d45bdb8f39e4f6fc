"""The event-log parse of the port, through its plain PyTorch version on
the CPU, equals the native oracle (``native_engine.parse_event_log``)
pair for pair and the JAX v7 kernel in interpret mode on a shared group.
The CUDA kernel itself is held against the plain version and the oracle
by tests/test_torch_cuda.py on a card. Event logs are integers: every
comparison is exact."""
import types

import numpy as np
import pytest
import torch

from lzani_tpu.core import native_engine as ne
from lzani_tpu.ops.pallas_engine import PallasAll2All
from lzani_tpu.params import Params
from lzani_tpu_torch.ops import build
from lzani_tpu_torch.ops import cuda_engine as tce
from lzani_tpu_torch.ops import parse_kernel as pk
from lzani_tpu_torch.ops.parse_kernel import parse_events
from lzani_tpu_torch.synth import mutate, rand_params, small_family

CPU = torch.device("cpu")
#: dynamic shared memory a block may take on an H100 (its opt-in limit;
#: the group kernel has no static shared memory): ``pk.smem_limit`` there
H100_SMEM = 227 * 1024


def _group_logs(eng, r_list, device=CPU):
    """{(r, q): event log or None} for every real pair of one group."""
    route = eng.routes["group"]
    gi = route.build(r_list, device)
    out = {}
    n = len(eng.codes)
    for lo in range(0, eng.n_pad, eng.B):
        evs = route.collect(route.dispatch(gi, r_list, lo, device))
        for g, r in enumerate(r_list):
            for b in range(eng.B):
                q = lo + b
                if r >= 0 and q < n and q != r:
                    out[(r, q)] = evs[g][b]
    return out


@pytest.fixture(scope="module")
def family_logs():
    codes = small_family()
    eng = tce.CudaAll2All(codes, Params(), devices=[CPU])
    logs = {}
    for rl in ([0, 1, 2, 3], [4, 5, -1, -1]):
        logs.update(_group_logs(eng, rl))
    return codes, logs


@pytest.mark.parametrize("r,q", [(r, q) for r in range(6) for q in range(6)
                                 if r != q])
def test_family_pair_matches_oracle(family_logs, r, q):
    codes, logs = family_logs
    want = ne.parse_event_log(codes[r], codes[q], Params())
    assert logs[(r, q)] is not None
    assert np.array_equal(logs[(r, q)], want)


def test_group_matches_jax_v7_interpret():
    rng = np.random.RandomState(7)
    base = rng.randint(0, 4, 500).astype(np.uint8)
    codes = [base, mutate(rng, base, 0.06, n_ns=2, indels=1),
             mutate(rng, base[40:], 0.15, n_ns=0, indels=2),
             rng.randint(0, 4, 300).astype(np.uint8)]
    p = Params()
    r_list = [0, 1, 2, 3]
    v7 = PallasAll2All(codes, p, interpret=True, sim=True, ilv=2)
    gi = v7.build_group_index(r_list, v7.devices[0])
    jev = v7.collect_group(v7.dispatch_group(gi, 0, v7.devices[0]))
    mine = _group_logs(tce.CudaAll2All(codes, p, devices=[CPU]), r_list)
    for (r, q), ev in mine.items():
        oracle = ne.parse_event_log(codes[r], codes[q], p)
        assert ev is not None and np.array_equal(ev, oracle), (r, q)
        assert np.array_equal(ev, jev[r][q]), (r, q)


@pytest.mark.parametrize("trial", range(10))
def test_random_params_and_mutations(trial):
    rng = np.random.RandomState(100 + trial)
    L = int(rng.randint(250, 1500))
    if trial % 5 == 0:       # tandem repeats: arbitration and long LCEs
        unit = rng.randint(0, 4, rng.randint(20, 90)).astype(np.uint8)
        ref = np.tile(unit, L // len(unit) + 1)[:L]
    else:
        ref = rng.randint(0, 4, L).astype(np.uint8)
    rate = [0.0, 0.02, 0.08, 0.18, 0.35][trial % 5]
    q = mutate(rng, ref, rate, n_ns=trial % 4, indels=trial % 3)
    if trial % 5 == 2:       # unrelated middle: desync and next_hit jumps
        mid = rng.randint(0, 4, L // 3).astype(np.uint8)
        q = np.concatenate([q[:L // 3], mid, q[-L // 3:]])
    p = rand_params(rng) if trial % 2 else Params()
    codes = [ref, q]
    logs = _group_logs(tce.CudaAll2All(codes, p, devices=[CPU]), [0, 1])
    for (r, qq), ev in logs.items():
        assert ev is not None
        assert np.array_equal(ev, ne.parse_event_log(codes[r], codes[qq], p))


@pytest.mark.parametrize("aw,am", [(11, 5), (15, 7), (32, 9), (33, 9),
                                   (40, 12)])
def test_approx_window_matches_oracle(aw, am):
    """Extension windows below, at and above the 32 positions of one warp
    step (the kernel takes the misses leaving the window from the last
    64 positions' mask up to aw = 32, and re-reads them above)."""
    rng = np.random.RandomState(aw)
    base = rng.randint(0, 4, 1200).astype(np.uint8)
    codes = [base, mutate(rng, base, 0.08, n_ns=2, indels=2),
             mutate(rng, base, 0.2, n_ns=0, indels=1),
             rng.randint(0, 4, 500).astype(np.uint8)]
    p = Params()
    p.approx_window, p.approx_mismatches = aw, am
    logs = _group_logs(tce.CudaAll2All(codes, p, devices=[CPU]),
                       [0, 1, 2, 3])
    for (r, q), ev in logs.items():
        assert ev is not None
        assert np.array_equal(ev, ne.parse_event_log(codes[r], codes[q], p))


def test_query_bucket_above_2_18_matches_oracle():
    """Queries of ~260 kb (2^18 < LqP <= 2^19: the JAX engine's v3 group
    route) stay on the port's group path and match the oracle."""
    rng = np.random.RandomState(19)
    ref = rng.randint(0, 4, 261_200).astype(np.uint8)
    q = mutate(rng, ref, 0.01, n_ns=3, indels=10)
    q[100_000:101_500] = rng.randint(0, 4, 1500)    # an unrelated stretch
    codes, p = [ref, q], Params()
    eng = tce.CudaAll2All(codes, p, devices=[CPU])
    assert 1 << 18 < eng.LqP <= tce.CudaAll2All.MAX_Q
    for (r, qq), ev in _group_logs(eng, [0, 1]).items():
        assert ev is not None
        assert np.array_equal(ev, ne.parse_event_log(codes[r], codes[qq], p))


def _one_pair_inputs(ref, q, p):
    eng = tce.CudaAll2All([ref, q], p, devices=[CPU])
    gi = eng.routes["group"].build([0], CPU)
    qrows = (eng.Q[CPU][:eng.B], eng.DSZ[CPU][:eng.B])
    qbuf, cand, nh, ovf = tce.query_prep(*qrows, gi.ptab, eng.LqP,
                                         p.min_anchor_len, p.min_seed_len,
                                         eng.CNT_CAP)
    return eng, (gi.refbuf, qbuf, gi.poslist, cand, nh, gi.win,
                 qrows[1].contiguous(), gi.nrs, eng.cfg), ovf


def test_event_capacity_overflow():
    """A parse that needs more than ev_cap + 1 records ends with nev = -1
    (collect -> None, native fallback); with room it logs them all."""
    p = Params()
    rng = np.random.RandomState(33)
    ref = rng.randint(0, 4, 800).astype(np.uint8)
    q = np.concatenate([ref[j:j + 12] for j in rng.randint(0, 700, 40)])
    want = ne.parse_event_log(ref, q, p)
    n = len(want)
    assert n > 10
    eng, args, ovf = _one_pair_inputs(ref, q, p)
    ev, nev = parse_events(*args, ev_cap=n - 2)
    assert int(nev[0, 1]) == -1
    assert eng.routes["group"].collect((ev, nev, ovf))[0][1] is None
    ev, nev = parse_events(*args, ev_cap=n)
    assert int(nev[0, 1]) == n
    assert np.array_equal(ev[0, 1, :n].numpy(), want)
    eng.EV_CAP = n - 1          # the download gate: nev > EV_CAP -> None
    assert eng.routes["group"].collect((ev, nev, ovf))[0][1] is None


def test_anchor_bucket_over_cnt_cap_falls_back():
    """A query row with an anchor bucket over CNT_CAP (112) is flagged and
    collected as None, even though the kernel still ran it."""
    p = Params()
    rng = np.random.RandomState(5)
    unit = rng.randint(0, 4, 13).astype(np.uint8)
    ref = np.concatenate([rng.randint(0, 4, 300).astype(np.uint8),
                          np.tile(unit, 140)])
    q = mutate(rng, ref, 0.02, n_ns=0, indels=0)
    eng, args, ovf = _one_pair_inputs(ref, q, p)
    assert bool(ovf[0, 1])
    ev, nev = parse_events(*args, ev_cap=eng.EV_CAP)
    assert int(nev[0, 1]) >= 0
    assert eng.routes["group"].collect((ev, nev, ovf))[0][1] is None


def test_wrapper_rejects_bad_inputs():
    p = Params()
    rng = np.random.RandomState(1)
    ref = rng.randint(0, 4, 300).astype(np.uint8)
    _, args, _ = _one_pair_inputs(ref, ref.copy(), p)
    bad = list(args)
    bad[3] = args[3].to(torch.int64)          # cand dtype
    with pytest.raises(ValueError):
        parse_events(*bad, ev_cap=16)
    bad = list(args)
    bad[1] = args[1][:, ::2]                  # qbuf shape / contiguity
    with pytest.raises(ValueError):
        parse_events(*bad, ev_cap=16)


@pytest.mark.parametrize("G,B,LrP", [(4, 256, 1 << 17), (1, 255, 1 << 17),
                                     (1, 64, 1 << 17), (4, 8, 1 << 19),
                                     (2, 8, 1 << 20), (16, 256, 1 << 16),
                                     (1, 1, 1 << 12)])
def test_launch_plan_covers_the_queries_and_the_card(G, B, LrP):
    """The group kernel's launch plan (chosen on the host, by shape): the
    reference's planes (3 bits a symbol) in shared memory when they fit,
    else the device-memory instantiation; a warp for each query of a
    reference, no more blocks than that needs, and blocks on every SM of a
    132-SM card when the pairs are that many."""
    smem, warps, slices = pk.launch_plan(G, B, LrP, 132, H100_SMEM)
    ref_bytes = 3 * LrP // 8
    assert smem == (ref_bytes if ref_bytes <= H100_SMEM else 0)
    assert 1 <= warps <= pk.MAX_WARPS
    assert warps * slices >= B > warps * (slices - 1)
    assert G * slices >= min(132, G * B)


def test_launch_plan_shapes():
    """The plans of the main path's launches on a 132-SM card: the viral
    group dispatch (4 x 256: 148 blocks of 7 warps) and the automaton
    backend's row launch (1 x 255: 255 blocks of one warp) keep their 2^17
    reference in 48 KiB of shared memory; a 2^20
    reference (a composite over 2^19 - 1,024 symbols) is read from device
    memory; a limit of 0 selects the device-memory instantiation at any
    shape, with the same warps and blocks."""
    assert pk.launch_plan(4, 256, 1 << 17, 132, H100_SMEM) == (49152, 7, 37)
    assert pk.launch_plan(1, 255, 1 << 17, 132, H100_SMEM) == (49152, 1, 255)
    assert pk.launch_plan(1, 64, 1 << 17, 132, H100_SMEM) == (49152, 1, 64)
    assert pk.launch_plan(2, 8, 1 << 19, 132, H100_SMEM) == (196608, 1, 8)
    assert pk.launch_plan(2, 8, 1 << 20, 132, H100_SMEM)[0] == 0
    assert pk.launch_plan(4, 256, 1 << 17, 132, 0) == (0, 7, 37)


def test_a_300kb_pair_has_a_reference_bucket_over_shared_memory():
    """The engine's buckets for a 300 kb genome and its relative: group
    path rows (composite under MAX_REF_SYMS) at LrP 2^20, which the plan
    sends to the device-memory instantiation (tests/test_torch_cuda.py
    runs it on a card)."""
    rng = np.random.RandomState(23)
    ref = rng.randint(0, 4, 300_000).astype(np.uint8)
    q = mutate(rng, ref, 0.01, n_ns=3, indels=10)
    eng = tce.CudaAll2All([ref, q], Params(), devices=[CPU])
    assert eng.paths == ["group", "group"] and eng.LrP_ref == 1 << 20
    assert pk.launch_plan(2, eng.B, eng.LrP_ref, 132, H100_SMEM)[0] == 0


def test_group_launch_rejects_buckets_off_the_word_grid():
    """The group kernel reads whole plane words and copies a reference's
    rows in 16-byte chunks: a launch with LrP off a multiple of 128 or
    LqP off a multiple of 32 raises before it reaches the card."""
    p = Params()
    rng = np.random.RandomState(1)
    ref = rng.randint(0, 4, 300).astype(np.uint8)
    _, args, _ = _one_pair_inputs(ref, ref.copy(), p)
    for i, cut in ((0, 64), (1, 16)):
        bad = list(args)
        bad[i] = args[i][:, :args[i].shape[1] - cut].contiguous()
        with pytest.raises(ValueError, match="multiple of"):
            pk._launch("parse_events", None, *bad, ev_cap=16)


def test_nvcc_defines_key_the_build(tmp_path, monkeypatch):
    """A -D flag (the probe build's -DLZT_PROBE) keys the kernel build
    cache as a value: another library path, and a rebuild."""
    calls = []

    def fake_run(cmd, capture_output, text):
        calls.append(cmd)
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return types.SimpleNamespace(returncode=0, stdout="", stderr="")

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "run", fake_run)
    plain = build.build_library("parse_events", [pk.SOURCE])
    probe = build.build_library("parse_events", [pk.SOURCE],
                                ("-DLZT_PROBE",))
    assert plain != probe and len(calls) == 2
    assert "-DLZT_PROBE" in calls[1] and "-DLZT_PROBE" not in calls[0]
    assert build.build_library("parse_events", [pk.SOURCE],
                               ("-DLZT_PROBE",)) == probe
    assert len(calls) == 2
