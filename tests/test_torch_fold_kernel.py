"""Inputs at the edges of the fold kernel's design (csrc/fold_stats.cu):
aligned ranges of 31-33 and 63-65 symbols (one word, the word-wide path,
and their boundaries), backward scans cut short by the literal entry
before them (at a cap of up to 32 and above), gaps whose split scans
more than 32 positions (with ties, with a right side shorter than the
run), extension windows of 32 and 40, runs of 36 (longer than a scan
word), a region kill that pops more than 32 entries, N runs on word boundaries, and a pair with more factors than
the kernel's shared-memory ring holds. Each pair is made from a seeded numpy generator, and a test
first shows that its event log really reaches its edge. On the CPU the
fold is its plain version, held exactly (stats, status, factors) against
the native replay and, for a few pairs, the JAX automaton;
tests/test_torch_cuda.py runs the kernel on the same inputs. The launch
plan (what the kernel keeps in shared memory) is checked here too."""
import numpy as np
import pytest
import torch

from lzani_tpu.core import native_engine as ne
from lzani_tpu.ops import engine_jax as jej
from lzani_tpu.params import Params
from lzani_tpu_torch.ops import engine_jax as tej
from lzani_tpu_torch.ops import fold_stats as fs
from lzani_tpu_torch.ops.parse import ParseCfg
from test_torch_engine_jax import fold_args

CPU = torch.device("cpu")


def _off(x):
    """Symbols that differ from `x`."""
    return ((x + 1) % 4).astype(np.uint8)


def _params(**kw):
    p = Params()
    for k, v in kw.items():
        setattr(p, k, v)
    return p


def _fwd(t, seed=1):
    """An exact 60-symbol match whose forward extension covers exactly t
    symbols: substitutions every 5 from its first symbol, the last three
    matching, then a run that mismatches."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, 600).astype(np.uint8)
    reg = ref[60:60 + t].copy()
    sub = np.arange(0, t - 3, 5)
    reg[sub] = _off(reg[sub])
    return ref, np.concatenate([ref[:60], reg, _off(ref[60 + t:80 + t]),
                                rng.integers(0, 4, 100).astype(np.uint8)])


def _bwd(t, seed=2):
    """An exact 150-symbol match whose backward extension covers exactly t
    symbols, substituted every 5 back from the match, after a run that
    mismatches."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, 600).astype(np.uint8)
    reg = ref[200:200 + t].copy()
    sub = np.arange(t - 1, 3, -5)
    reg[sub] = _off(reg[sub])
    return ref, np.concatenate([rng.integers(0, 4, 40).astype(np.uint8),
                                _off(ref[170:200]), reg,
                                ref[200 + t:350 + t]])


def _gap(n_lit, seed=3, all_miss=False):
    """Two exact matches on one diagonal around n_lit substituted symbols
    (60% of them, or all)."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, 700).astype(np.uint8)
    burst = ref[120:120 + n_lit].copy()
    m = np.ones(n_lit, bool) if all_miss else rng.random(n_lit) < 0.6
    m[:4] = True
    burst[m] = _off(burst[m])
    return ref, np.concatenate([ref[:120], burst,
                                ref[120 + n_lit:270 + n_lit]])


def _dup(back, mlen, n_lit, seed=4):
    """A short match `back` positions behind the end of an n_lit run of
    mismatches: the gap's right side is shorter than the run."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, 700).astype(np.uint8)
    s = 200 + n_lit - back
    return ref, np.concatenate([ref[:200], _off(ref[200:200 + n_lit]),
                                ref[s:s + mlen],
                                _off(ref[s + mlen:s + mlen + 30]),
                                ref[400:600]])


def _kill(seed=6):
    """A 20-symbol anchor whose extension covers 150 symbols substituted
    every 4 (about 75 factors), then a distant match: under reg 200 the
    region is killed."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, 1200).astype(np.uint8)
    reg = ref[120:270].copy()
    reg[::4] = _off(reg[::4])
    return ref, np.concatenate([rng.integers(0, 4, 30).astype(np.uint8),
                                ref[100:120], reg, _off(ref[270:300]),
                                ref[800:950]])


def _many(n=9000, seed=7):
    """One extension over n symbols substituted every 4: 2 factors every 4
    symbols."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, n + 200).astype(np.uint8)
    reg = ref[50:50 + n].copy()
    reg[:n - 3:4] = _off(reg[:n - 3:4])
    return ref, np.concatenate([ref[:50], reg, _off(ref[50 + n:80 + n])])


def _related(seed, sub=0.06, n_runs=()):
    """A 1.5 kb reference and a copy with substitutions, indels and the
    query N runs `n_runs` ((start, end) pairs) and reference N runs at
    [160, 192) and [512, 544)."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, 1500).astype(np.uint8)
    q = ref.copy()
    m = rng.random(len(q)) < sub
    q[m] = _off(q[m])
    q = np.concatenate([q[:700], q[706:1100], rng.integers(0, 4, 5).astype(
        np.uint8), q[1100:]])
    for a, b in n_runs:
        q[a:b] = 4
    r = ref.copy()
    if n_runs:
        r[160:192] = 4
        r[512:544] = 4
    return r, q


def _repeats(seed, n=1200):
    """A reference of short units repeated 1-4 times (8% mutated) and a
    copy with 5% substitutions cut into seven blocks and shuffled: events
    whose backward scan the literal entry before them cuts short."""
    rng = np.random.default_rng(seed)
    out = []
    while sum(map(len, out)) < n:
        u = rng.integers(0, 4, int(rng.integers(5, 70))).astype(np.uint8)
        for _ in range(int(rng.integers(1, 5))):
            v = u.copy()
            m = rng.random(len(v)) < 0.08
            v[m] = rng.integers(0, 4, m.sum())
            out.append(v)
    ref = np.concatenate(out)[:n]
    q = ref.copy()
    m = rng.random(len(q)) < 0.05
    q[m] = (q[m] + 1) % 4
    parts = np.split(q, sorted(rng.integers(0, len(q), 6)))
    rng.shuffle(parts)
    return ref, np.concatenate(parts)


def _cases():
    p = Params()
    for t in (31, 32, 33, 63, 64, 65):
        yield f"fwd_{t}", *_fwd(t), p
        yield f"bwd_{t}", *_bwd(t), p
    yield "bwd_capped", *_repeats(2), p
    yield "bwd_capped_wide", *_repeats(0), p
    yield "gap_wide", *_gap(36), p
    yield "gap_ties", *_gap(36, all_miss=True), p
    yield "gap_shift", *_dup(30, 14, 20), p
    yield "gap_shift_wide", *_dup(38, 12, 36), p
    yield "aw_32", *_related(8), _params(approx_window=32,
                                         approx_mismatches=14)
    yield "aw_40", *_related(9), _params(approx_window=40,
                                         approx_mismatches=18)
    yield "ar_36", *_related(11), _params(approx_window=40,
                                          approx_mismatches=18,
                                          approx_run_len=36)
    yield "kill_wide", *_kill(), _params(min_region_len=200)
    yield "n_words", *_related(10, 0.02, ((64, 96), (256, 288))), p
    yield "many_factors", *_many(), p


EDGES = {name: (ref, q, p) for name, ref, q, p in _cases()}


def _close_gaps(log, p, dsz):
    """(literal run, r_right - r_left) of each close event of a log, as
    the replay computes them."""
    out, i, pred, lit = [], 0, -dsz, 0
    for i_ev, pos, ln, _, ext in log[:, :5].tolist():
        lit += i_ev - i
        pred = -dsz if lit > p.max_dist_in_query else pred + i_ev - i
        i = i_ev
        if pred >= 0 and abs(pos - pred) <= p.max_dist_in_ref:
            out.append((lit, pos + ln - (pred - lit)))
        i, pred, lit = i + ln + ext, pos + ln + ext, 0
    return out


class _Caps(fs._Pair):
    """The plain replay, noting each backward scan's cap and what the scan
    would reach without it."""

    def __init__(self, *args):
        super().__init__(*args)
        self.caps = []

    def extend(self, dpos, rpos, max_len, fwd):
        if not fwd:
            full = super().extend(dpos, rpos, 1 << 30, False)
            self.caps.append((min(max_len, dpos, rpos), full))
        return super().extend(dpos, rpos, max_len, fwd)


def reached(name, ref, q, p) -> bool:
    """Whether the pair's event log (and factor list) reaches the edge its
    name says."""
    log = ne.parse_event_log(ref, q, p)
    kind, _, t = name.partition("_")
    if name.startswith("bwd_capped"):
        R, Q, _, _, D, NR = kernel_args(ref, q, p)
        pair = _Caps(bytes(R[0, :int(NR[0])].tolist()),
                     bytes(Q[0, :int(D[0])].tolist()),
                     ParseCfg.from_params(p), fs.stack_entries(Q.shape[1]))
        pair.replay([r[:5] for r in log.tolist()])
        cut = [cap for cap, full in pair.caps if full > cap]
        return any(c > 32 if name.endswith("wide") else c <= 32
                   for c in cut)
    if kind in ("fwd", "bwd"):
        return int(t) in log[:, 4 if kind == "fwd" else 3].tolist()
    gaps = _close_gaps(log, p, len(q) + p.max_dist_in_ref)
    to_scan = [min(span, lit) for lit, span in gaps]
    if name in ("gap_wide", "gap_ties"):
        return max(to_scan, default=0) > 32
    if name.startswith("gap_shift"):
        return any(s < lit for (lit, _), s in zip(gaps, to_scan))
    if kind == "aw":
        return p.approx_window == int(t) and (log[:, 3:5] > 0).any()
    if kind == "ar":
        # runs longer than a scan word
        return p.approx_run_len == int(t) and (log[:, 3:5] > 32).any()
    if name == "kill_wide":
        # the first event's region is shorter than reg, the second is
        # distant, and the region held more than 32 factors
        args = kernel_args(ref, q, p)
        args[3][0, 0] = 1
        _, _, fac, nfac = fs.fold_stats_plain(*args, ParseCfg.from_params(p),
                                              want_factors=True)
        popped = int((fac[0, 0, :int(nfac[0, 0]), 0] >= log[0, 0]).sum())
        return (len(log) >= 2 and log[0, 2] + log[0, 4] < p.min_region_len
                and abs(log[1, 1] - (log[0, 1] + log[0, 2] + log[0, 4]))
                > p.max_dist_in_ref and popped > 33)
    if name == "n_words":
        return (q[64:96] == 4).all() and (ref[160:192] == 4).all()
    return len(ne.parse_factors(ref, q, p)) > fs.RING   # many_factors


def kernel_args(ref, q, p):
    """The fold's inputs for one pair (the oracle's event log), its
    buffers padded to the kernel's multiples (LrP of 128, LqP of 32)."""
    R, Q, E, N, D, NR = fold_args([ref], [q], p)
    R = torch.nn.functional.pad(R, (0, -R.shape[1] % 128), value=4)
    Q = torch.nn.functional.pad(Q, (0, -Q.shape[1] % 128), value=5)
    return R, Q, E, N, D, NR


@pytest.mark.parametrize("name", list(EDGES))
def test_an_edge_input_reaches_its_edge(name):
    assert reached(name, *EDGES[name])


@pytest.mark.parametrize("name", list(EDGES))
def test_fold_equals_the_native_replay_on_an_edge(name):
    ref, q, p = EDGES[name]
    stats, status, fac, nfac = fs.fold_stats(
        *kernel_args(ref, q, p), ParseCfg.from_params(p), want_factors=True)
    assert status.tolist() == [[0]]
    assert tuple(stats[0, 0].tolist()) == ne.parse_pair(ref, q, p)[0]
    assert np.array_equal(fac[0, 0, :int(nfac[0, 0])].numpy(),
                          ne.parse_factors(ref, q, p))


@pytest.mark.parametrize("name", ["fwd_65", "gap_shift_wide", "n_words"])
def test_fold_equals_the_jax_automaton_on_an_edge(name):
    ref, q, p = EDGES[name]
    got_stats, got_fac = tej.parse_pair_jax(ref, q, p, want_factors=True,
                                            device=CPU)
    want_stats, want_fac = jej.parse_pair_jax(ref, q, p, want_factors=True)
    assert got_stats == want_stats
    assert np.array_equal(got_fac, want_fac)


H100_SMEM = 232_448 - 1_024   # the opt-in limit less the reserved 1 KiB


@pytest.mark.parametrize("G,B,LrP,LqP,smem,want", [
    # the jax path's row launch: a warp a block, everything in shared
    # memory (48 KiB of reference planes, a 16 KiB ring, 24 KiB of query
    # planes), a block per query
    (1, 255, 1 << 17, 1 << 16, H100_SMEM,
     (90_112, True, True, 1, 255)),
    (1, 64, 1 << 17, 1 << 16, H100_SMEM, (90_112, True, True, 1, 64)),
    # a 300 kb reference: its planes (384 KiB) stay in device memory
    (1, 64, 1 << 20, 1 << 16, H100_SMEM, (40_960, False, True, 1, 64)),
    # G = 4 x 256: seven warps a block, whose query slots do not fit
    (4, 256, 1 << 17, 1 << 16, H100_SMEM,
     (163_840, True, False, 7, 37)),
    # only the rings fit: the planes are read from device memory
    (1, 64, 1 << 17, 1 << 16, 16_384, (16_384, False, False, 1, 64)),
    # query rows of an odd number of words cannot be copied in 16 B
    (1, 8, 1 << 12, 96, H100_SMEM, (16_384 + 1_536, True, False, 1, 8)),
])
def test_launch_plan(G, B, LrP, LqP, smem, want):
    assert fs.launch_plan(G, B, LrP, LqP, 132, smem) == want


def test_launch_plan_refuses_rings_that_do_not_fit():
    with pytest.raises(ValueError, match="rings"):
        fs.launch_plan(1, 8, 1 << 12, 1 << 12, 132, 1_000)
    assert fs.launch_plan(1, 8, 1 << 12, 1 << 12, 132, 1_000, ring=64)[:3] \
        == (512, False, False)


def test_ring_must_be_a_power_of_two():
    """The wrapper checks the ring before it looks at the device."""
    ref, q, p = EDGES["fwd_31"]
    args = [a.to("meta") for a in kernel_args(ref, q, p)]
    with pytest.raises(ValueError, match="power of two"):
        fs._launch(None, *args, ParseCfg.from_params(p), False, ring=48)


def test_the_build_key_covers_included_headers(tmp_path):
    """A kernel's build is named by its source and by every header it
    includes (transitively): changing a header changes the name, so the
    fold and parse kernels rebuild when planes.cuh changes."""
    from lzani_tpu_torch.ops import build

    (tmp_path / "a.cu").write_text('#include "h.cuh"\nint a;\n')
    (tmp_path / "h.cuh").write_text('#include "g.cuh"\n')
    (tmp_path / "g.cuh").write_text("int g;\n")
    src = [str(tmp_path / "a.cu")]
    k0 = build.build_key(src, ("-O3",), "")
    assert build.build_key(src, ("-O3",), "") == k0
    (tmp_path / "g.cuh").write_text("int g2;\n")
    assert build.build_key(src, ("-O3",), "") != k0
    assert {p.rsplit("/", 1)[-1] for p in build._inputs([fs.SOURCE])} == {
        "fold_stats.cu", "planes.cuh"}
