"""Edge inputs of the long-genome parse kernel (``lzt_parse_events_big`` in
csrc/parse_events.cu) on the CPU. Each input is first shown to reach its
edge, then the kernel's plain version ``parse_events_big_plain`` equals
the native oracle (``native_engine.parse_event_log``) pair for pair:

  anchors          query positions with 59 and 149 anchor candidates
                   (past a lane's 32 and the group path's 7-bit count);
  literal_run      a synced run of literal steps that crosses a 32-position
                   word and reaches the desync (lit_run > mqd);
  word_edges       genome lengths, query lengths (dsz) and a composite
                   length within one symbol of a 32-symbol word edge, each
                   parsed to its last symbol;
  self_padding     the self pairs and padding rows (dsz = msl: limit 0),
                   their candidate planes, next_hit and query rows made
                   garbage: nothing is read, nev = 0.

tests/test_torch_cuda.py runs the kernel on the same inputs
(``test_big_kernel_on_an_edge_input``). Also here: the kernel's launch
plan and its scratch. Every comparison is exact."""
import functools

import numpy as np
import pytest
import torch

from lzani_tpu.core import native_engine as ne
from lzani_tpu_torch.ops import cuda_engine as tce
from lzani_tpu_torch.ops import parse_kernel as pk
from lzani_tpu_torch.synth import bacterial_params, mutate

CPU = torch.device("cpu")


def _anchors():
    """A reference with a 13-mer x 60 and an 11-mer x 150 tandem block,
    and a query holding 30 and 40 copies between unrelated stretches: its
    desync jumps land on 20-mers with 59 and 149 candidates."""
    rng = np.random.RandomState(5)
    ua = rng.randint(0, 4, 13).astype(np.uint8)
    ub = rng.randint(0, 4, 11).astype(np.uint8)
    base = rng.randint(0, 4, 1200).astype(np.uint8)
    g = np.concatenate([base[:400], np.tile(ua, 60), base[400:800],
                        np.tile(ub, 150), base[800:]])
    q = np.concatenate([rng.randint(0, 4, 300), np.tile(ua, 30),
                        rng.randint(0, 4, 300), np.tile(ub, 40),
                        rng.randint(0, 4, 300)]).astype(np.uint8)
    return [g, q], None


def _literal_run():
    """A 1% relative with 70 unrelated symbols inserted: past the event
    before them the parse stays synced over more than mqd literal
    steps."""
    rng = np.random.RandomState(7)
    g = rng.randint(0, 4, 2000).astype(np.uint8)
    q = np.concatenate([g[:900], rng.randint(0, 4, 70).astype(np.uint8),
                        g[900:]])
    return [g, mutate(rng, q, 0.01, n_ns=0, indels=0)], None


#: genome lengths: 1279-1281 at a word edge (the last symbol), 1303-1305
#: with dsz = L + mrd at one (1343-1345), 1284 with the composite
#: 2 L + 3 mrd at one (2688)
EDGE_LENGTHS = (1279, 1280, 1281, 1303, 1304, 1305, 1284)


def _word_edges():
    """Each length's genome and a relative with 1% substitutions before
    its last 40 symbols, the genomes as references: each pair's last
    event ends at the last symbol of both."""
    rng = np.random.RandomState(9)
    codes = []
    for L in EDGE_LENGTHS:
        g = rng.randint(0, 4, L).astype(np.uint8)
        q = g.copy()
        q[:L - 40] = mutate(rng, g[:L - 40], 0.01, n_ns=0, indels=0)
        codes += [g, q]
    return codes, list(range(0, len(codes), 2))


def _self_padding():
    """Three genomes (a base and two relatives) in a launch of B_big = 8
    queries: three self pairs and five padding rows per reference."""
    rng = np.random.RandomState(13)
    g = rng.randint(0, 4, 1500).astype(np.uint8)
    return [g, mutate(rng, g, 0.02, n_ns=2, indels=2),
            mutate(rng, g, 0.05, n_ns=0, indels=4)], None


EDGES = {"anchors": _anchors, "literal_run": _literal_run,
         "word_edges": _word_edges, "self_padding": _self_padding}


def noop_pairs(args):
    """(G, B) bool: the pairs that parse nothing (dsz <= msl): the self
    pairs and the padding rows."""
    return args[6] <= args[8].msl


def poison(args):
    """`args` with every no-op pair's candidate planes, next_hit and (for
    the padding rows) query symbols made garbage: a start past the
    position list, counts of 10^6, next_hit 0, random codes."""
    noop = noop_pairs(args)
    cand, nh, qbuf = args[3].clone(), args[4].clone(), args[1].clone()
    cand[:, :, 0][noop] = 1 << 30
    cand[:, :, 1][noop] = 10**6
    nh[noop] = 0
    pad = noop.all(dim=0)
    gen = torch.Generator().manual_seed(3)
    qbuf[pad] = torch.randint(0, 4, qbuf[pad].shape, generator=gen,
                              dtype=torch.uint8).to(qbuf.device)
    return (args[0], qbuf, args[2], cand, nh, *args[5:])


def big_launch(name, device):
    """(codes, params, r_list, kernel args) of edge input `name`: one
    long-genome launch of its references x the first B_big queries, at
    the tuned bacterial parameters (mal 20 > 13: every row is big)."""
    codes, r_list = EDGES[name]()
    p = bacterial_params()
    eng = tce.CudaAll2All(codes, p, devices=[device])
    assert set(eng.paths) == {"big"}
    r_list = list(range(len(codes))) if r_list is None else r_list
    eng.big_launch_shape(len(r_list), device)
    assert eng.B_big >= len(codes)
    route = eng.routes["big"]
    args = route.args(route.build(r_list, device), r_list, 0, device)
    if name == "self_padding":
        args = poison(args)
    return codes, p, r_list, args


@functools.lru_cache(maxsize=None)
def _plain(name):
    codes, p, r_list, args = big_launch(name, CPU)
    return codes, p, r_list, args, pk.parse_events_big_plain(*args)


def assert_oracle(codes, p, r_list, ev, nev):
    """Every pair's log equals the oracle's; a self pair's is empty, and
    so is every padding row's. Returns the pairs held to the oracle."""
    checked = 0
    for g, r in enumerate(r_list):
        for b in range(nev.shape[1]):
            n = int(nev[g, b])
            if b == r or b >= len(codes):
                assert n == 0, (r, b)
                continue
            want = ne.parse_event_log(codes[r], codes[b], p)
            assert np.array_equal(ev[g, b, :n].cpu().numpy(), want), (r, b)
            checked += 1
    return checked


def _events(ev, nev, g, b):
    return ev[g, b, :int(nev[g, b]), :5].long()


@pytest.mark.parametrize("name", EDGES)
def test_an_edge_input_reaches_its_edge(name):
    codes, p, r_list, args, (ev, nev) = _plain(name)
    cand, dsz, nrs = args[3], args[6], args[7]
    if name == "anchors":
        e = _events(ev, nev, 0, 1)
        counts = set(cand[0, 1, 1][e[:, 0]].tolist())
        assert any(32 < c <= 127 for c in counts) and max(counts) > 127
    elif name == "literal_run":
        e = _events(ev, nev, 0, 1)
        ends = e[:, 0] + e[:, 2] + e[:, 4]
        gaps = e[1:, 0] - ends[:-1]
        k = int(gaps.argmax())
        assert gaps[k] > p.max_dist_in_query             # desynced
        assert ends[k] // 32 != (ends[k] + p.max_dist_in_query) // 32
    elif name == "word_edges":
        mrd = p.max_dist_in_ref
        for g, r in enumerate(r_list):
            L = len(codes[r])
            assert {L % 32, (L + mrd) % 32, int(nrs[g]) % 32} & {31, 0, 1}
            last = _events(ev, nev, g, r + 1)[-1]
            assert int(last[0] + last[2] + last[4]) == L == len(codes[r + 1])
            assert int(last[1] + last[2] + last[4]) == L
            assert int(dsz[g, r + 1]) == L + mrd
    else:
        noop = noop_pairs(args)
        want = torch.zeros_like(noop)
        for g, r in enumerate(r_list):
            want[g, r] = True
        want[:, len(codes):] = True
        assert torch.equal(noop, want)
        assert bool((dsz[noop] == p.min_seed_len).all())   # limit 0
        assert bool((args[4][noop] == 0).all())          # poisoned
        assert bool((nev[noop] == 0).all())


@pytest.mark.parametrize("name", EDGES)
def test_plain_equals_the_oracle_on_an_edge(name):
    codes, p, r_list, args, (ev, nev) = _plain(name)
    assert assert_oracle(codes, p, r_list, ev, nev) > 0


def test_poisoned_no_op_pairs_change_no_log():
    """The self-padding input with and without its garbage tables: equal
    logs, every no-op pair's empty."""
    codes, p, r_list, args, (ev, nev) = _plain("self_padding")
    eng = tce.CudaAll2All(codes, p, devices=[CPU])
    eng.big_launch_shape(len(codes), CPU)
    route = eng.routes["big"]
    clean = route.args(route.build(r_list, CPU), r_list, 0, CPU)
    ev2, nev2 = pk.parse_events_big_plain(*clean)
    assert torch.equal(nev, nev2)
    for g in range(nev.shape[0]):
        for b in range(nev.shape[1]):
            n = int(nev[g, b])
            assert torch.equal(ev[g, b, :n], ev2[g, b, :n])


@pytest.mark.parametrize("pairs,n_sm,want", [
    (48, 132, (1, 48)),          # the bacterial launch: a warp an SM
    (132, 132, (1, 132)),
    (133, 132, (2, 67)),
    (1000, 132, (8, 125)),
    (5000, 132, (8, 625)),
    (1, 132, (1, 1)),
])
def test_big_launch_plan(pairs, n_sm, want):
    """One warp a block while the pairs are no more than the SMs, then up
    to MAX_WARPS a block; a warp for each pair, no block more than that
    needs."""
    warps, blocks = pk.big_launch_plan(pairs, n_sm)
    assert (warps, blocks) == want
    assert 1 <= warps <= pk.MAX_WARPS
    assert warps * blocks >= pairs > warps * (blocks - 1)


def test_big_scratch():
    """The planes of the G references and the B queries (3 words a 32
    symbols); each query's planes packed to its longest pair; the pairs
    longest first (ties in pair order); the counter at 0."""
    dsz = torch.tensor([[11, 900, 700, 11], [800, 11, 700, 11]],
                       dtype=torch.int32)
    rpl, qpl, qlens, order, counter = pk.big_scratch(dsz, 1 << 12, 1 << 10)
    assert all(t.dtype == torch.int32 for t in (rpl, qpl, qlens, order,
                                                 counter))
    assert rpl.shape == (2, 3, 128) and qpl.shape == (4, 3, 32)
    assert qlens.tolist() == [800, 900, 700, 11]
    assert order.tolist() == [1, 4, 2, 6, 0, 3, 5, 7]
    assert counter.tolist() == [0]
