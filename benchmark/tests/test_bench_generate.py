"""The frozen generators: the same seed gives the same collections, the
sizes are the ones stated, and every seed gets the same set of genome
lengths (in another order)."""

import json
import os

import numpy as np

from benchmark import generate, harness


def _load(name):
    with open(os.path.join(harness.BENCH_DIR, name)) as fh:
        return json.load(fh)


VIRAL = _load("configs/viral-default.json")["collection"]


def _small(coll, genomes=64):
    return dict(coll, genomes=genomes)


def test_same_seed_same_collection():
    mix = _load("traffic/families.json")
    a = generate.collection(2**31 + 5, 0, _small(VIRAL), mix)
    b = generate.collection(2**31 + 5, 0, _small(VIRAL), mix)
    assert a[0] == b[0] and a[2] == b[2]
    assert all(np.array_equal(x, y) for x, y in zip(a[1], b[1]))
    c = generate.collection(2**31 + 5, 1, _small(VIRAL), mix)
    assert a[0] != c[0] or any(len(x) != len(y) for x, y in zip(a[1], c[1]))


def test_viral_sizes_as_stated():
    for traffic, fams in (("families", 24), ("dissimilar", 6)):
        mix = _load(f"traffic/{traffic}.json")
        names, codes, fam = generate.collection(7, 0, VIRAL, mix)
        assert len(codes) == VIRAL["genomes"] == 256
        n_unrel = round(256 * mix["unrelated_share"])
        assert sum(f < 0 for f in fam) == n_unrel
        sizes = np.bincount([f for f in fam if f >= 0])
        assert len(sizes) == fams and sizes.max() - sizes.min() <= 1
        lens = np.array([len(c) for c in codes])
        # bases within the range; variants move by their small indels
        assert lens.min() >= 0.99 * VIRAL["min_len"]
        assert lens.max() <= 1.01 * VIRAL["max_len"]
        assert all(set(np.unique(c)) <= {0, 1, 2, 3, 4} for c in codes[:8])
        assert len(set(names)) == 256


def test_every_seed_gets_the_same_lengths():
    mix = _load("traffic/families.json")
    bases = []
    for seed in (1, 99, 2**31 + 1):
        names, codes, fam = generate.collection(seed, 0, _small(VIRAL, 128),
                                                mix)
        unrel = sorted(len(c) for c, f in zip(codes, fam) if f < 0)
        fam_lens = sorted(
            max(len(c) for c, f2 in zip(codes, fam) if f2 == f)
            for f in set(fam) if f >= 0)
        bases.append(sorted(unrel + fam_lens))
    # the unrelated genomes and the family bases draw from one fixed grid
    grid = sorted(generate.grid(VIRAL["min_len"], VIRAL["max_len"],
                                len(bases[0]), np.random.RandomState(0))
                  .astype(np.int64).tolist())
    for b in bases:
        assert len(b) == len(grid)
        assert sum(abs(x - y) for x, y in zip(b, grid)) < 0.02 * sum(grid)


def test_bacterial_sizes_as_stated():
    coll = dict(_load("configs/bacterial-tuned.json")["collection"],
                species_lengths=[30000, 50000])
    mix = _load("traffic/species.json")
    names, codes, fam = generate.collection(3, 0, coll, mix)
    assert fam == [0] * 8 + [1] * 8
    assert names[:3] == ["sp0_base", "sp0_rel00", "sp0_rel01"]
    assert names[8] == "sp1_base" and names[-1] == "sp1_rel06"
    assert len(codes[0]) == 30000 and len(codes[8]) == 50000
    # the relatives' rates run evenly from 3% to 6% (seen without indels)
    _, codes, _ = generate.collection(3, 0, coll, dict(mix, indels=0))
    diff = [float(np.mean(codes[0] != codes[k])) for k in range(1, 8)]
    assert abs(diff[0] - 0.03) < 0.004 and abs(diff[-1] - 0.06) < 0.004
    assert diff == sorted(diff)
