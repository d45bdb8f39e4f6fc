"""The plain reference parse equals the port's native engine (the C++
oracle) pair for pair, under the default and the long-genome parameters
and random ones; the reference's TSV lines equal the port's formatter's.
Only this test imports the port."""

import numpy as np
import pytest

from benchmark import check, generate
from benchmark.reference import lz, tsv
from lzani_tpu_torch.core import native_engine
from lzani_tpu_torch.output import ResultMatrix, results_tsv_lines
from lzani_tpu_torch.params import Params
from lzani_tpu_torch.synth import rand_params

MIX = {"generator": "viral", "families": 3, "unrelated_share": 0.2,
       "rate": [0.01, 0.15], "indel_bp": 400, "n_runs": 2, "n_run_len": 49}
BACT = {"generator": "bacterial", "relatives": 2,
        "relative_rates": [0.03, 0.06],
        "indels": 20, "indel_len": [100, 3000], "island_len": 5000,
        "island_copies": 7, "is_len": 1200, "is_copies": 30,
        "tandem_unit": 13, "tandem_copies": 150}


def _cfg(p):
    return lz.Cfg(p.min_anchor_len, p.min_seed_len, p.max_dist_in_ref,
                  p.max_dist_in_query, p.min_region_len, p.approx_window,
                  p.approx_mismatches, p.approx_run_len)


def _all_pairs(codes, p):
    cfg = _cfg(p)
    qs = [lz.Query(c, cfg) for c in codes]
    for r, c in enumerate(codes):
        ri = lz.RefIndex(c, cfg)
        for q in range(len(codes)):
            if q != r:
                got = lz.parse_pair(ri, qs[q], cfg)
                want, _ = native_engine.parse_pair(c, codes[q], p)
                assert got == want, (r, q)


@pytest.mark.parametrize("seed", [1, 2**31 + 7])
def test_viral_pairs_equal_the_oracle(seed):
    coll = {"genomes": 12, "min_len": 4000, "max_len": 12000}
    _, codes, _ = generate.collection(seed, 0, coll, MIX)
    _all_pairs(codes, Params())


@pytest.mark.parametrize("seed", range(4))
def test_random_parameters_equal_the_oracle(seed):
    p = rand_params(np.random.RandomState(seed))
    coll = {"genomes": 6, "min_len": 1500, "max_len": 5000}
    _, codes, _ = generate.collection(100 + seed, 0, coll, MIX)
    _all_pairs(codes, p)


def test_long_genome_parameters_equal_the_oracle():
    p = Params()
    p.min_anchor_len, p.min_seed_len, p.min_region_len = 20, 11, 80
    _, codes, _ = generate.collection(
        9, 0, {"species_lengths": [60000, 90000]}, BACT)
    _all_pairs(codes, p)


def test_reference_lines_equal_the_port_formatter():
    coll = {"genomes": 9, "min_len": 3000, "max_len": 8000}
    names, codes, fam = generate.collection(4, 0, coll, MIX)
    p = Params()
    pairs = [(a, b) for a in range(9) for b in range(a + 1, 9)]
    col = check.Collection(names, codes, _cfg(p), pairs)
    col.compute()
    n = col.n
    dense = np.zeros((n, n - 1, 3), np.int32)
    ordered = [codes[i] for i in col.order]
    for r in range(n):
        for q in range(n):
            if q != r:
                t, _ = native_engine.parse_pair(ordered[r], ordered[q], p)
                dense[r, q - 1 if q > r else q] = t

    class _Store:
        names, no_parts = col.names, [1] * n
        lengths = col.lengths
    want = results_tsv_lines(p, _Store(), ResultMatrix.from_dense(dense))
    assert want[0] == col.header()
    for (r, q), lines in col.expected.items():
        k = 1 + tsv.line_index(n, r, q)
        assert want[k:k + 2] == lines
    assert len(want) == 1 + n * (n - 1)
