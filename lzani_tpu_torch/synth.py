"""Seeded synthetic genome sets (numpy; no jax).

``small_family`` is a six-sequence test set and ``rand_params`` draws
random parameters for fuzzing. ``viral_set`` makes a viral-collection-
shaped input: genomes of 20-60 kb in families whose variants carry 1-10%
substitutions, small indels and a few N runs, plus a share of unrelated
genomes. ``bacterial_set`` makes two species of 3 and 5 Mb genomes with
repeat islands, IS elements and a tandem block, and two relatives each.
Codes are 0..3 for ACGT and 4 for N, as ``mutate`` and the FASTA writer
expect.
"""

from __future__ import annotations

import numpy as np

from .params import Params

_LETTERS = np.frombuffer(b"ACGTN", np.uint8)


def mutate(rng, ref, rate, n_ns, indels):
    """Copy of `ref` with substitutions at `rate`, `n_ns` single N codes
    and `indels` deletions or insertions of 1..24 symbols."""
    q = ref.copy()
    idx = rng.rand(len(q)) < rate
    q[idx] = (q[idx] + rng.randint(1, 4, idx.sum())) % 4
    if n_ns:
        q[rng.randint(0, len(q), n_ns)] = 4
    for _ in range(indels):
        k = rng.randint(0, len(q) - 30)
        if rng.rand() < 0.5:
            q = np.delete(q, slice(k, k + rng.randint(1, 25)))
        else:
            ins = rng.randint(0, 4, rng.randint(1, 25)).astype(np.uint8)
            q = np.concatenate([q[:k], ins, q[k:]])
    return q


def rand_params(rng):
    """Random LZ-ANI parameters over the ranges of the reference-binary
    differential fuzzer (scripts/stress_kernel_interpret.py), with mal
    kept <= 12 so the dense 4^mal join table stays small."""
    p = Params()
    p.min_seed_len = int(rng.randint(4, 10))
    p.min_anchor_len = int(rng.randint(p.min_seed_len + 1, 13))
    p.max_dist_in_ref = int(rng.randint(8, 64))
    p.max_dist_in_query = int(rng.randint(8, 64))
    p.min_region_len = int(rng.randint(8, 70))
    p.approx_window = int(rng.randint(4, 28))
    p.approx_mismatches = int(rng.randint(1, p.approx_window + 1))
    p.approx_run_len = int(rng.randint(1, 5))
    return p


def small_family(seed: int = 11):
    """Six short sequences of mixed relation (the shape of the JAX
    package's kernel test fixture): a 1.4 kb base, a 5% substituted copy,
    a copy with four deletions, an unrelated 900 bp sequence, a suffix
    with 25 N codes, and an unrelated 320 bp sequence."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 4, 1400).astype(np.uint8)
    codes = [base.copy()]
    m = rng.rand(len(base)) < 0.05
    c = base.copy()
    c[m] = (c[m] + rng.randint(1, 4, m.sum())) % 4
    codes.append(c)
    c = base.copy()
    for _ in range(4):
        p = rng.randint(0, len(c) - 60)
        c = np.concatenate([c[:p], c[p + rng.randint(1, 40):]])
    codes.append(np.ascontiguousarray(c))
    codes.append(rng.randint(0, 4, 900).astype(np.uint8))
    c = base[300:].copy()
    c[rng.randint(0, len(c), 25)] = 4
    codes.append(np.ascontiguousarray(c))
    codes.append(rng.randint(0, 4, 320).astype(np.uint8))
    return codes


FAMILIES = 24
UNRELATED = 0.15
MIN_LEN, MAX_LEN = 20_000, 58_000


def viral_set(seed: int, n: int = 256):
    """(names, codes) for `n` genomes: 15% unrelated ones, the rest split
    over 24 families of variants of 20-58 kb bases."""
    rng = np.random.RandomState(seed)
    n_unrel = int(round(n * UNRELATED))
    n_fam = n - n_unrel
    sizes = np.full(FAMILIES, n_fam // FAMILIES)
    sizes[:n_fam % FAMILIES] += 1
    names, codes = [], []
    for f, size in enumerate(sizes):
        base = rng.randint(0, 4, rng.randint(MIN_LEN, MAX_LEN)).astype(np.uint8)
        for v in range(size):
            rate = rng.uniform(0.01, 0.10)
            g = mutate(rng, base, rate, n_ns=0,
                       indels=int(rng.poisson(len(base) * rate / 400)))
            for _ in range(rng.randint(0, 3)):      # a few N runs
                k = rng.randint(0, len(g) - 60)
                g[k:k + rng.randint(1, 50)] = 4
            names.append(f"fam{f:02d}_v{v:02d}")
            codes.append(g)
    for u in range(n_unrel):
        names.append(f"unrel{u:03d}")
        codes.append(rng.randint(0, 4, rng.randint(MIN_LEN, MAX_LEN))
                     .astype(np.uint8))
    order = rng.permutation(n)
    return [names[i] for i in order], [codes[i] for i in order]


#: species of ``bacterial_set``: (name, base length)
SPECIES = (("spA", 3_000_000), ("spB", 5_000_000))
#: substitution rates of each species' two relatives
REL_RATES = (0.03, 0.06)


def bacterial_genome(rng, L):
    """A bacterial-shaped genome of `L` bp: a random base with an
    rRNA-like repeat island (7 copies of a 5 kb unit), 30 copies of a
    1.2 kb IS element, and one tandem block of a 13-mer x 150 copies
    (its 20-mers have ~150 candidates each, past the group path's 7-bit
    count pack)."""
    g = rng.randint(0, 4, L).astype(np.uint8)
    unit = rng.randint(0, 4, 5000).astype(np.uint8)
    for _ in range(7):
        p = rng.randint(0, L - 6000)
        g[p:p + 5000] = unit
    is_el = rng.randint(0, 4, 1200).astype(np.uint8)
    for _ in range(30):
        p = rng.randint(0, L - 1500)
        g[p:p + 1200] = is_el
    tandem = np.tile(rng.randint(0, 4, 13).astype(np.uint8), 150)
    p = rng.randint(0, L - len(tandem))
    g[p:p + len(tandem)] = tandem
    return g


def bacterial_relative(rng, g, rate):
    """`g` with substitutions at `rate` and 20 structural indels of
    100-3,000 bp."""
    q = g.copy()
    m = rng.rand(len(q)) < rate
    q[m] = (q[m] + rng.randint(1, 4, m.sum())) % 4
    for _ in range(20):
        k = rng.randint(0, len(q) - 5000)
        if rng.rand() < 0.5:
            q = np.delete(q, slice(k, k + rng.randint(100, 3000)))
        else:
            ins = rng.randint(0, 4, rng.randint(100, 3000)).astype(np.uint8)
            q = np.concatenate([q[:k], ins, q[k:]])
    return np.ascontiguousarray(q)


def bacterial_set(seed: int):
    """(names, codes) of two bacterial species, each a base genome (3.0
    and 5.0 Mb) and two relatives at 3% and 6% substitutions: 6 genomes,
    30 ordered pairs, 12 of them within a species. Built like the JAX
    package's long-genome check (scripts/test_big_tpu.py); run it with
    ``bacterial_params()``."""
    rng = np.random.RandomState(seed)
    names, codes = [], []
    for sp, L in SPECIES:
        g = bacterial_genome(rng, L)
        names.append(f"{sp}_base")
        codes.append(g)
        for rate in REL_RATES:
            names.append(f"{sp}_rel{round(rate * 100):02d}")
            codes.append(bacterial_relative(rng, g, rate))
    return names, codes


def bacterial_params() -> Params:
    """The tuned long-genome parameters (the reference's guidance for
    bacteria: ``--mal 20 --msl 11 --reg 80``), others at their defaults.
    With mal > 13 every row takes the long-genome path."""
    p = Params()
    p.min_anchor_len, p.min_seed_len, p.min_region_len = 20, 11, 80
    return p


def write_fasta(path: str, names, codes) -> None:
    """FASTA with 80 symbols per line."""
    with open(path, "wb") as fh:
        for name, c in zip(names, codes):
            s = _LETTERS[c].tobytes()
            fh.write(b">" + name.encode() + b"\n")
            for k in range(0, len(s), 80):
                fh.write(s[k:k + 80] + b"\n")
