"""Seeded genome collections for the benchmark's traffic mixes (numpy).

A frozen copy of ``lzani_tpu_torch/synth.py`` as of commit 42336e4
(``mutate``, ``viral_set``, ``bacterial_genome``, ``bacterial_relative``,
``bacterial_set``, ``write_fasta``), so that a later change to the
program's generator leaves the benchmark's inputs as they are. It is
parametrised by a configuration's ``collection`` block (how many genomes,
how long) and a traffic file (how they are related), and changed in one
respect: every seed gets the same set of sizes. Genome lengths and
divergence rates are evenly spaced over their ranges and dealt out in a
seeded order, and the number of indels of a variant follows its length
and rate, where the original drew all three at random; a bacterial
species has as many relatives as the mix asks for, where the original
had one per rate. So two seeds ask for the same amount of work in
another arrangement.

Codes are 0..3 for ACGT and 4 for N.
"""

from __future__ import annotations

import numpy as np

_LETTERS = np.frombuffer(b"ACGTN", np.uint8)


def rng_for(seed: int, stream: int) -> np.random.RandomState:
    """The legacy numpy generator of collection `stream` of a run with
    `seed` (any whole number; Mersenne Twister seeded through a
    SeedSequence, whose stream numpy keeps fixed across versions)."""
    ss = np.random.SeedSequence([seed % (1 << 64), stream])
    return np.random.RandomState(np.random.MT19937(ss))


def grid(lo: float, hi: float, k: int, rng) -> np.ndarray:
    """`k` values evenly spaced over [lo, hi) (bin centres), in a seeded
    order."""
    return (lo + (hi - lo) * (np.arange(k) + 0.5) / k)[rng.permutation(k)]


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


def viral_set(rng, collection: dict, mix: dict):
    """(names, codes, family of each genome, -1 for an unrelated one).

    ``collection``: ``genomes``, ``min_len``, ``max_len``. ``mix``:
    ``families``, ``unrelated_share``, ``rate`` ([lo, hi) of a variant's
    substitution rate), ``indel_bp`` (one small indel per this many
    substituted bases' worth of length: len * rate / indel_bp), ``n_runs``
    (most N runs a variant gets, drawn 0..n_runs) and ``n_run_len`` (the
    longest N run)."""
    n = int(collection["genomes"])
    lo, hi = int(collection["min_len"]), int(collection["max_len"])
    n_families = int(mix["families"])
    n_unrel = int(round(n * float(mix["unrelated_share"])))
    n_fam = n - n_unrel
    sizes = np.full(n_families, n_fam // n_families)
    sizes[:n_fam % n_families] += 1
    lengths = grid(lo, hi, n_families + n_unrel, rng).astype(np.int64)
    rates = grid(float(mix["rate"][0]), float(mix["rate"][1]), n_fam, rng)
    names, codes, family = [], [], []
    k = 0
    for f, size in enumerate(sizes):
        base = rng.randint(0, 4, lengths[f]).astype(np.uint8)
        for v in range(size):
            rate = float(rates[k])
            k += 1
            g = mutate(rng, base, rate, n_ns=0,
                       indels=int(round(len(base) * rate
                                        / float(mix["indel_bp"]))))
            for _ in range(rng.randint(0, int(mix["n_runs"]) + 1)):
                p = rng.randint(0, len(g) - 60)
                g[p:p + rng.randint(1, int(mix["n_run_len"]) + 1)] = 4
            names.append(f"fam{f:02d}_v{v:02d}")
            codes.append(g)
            family.append(f)
    for u in range(n_unrel):
        names.append(f"unrel{u:03d}")
        codes.append(rng.randint(0, 4, lengths[n_families + u])
                     .astype(np.uint8))
        family.append(-1)
    order = rng.permutation(n)
    return ([names[i] for i in order], [codes[i] for i in order],
            [family[i] for i in order])


def bacterial_genome(rng, L, mix):
    """A bacterial-shaped genome of `L` bp: a random base with an
    rRNA-like repeat island (``island_copies`` copies of an
    ``island_len`` unit), ``is_copies`` copies of an ``is_len`` IS
    element, and one tandem block of a ``tandem_unit``-mer x
    ``tandem_copies``."""
    g = rng.randint(0, 4, L).astype(np.uint8)
    unit_len = int(mix["island_len"])
    unit = rng.randint(0, 4, unit_len).astype(np.uint8)
    for _ in range(int(mix["island_copies"])):
        p = rng.randint(0, L - unit_len - 1000)
        g[p:p + unit_len] = unit
    is_len = int(mix["is_len"])
    is_el = rng.randint(0, 4, is_len).astype(np.uint8)
    for _ in range(int(mix["is_copies"])):
        p = rng.randint(0, L - is_len - 300)
        g[p:p + is_len] = is_el
    tandem = np.tile(rng.randint(0, 4, int(mix["tandem_unit"]))
                     .astype(np.uint8), int(mix["tandem_copies"]))
    p = rng.randint(0, L - len(tandem))
    g[p:p + len(tandem)] = tandem
    return g


def bacterial_relative(rng, g, rate, mix):
    """`g` with substitutions at `rate` and ``indels`` structural indels
    of ``indel_len`` [lo, hi) bp."""
    q = g.copy()
    m = rng.rand(len(q)) < rate
    q[m] = (q[m] + rng.randint(1, 4, m.sum())) % 4
    lo, hi = (int(x) for x in mix["indel_len"])
    for _ in range(int(mix["indels"])):
        k = rng.randint(0, len(q) - 5000)
        if rng.rand() < 0.5:
            q = np.delete(q, slice(k, k + rng.randint(lo, hi)))
        else:
            ins = rng.randint(0, 4, rng.randint(lo, hi)).astype(np.uint8)
            q = np.concatenate([q[:k], ins, q[k:]])
    return np.ascontiguousarray(q)


def bacterial_set(rng, collection: dict, mix: dict):
    """(names, codes, species of each genome): per species of
    ``collection["species_lengths"]`` a base genome and ``mix["relatives"]``
    relatives, their substitution rates evenly spaced over
    ``mix["relative_rates"]`` ([lo, hi], both ends included)."""
    lo, hi = (float(x) for x in mix["relative_rates"])
    rates = np.linspace(lo, hi, int(mix["relatives"]))
    names, codes, family = [], [], []
    for s, L in enumerate(collection["species_lengths"]):
        g = bacterial_genome(rng, int(L), mix)
        names.append(f"sp{s}_base")
        codes.append(g)
        family.append(s)
        for k, rate in enumerate(rates):
            names.append(f"sp{s}_rel{k:02d}")
            codes.append(bacterial_relative(rng, g, float(rate), mix))
            family.append(s)
    return names, codes, family


GENERATORS = {"viral": viral_set, "bacterial": bacterial_set}


def collection(seed: int, stream: int, collection_cfg: dict, mix: dict):
    """(names, codes, family) of collection `stream` of a run: the
    generator that the traffic file names, fed the configuration's sizes
    and the mix's parameters."""
    return GENERATORS[mix["generator"]](rng_for(seed, stream),
                                        collection_cfg, mix)


def write_fasta(path: str, names, codes) -> None:
    """FASTA with 80 symbols per line."""
    with open(path, "wb") as fh:
        for name, c in zip(names, codes):
            s = _LETTERS[c].tobytes()
            fh.write(b">" + name.encode() + b"\n")
            for k in range(0, len(s), 80):
                fh.write(s[k:k + 80] + b"\n")
