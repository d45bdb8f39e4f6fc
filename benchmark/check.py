"""What decides ``correct``: the TSV and ids files that the timed jobs
wrote, held against the plain reference (``benchmark/reference``).

For each of a run's two collections a sample of unordered genome pairs
is drawn from the seed: pairs of one family (or species), pairs drawn
at random, and the related pair with the most symbols.
The reference parses each sampled pair both ways and writes the pair's
two TSV lines; every job of that collection must hold exactly those
lines, at the place the reorder gives them. Every job's ids file, and the
header and key columns (qidx, ridx, query, reference) of every one of its
lines, are compared whole. Nothing here imports the program.

The parses run one reference at a time, in this process or, for a
configuration whose ``check`` names ``workers``, on that many worker
processes (numpy only), which end before the comparison.
"""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from .reference import lz, tsv

#: the numbers compared, each with its limit: an exact comparison
LIMITS = {"jobs_failed": 0, "ids_lines_differ": 0, "tsv_keys_differ": 0,
          "sampled_lines_differ": 0}


def lz_cfg(params: dict) -> lz.Cfg:
    return lz.Cfg(*(int(params[k]) for k in
                    ("mal", "msl", "mrd", "mqd", "reg", "aw", "am", "ar")))


def draw_sample(seed: int, stream: int, family, lengths, n_related: int,
                n_random: int) -> list[tuple[int, int]]:
    """Unordered pairs (a, b), a < b, in generation ids: the related pair
    with the most symbols, `n_related` more pairs of one family and
    `n_random` pairs of any two genomes, each pair once."""
    rng = np.random.RandomState(np.random.MT19937(
        np.random.SeedSequence([seed % (1 << 64), 1000 + stream])))
    n = len(family)
    fam = np.asarray(family)
    a, b = np.triu_indices(n, 1)
    rel = np.flatnonzero((fam[a] == fam[b]) & (fam[a] >= 0))
    ln = np.asarray(lengths, np.int64)
    picked: list[int] = []
    if len(rel):
        picked.append(int(rel[np.argmax(ln[a[rel]] + ln[b[rel]])]))
        rest = rel[rel != picked[0]]
        picked += rng.choice(rest, min(n_related, len(rest)),
                             replace=False).tolist()
    others = np.setdiff1d(np.arange(len(a)), picked)
    picked += rng.choice(others, min(n_random, len(others)),
                         replace=False).tolist()
    return [(int(a[k]), int(b[k])) for k in picked]


def sample_of(seed: int, stream: int, family, codes, check_cfg: dict):
    """The check's sample of one collection as the configuration's
    ``check`` block asks for it."""
    return draw_sample(seed, stream, family, [len(x) for x in codes],
                       int(check_cfg["related"]), int(check_cfg["random"]))


#: the floating-point types a Collection computes in, by name
REALS = {"float64": float, "float32": np.float32}


def parse_row(ref_code, queries, cfg: tuple, real: str):
    """Triples of one reference against each (key, code) of `queries`,
    as {key: triple}: the unit of work of the reference's parses."""
    c = lz.Cfg(*cfg)
    ri = lz.RefIndex(ref_code, c)
    return {k: lz.parse_pair(ri, lz.Query(q, c), c, REALS[real])
            for k, q in queries}


class Collection:
    """One generated collection as the reference sees it: the tool's ids
    (``order[new] = old``), and the expected lines of its sample."""

    def __init__(self, names, codes, cfg: lz.Cfg, sample,
                 comps=tsv.STANDARD, real: str = "float64"):
        self.codes, self.cfg, self.comps = codes, cfg, comps
        self.real = real
        lengths = [len(c) for c in codes]
        self.order = tsv.reorder(names, lengths)
        self.new_id = np.empty(len(names), np.int64)
        self.new_id[self.order] = np.arange(len(names))
        self.names = [names[i] for i in self.order]
        self.lengths = [lengths[i] for i in self.order]
        self.n = len(names)
        self.sample = sample
        self.expected: dict[tuple[int, int], list[str]] = {}

    def ids_lines(self) -> list[str]:
        return tsv.ids_lines(self.names, self.lengths)

    def header(self) -> str:
        return "\t".join(self.comps) + "\n"

    def pairs_new(self) -> list[tuple[int, int]]:
        """The sample in the tool's ids, (r, q) with r < q."""
        out = []
        for a, b in self.sample:
            x, y = int(self.new_id[a]), int(self.new_id[b])
            out.append((min(x, y), max(x, y)))
        return out

    def rows(self):
        """The parses the sample needs, one task a reference, longest
        reference first: (reference, [query, ...])."""
        wanted: dict[int, list[int]] = {}          # reference -> queries
        for r, q in self.pairs_new():
            wanted.setdefault(r, []).append(q)
            wanted.setdefault(q, []).append(r)
        return sorted(wanted.items(), key=lambda kv: -self.lengths[kv[0]])

    def task(self, ref: int, queries: list[int]):
        cfg = tuple(getattr(self.cfg, k) for k in lz.Cfg.__slots__)
        return (self.codes[self.order[ref]],
                [((ref, q), self.codes[self.order[q]]) for q in queries],
                cfg, self.real)

    def finish(self, triples: dict) -> None:
        """Keep each sampled pair's two expected lines."""
        for r, q in self.pairs_new():
            self.expected[(r, q)] = tsv.pair_lines(
                r, q, self.names, self.lengths, triples[(r, q)],
                triples[(q, r)], self.comps, REALS[self.real])

    def compute(self) -> None:
        compute_all([self])


def compute_all(cols: list[Collection], workers: int = 1) -> None:
    """Parse every sampled pair of `cols` both ways, one task a
    reference, on `workers` processes (1: in this one), and keep each
    pair's expected lines."""
    tasks = [(k, col.task(r, qs)) for k, col in enumerate(cols)
             for r, qs in col.rows()]
    found: list[dict] = [{} for _ in cols]
    if workers <= 1:
        for k, t in tasks:
            found[k].update(parse_row(*t))
    else:
        with ProcessPoolExecutor(
                workers, mp_context=multiprocessing.get_context("spawn")) \
                as pool:
            futs = [(k, pool.submit(parse_row, *t)) for k, t in tasks]
            for k, f in futs:
                found[k].update(f.result())
    for col, tr in zip(cols, found):
        col.finish(tr)


def compare_job(col: Collection, tsv_lines: list[str] | None,
                ids_lines: list[str] | None) -> dict[str, int]:
    """The numbers of one job: lines of its ids file that differ from the
    reference's (missing or extra ones count), lines whose header or key
    columns differ, and sampled lines that differ. A job that wrote no
    file counts every line it owed."""
    want_ids = col.ids_lines()
    n_lines = col.n * (col.n - 1)
    out = dict(ids_lines_differ=0, tsv_keys_differ=0,
               sampled_lines_differ=0)
    if ids_lines is None:
        out["ids_lines_differ"] = len(want_ids)
    else:
        out["ids_lines_differ"] = abs(len(ids_lines) - len(want_ids)) + sum(
            x != y for x, y in zip(ids_lines, want_ids))
    if tsv_lines is None:
        out["tsv_keys_differ"] = n_lines + 1
        out["sampled_lines_differ"] = 2 * len(col.expected)
        return out
    keys = tsv.key_columns(col.n)
    names = col.names
    bad = int(not tsv_lines or tsv_lines[0] != col.header())
    bad += abs(len(tsv_lines) - 1 - n_lines)
    for (r, q), line in zip(keys.tolist(), tsv_lines[1:]):
        if not line.startswith(f"{q}\t{r}\t{names[q]}\t{names[r]}\t"):
            bad += 1
    out["tsv_keys_differ"] = bad
    for (r, q), lines in col.expected.items():
        k = 1 + tsv.line_index(col.n, r, q)
        got = tsv_lines[k:k + 2]
        out["sampled_lines_differ"] += sum(
            g != w for g, w in zip(got, lines)) + 2 - len(got)
    return out
