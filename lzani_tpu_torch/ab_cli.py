"""A/B wall times of the port's CLI in two checkouts on one host.

    python -m lzani_tpu_torch.ab_cli --tree OLD_DIR --tree NEW_DIR \\
        [--set viral|bacterial] [--n 256] [--seed 2024] \\
        [--backend auto] [--backend hybrid] [--backend cuda] \\
        [--backend native]

Writes one seeded synthetic FASTA (``synth.viral_set`` of `n` genomes, or
``synth.bacterial_set`` with ``--mal 20 --msl 11 --reg 80``), then, per
backend, runs ``python -m lzani_tpu_torch all2all`` from each checkout in
turns (A, B, B, A) as a subprocess with ``-V 2``. Each checkout first
runs once per backend, untimed, on a two-genome file, so that what it
builds at first use (the kernels, the native engine) is not timed (for
``hybrid`` and ``auto`` that run is a ``cuda`` one: on two genomes the
hybrid's warm-up never starts, so it would build nothing).
Prints one line per timed run: wall seconds, pairs/s, the CLI's own
phase timings and (cuda, hybrid, auto) its engine counters, beside the
card's name and power limit; and fails when two runs' TSV or ids files
differ, across checkouts and across backends. A checkout whose CLI has
no hybrid backend (before the port had one, ``auto`` meant ``cuda``) is
left out of the ``hybrid`` and ``auto`` turns. The default backends are
all four. Host clocks vary between calls, so compare only within one
call.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

from . import synth
from .utils.runinfo import card_name_and_power, cli_timings, engine_stats

HYBRID_BACKENDS = ("hybrid", "auto")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True)
    ap.add_argument("--set", choices=("viral", "bacterial"), default="viral")
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--seed", type=int, default=2024)
    ap.add_argument("--backend", action="append")
    a = ap.parse_args(argv)
    trees = [os.path.abspath(t) for t in a.tree]
    smi = card_name_and_power()
    if a.set == "viral":
        names, codes = synth.viral_set(seed=a.seed, n=a.n)
        flags = []
    else:
        names, codes = synth.bacterial_set(a.seed)
        p = synth.bacterial_params()
        flags = ["--mal", str(p.min_anchor_len), "--msl",
                 str(p.min_seed_len), "--reg", str(p.min_region_len)]
    n_pairs = len(codes) * (len(codes) - 1)
    nthreads = str(os.cpu_count() or 1)
    with tempfile.TemporaryDirectory(prefix="ab_cli_") as td:
        fa = os.path.join(td, "in.fna")
        synth.write_fasta(fa, names, codes)
        tiny = os.path.join(td, "tiny.fna")
        synth.write_fasta(tiny, ["a", "b"], synth.small_family()[:2])

        def cli(tree, backend, fasta, out):
            cmd = [sys.executable, "-m", "lzani_tpu_torch", "all2all",
                   "--in-fasta", fasta, "--out", out, "-t", nthreads,
                   "-V", "2", *flags, "--backend", backend]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, cwd=tree, capture_output=True,
                                 text=True)
            wall = time.perf_counter() - t0
            if res.returncode != 0:
                raise RuntimeError(f"{tree} {backend} exited "
                                   f"{res.returncode}: {res.stderr[-2000:]}")
            return wall, res

        def has_hybrid(tree):
            res = subprocess.run(
                [sys.executable, "-c", "from lzani_tpu_torch.cli import "
                 "BACKENDS; print(' '.join(BACKENDS))"], cwd=tree,
                capture_output=True, text=True, check=True)
            return "hybrid" in res.stdout.split()

        hybrid_trees = [t for t in trees if has_hybrid(t)]
        want = None
        for backend in a.backend or ["auto", "hybrid", "cuda", "native"]:
            these = hybrid_trees if backend in HYBRID_BACKENDS else trees
            for tree in these:
                cli(tree, "cuda" if backend in HYBRID_BACKENDS else backend,
                    tiny, os.path.join(td, "tiny.tsv"))
            for k, tree in enumerate(these + these[::-1]):
                out = os.path.join(td, f"{backend}_{k}.tsv")
                wall, res = cli(tree, backend, fa, out)
                with open(out, "rb") as f1, \
                        open(out[:-4] + ".ids.tsv", "rb") as f2:
                    got = f1.read() + f2.read()
                if want is None:
                    want = got
                elif got != want:
                    raise AssertionError(f"{tree} {backend}: output differs")
                st = engine_stats(res.stderr)
                print(f"{a.set} {backend} {tree}: {wall:.2f} s, "
                      f"{n_pairs / wall:.1f} pairs/s, -t {nthreads}; "
                      f"{cli_timings(res.stderr)}"
                      f"{'; engine ' + json.dumps(st) if st else ''} "
                      f"[{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
