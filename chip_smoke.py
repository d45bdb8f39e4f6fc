#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lzani_tpu_torch) on one GPU.

    python3 chip_smoke.py

Four paths of the port are driven end to end through its CLI, each
with its kernels' launch counters set to 0 just before and read just
after: the cuda backend's group path, its long-genome path, the hybrid
backend (the default), and the automaton backend (``--backend jax``).
Phases (each prints one line; any failure raises, so the exit code is
non-zero):
  1. the card: torch's device name and nvidia-smi's name and power limit;
  2. build: the CUDA parse kernels (one nvcc build of parse_events.cu,
     both C entries), the fold kernel (one nvcc build of fold_stats.cu)
     and the port's native C++ engine (g++), from the sources in this
     checkout, the three compilers started together;
  Group path (default parameters, viral-sized genomes):
  3. kernel = plain: one whole group dispatch of the main path (G = 4
     references x B = 256 queries at the run's LrP/LqP buckets), the
     kernel's event logs against the plain PyTorch version's, element for
     element, on the same card inputs;
  4. the port's CLI (``python -m lzani_tpu_torch all2all ... --backend
     cuda``, driven in-process through ``cli.run``) on a seeded synthetic
     viral set: 256 genomes of 20-60 kb in 24 families plus 15% unrelated
     genomes (65,280 ordered pairs);
  5. the port's native CLI (``python -m lzani_tpu_torch ... --backend
     native``, a subprocess) on the same file: TSV and ids byte-equal,
     aln as a set;
  6. counters: kernel launches > 0 in the main path, no natively routed
     rows, no replay mismatches, capacity fallbacks under 1% of pairs; and
     200 sampled pairs' event logs against the native oracle;
  7. wall times and pairs/s of both CLIs;
  Long-genome path (the tuned bacterial parameters mal 20, msl 11, reg 80;
  mal > 13 sends every row to the big kernel):
  8. big kernel = plain on two whole launches: a reduced one (8 genomes
     of two viral families plus a tandem-repeat pair whose k-mers have
     ~150 candidates: G = 10 x B = 16) and one at the main path's shapes
     (the 6 bacterial genomes below: G = 6 x B = 8 at LqP = 2^23); every
     pair's nev and defined records equal; 4 within-species logs of the
     full launch against the native oracle;
  9. the port's CLI ``--backend cuda`` and ``--backend native`` on
     ``synth.bacterial_set(2024)`` (two species, 3.0 and 5.0 Mb bases
     with two relatives each: 30 ordered pairs): TSV and ids byte-equal,
     aln as a set; big launches > 0 and equal to the kernel's counter, no
     native rows, no replay mismatches, every within-species pair replayed
     from a kernel log; walls, pairs/s, kernel ms per launch, B_big and
     peak device memory.
  Per-reference routes (the API of the JAX package's ``PallasRefIndex``
  and ``PallasAll2All.dispatch_range``, on the group kernel):
 10. ``CudaRefIndex.parse_events_batch`` (the first viral genome x the
     first 64 genomes) and ``CudaAll2All.dispatch_range`` / ``collect``
     (that genome x the 64 queries of an engine over those genomes), each
     with the counter set to 0 just before and read just after (one
     launch each); kernel = plain on each route's own inputs (the plain
     version on the host CPU); 8 sampled logs of each against the native
     oracle.
  Hybrid backend (the native pool and the group engine on one row queue):
 11. the port's CLI ``--backend hybrid`` (in-process) with
     LZANI_TPU_HYBRID_GREEDY=1 on phase 4's viral file: TSV and ids
     byte-equal to phase 5's native output, aln as a set; the warm-up
     succeeded (warm_why None), no row failed over to the host, device
     pairs > 0 and device + cpu pairs = 65,280, launches > 0 and equal to
     the engine's count, no replay mismatches;
 12. the CLI's card check (libcuda) timed in a fresh process; then
     ``--backend auto`` as a subprocess (its wall includes process
     start) on the viral and on the bacterial file, the bacterial one
     just after ``--backend native`` run the same way (the viral one is
     held against phase 5): auto byte-equal to native, no warm-up failure
     (an envelope or a cancel is policy) and no row failed over to the
     host; prints the default policy's stats (warm-up started or not,
     device pairs, duty latches) and both walls.
  Several device entries and several processes:
 13. ``all2all_cuda(devices=[cuda:0, cuda:0])`` in-process on the first
     96 viral genomes (units round-robin over two entries on the one
     card), the kernel's counter set to 0 just before and read just
     after: triples equal to the native engine's, both entries ran units,
     launches > 0 and equal to the engine's count, no replay mismatches;
 14. the port's CLI as a two-process launch on the one card (the JAX
     package's JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
     JAX_PROCESS_ID, gloo on 127.0.0.1, ``-t 4`` each) on phase 4's viral
     file, first ``--backend cuda``, then ``--backend auto``: process 0's
     TSV and ids byte-equal to phase 5's native output, aln as a set;
     process 1 writes no file; each process owns its stride share; under
     cuda each process launched the kernel (its engine's count). Prints
     each process's wall, rows, pairs and launches.
  Automaton backend (the parse kernel's logs folded on the card):
 15. the fold kernel against its plain version (on the host CPU) on the
     64 logs of phase 10's ``parse_events_batch`` launch, with and
     without factors: stats, status (0 for every pair with a log), factor
     counts and factors equal, the stats equal to the native engine's;
     then the main path's launch of reference row 0 (its 255 queries from
     the resident query matrix, as ``all2all_jax`` makes it): the parse
     kernel's logs against the native oracle (its plain version at this
     shape does not fit in the script's time), the fold kernel against
     its plain version, both timed; then the port's CLI ``--backend jax``
     (in-process, no aln file) on phase 4's viral file, both kernels'
     counters set to 0 just before and read just after: TSV and ids
     byte-equal to phase 5's native output, both kernels launched, no
     replay mismatch, capacity fallbacks (pairs parsed on the native
     engine) under 1%; its LZ matching beside the cuda (phase 4) and
     native (phase 5) ones; then ``all2all_sharded`` over the mesh
     ``[cuda:0, cuda:0]`` on the first 48 viral genomes (counters
     likewise), equal to ``all2all_jax`` on the card and to the native
     engine, capacity fallbacks under 1%.
Then the card's name and power limit, one JSON line of the kernels (time,
plain time and bound of each, from this run; the group kernel's entry
also has the hybrid, round-robin and two-process paths' launches), and
the result line last.
Without a CUDA device the script exits 1 and prints no result.
"""

from __future__ import annotations

import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
N_GENOMES = 256
SEED = 2024
N_SAMPLED = 200      # pairs checked against the oracle in phase 6
T_START = time.perf_counter()


def say(phase, msg):
    """One phase's line, with the seconds since the script started."""
    print(f"[{phase} +{time.perf_counter() - T_START:.1f} s] {msg}",
          flush=True)


def phase_times(marks):
    """'label s, ...' from Matcher.times [(perf_counter, label), ...]."""
    return ", ".join(f"{lab} {t - t0:.2f} s" for (t0, _), (t, lab)
                     in zip(marks, marks[1:]) if lab)


def kernel_vs_plain(kernel, plain, args, dsz_pairs, reps, plain_on=None):
    """Time `kernel` (CUDA events, the mean of `reps` launches after one
    that also serves the comparison) and `plain` (host clock, one call) on
    the same inputs: the card's, or with ``plain_on="cpu"`` copies of them
    on the host CPU (where a small launch's plain version runs faster);
    every pair's nev and defined records must be equal. The counter is
    restored: these launches do not count."""
    import numpy as np
    import torch

    from lzani_tpu_torch.utils.runinfo import launch_bound_ms

    launches0 = kernel.launches
    ev_k, nev_k = kernel(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        kernel(*args)
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / reps
    kernel.launches = launches0
    p_args = args if plain_on is None else [
        a.to(plain_on) if isinstance(a, torch.Tensor) else a for a in args]
    t0 = time.perf_counter()
    ev_p, nev_p = plain(*p_args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3

    nk, npl = nev_k.cpu().numpy(), nev_p.cpu().numpy()
    if not np.array_equal(nk, npl):
        bad = np.argwhere(nk != npl)[:5].tolist()
        raise AssertionError(f"{kernel.__name__}: kernel nev != plain nev "
                             f"at (g, b) {bad}")
    mx = max(int(nk.max(initial=0)), 1)
    ek, ep = ev_k[:, :, :mx].cpu().numpy(), ev_p[:, :, :mx].cpu().numpy()
    defined = (np.arange(mx)[None, None, :] < np.maximum(nk, 0)[..., None])
    err = int(np.abs(ek[defined].astype(np.int64)
                     - ep[defined]).max(initial=0))
    if err:
        raise AssertionError(f"{kernel.__name__}: kernel event logs differ "
                             f"from plain (max abs err {err})")
    bound, bound_by = launch_bound_ms(args, nev_k, dsz_pairs)
    return dict(pairs=nk.size, records=int(defined.sum()), ms=ms,
                plain_ms=plain_ms, max_abs_err=err, bound_ms=bound,
                bound_by=bound_by, ev=ev_k, nev=nev_k,
                plain_on=plain_on or "card")


def check_kernel(dev, codes, params):
    """Phase 3: the group kernel against its plain version on one whole
    dispatch of the main path (G = 4 references x B queries)."""
    from lzani_tpu_torch.ops import cuda_engine as ce
    from lzani_tpu_torch.ops.parse_kernel import (parse_events,
                                                  parse_events_plain)

    eng = ce.CudaAll2All(codes, params, devices=[dev])
    gi = eng.build_group_index([0, 1, 2, 3], dev)
    args, _ = eng.group_args(gi, 0, dev)
    k = kernel_vs_plain(parse_events, parse_events_plain, args,
                        args[6].expand(4, -1), reps=3)
    return dict(k, LrP=gi.LrP, LqP=eng.LqP, B=eng.B)


def big_launch(dev, codes, params):
    """The first long-genome launch of the main path on `codes`: every
    reference (if one launch holds them) x the first B_big queries, as
    ``all2all_cuda`` sizes it. Returns (engine, r_list, kernel args)."""
    from lzani_tpu_torch.ops import cuda_engine as ce

    eng = ce.CudaAll2All(codes, params, devices=[dev])
    if set(eng.paths) != {"big"}:
        raise AssertionError(f"rows off the long-genome path: {eng.paths}")
    G, _ = eng.big_launch_shape(len(codes), dev)
    r_list = list(range(G))
    bidx = eng.build_big_index(r_list, dev)
    return eng, r_list, eng.big_args(bidx, r_list, 0, dev)


def reduced_big_set():
    """Phase 8a's genomes: the first 4 of viral families fam00 and fam01
    of ``viral_set(2024)`` and the tandem-repeat pair of the JAX package's
    big-path test (a 13-mer x 150 inside 900 bp, and a 5% mutant)."""
    import numpy as np

    from lzani_tpu_torch import synth

    names, codes = synth.viral_set(seed=SEED, n=N_GENOMES)
    picked = ([c for n, c in zip(names, codes) if n.startswith("fam00")][:4]
              + [c for n, c in zip(names, codes) if n.startswith("fam01")][:4])
    rng = np.random.RandomState(11)
    unit = rng.randint(0, 4, 13).astype(np.uint8)
    base = rng.randint(0, 4, 900).astype(np.uint8)
    g1 = np.concatenate([base[:300], np.tile(unit, 150), base[300:]])
    q1 = g1.copy()
    m = rng.rand(len(q1)) < 0.05
    q1[m] = (q1[m] + rng.randint(1, 4, m.sum())) % 4
    return picked + [g1, q1]


def check_big_kernel(dev, bact_codes, bact_names, params):
    """Phase 8: the big kernel against its plain version on a reduced
    launch and on the main path's first launch over the bacterial set;
    4 within-species logs of the latter against the oracle."""
    import numpy as np

    from lzani_tpu_torch.core import native_engine as ne
    from lzani_tpu_torch.ops.parse_kernel import (parse_events_big,
                                                  parse_events_big_plain)

    eng, _, args = big_launch(dev, reduced_big_set(), params)
    red = kernel_vs_plain(parse_events_big, parse_events_big_plain, args,
                          args[6], reps=3)
    red.update(G=eng.G_big, B=eng.B_big, LqP=eng.LqP, LrP=eng.LrP_big)
    eng, r_list, args = big_launch(dev, bact_codes, params)
    full = kernel_vs_plain(parse_events_big, parse_events_big_plain, args,
                           args[6], reps=2)
    full.update(G=eng.G_big, B=eng.B_big, LqP=eng.LqP, LrP=eng.LrP_big)
    logs = eng.collect_big((full["ev"], full["nev"]))
    species = [n.split("_")[0] for n in bact_names]
    within = [(r, q) for r in r_list for q in range(eng.B_big)
              if q < len(bact_codes) and q != r and species[r] == species[q]]
    rng = np.random.RandomState(SEED)
    sampled = [within[i] for i in rng.choice(len(within), 4, replace=False)]
    for r, q in sampled:
        want = ne.parse_event_log(bact_codes[r], bact_codes[q], params)
        if logs[r][q] is None or not np.array_equal(logs[r][q], want):
            raise AssertionError(f"bacterial pair ({bact_names[r]}, "
                                 f"{bact_names[q]}): kernel log differs "
                                 f"from the oracle")
    full["oracle"] = [f"{bact_names[r]}/{bact_names[q]} "
                      f"({len(logs[r][q])} events)" for r, q in sampled]
    return red, full


def check_ref_routes(dev, names, codes, params, kernel, plain):
    """Phase 10: the per-reference routes, each driven through its entry
    point with `kernel`'s counter set to 0 just before and read just after:
    ``CudaRefIndex.parse_events_batch`` (the first viral genome x the
    first 64 genomes, one launch) and ``CudaAll2All.dispatch_range`` /
    ``collect`` (that reference x the B = 64 queries of an engine over the
    same 64 genomes). Each route's kernel is then held against the plain
    version on the route's own inputs (on the host CPU: at G = 1 it runs
    there about twice as fast as on the card), and 8 of its logs against
    the native oracle."""
    import numpy as np

    from lzani_tpu_torch.core import native_engine as ne
    from lzani_tpu_torch.ops import cuda_engine as ce

    queries = codes[:64]
    kernel.launches = 0
    idx = ce.CudaRefIndex(codes[0], params)
    logs_b = idx.parse_events_batch(queries)
    launches_b = kernel.launches

    eng = ce.CudaAll2All(queries, params, devices=[dev])
    kernel.launches = 0
    logs_r = eng.collect(eng.dispatch_range(0, 0))
    launches_r = kernel.launches

    args, ovf = idx.batch_args(queries)
    res = kernel_vs_plain(kernel, plain, args, args[6][None], reps=3,
                          plain_on="cpu")
    out = {"batch": dict(res, launches=launches_b, B=len(queries),
                         LqP=args[1].shape[1], skipped=int(ovf.sum()),
                         logs=logs_b, args=args, overflow=ovf)}
    args, _ = eng.group_args(eng.build_index(0, dev), 0, dev)
    res = kernel_vs_plain(kernel, plain, args, args[6][None], reps=3,
                          plain_on="cpu")
    out["range"] = dict(res, launches=launches_r, B=eng.B, LqP=eng.LqP,
                        logs=logs_r)

    rng = np.random.RandomState(SEED)
    for key, r in out.items():
        if r["launches"] != 1:
            raise AssertionError(f"{key} route launched the kernel "
                                 f"{r['launches']} times, not once")
        got = [b for b in rng.choice(r["B"], 8, replace=False)
               if r["logs"][b] is not None]
        for b in got:
            want = ne.parse_event_log(codes[0], codes[b], params)
            if not np.array_equal(r["logs"][b], want):
                raise AssertionError(f"{key} route: pair ({names[0]}, "
                                     f"{names[b]}) differs from the oracle")
        r["oracle"] = len(got)
    return out


def sampled_oracle_check(dev, codes, params, rng):
    """Phase 6b: event logs of sampled pairs against the native oracle."""
    import numpy as np

    from lzani_tpu_torch.core import native_engine as ne
    from lzani_tpu_torch.ops import cuda_engine as ce

    eng = ce.CudaAll2All(codes, params, devices=[dev])
    n = len(codes)
    per_group = N_SAMPLED // (2 * 4)
    checked = fallbacks = 0
    for _ in range(2):
        refs = [int(r) for r in rng.choice(n, 4, replace=False)]
        qs = [int(q) for q in rng.choice(n, per_group, replace=False)]
        idx = np.full(eng.B, qs[-1], np.int64)
        idx[:len(qs)] = qs
        gi = eng.build_group_index(refs, dev)
        evs = eng.collect_group(eng.dispatch_group(
            gi, None, dev, qrows=eng.gather_qrows(idx, dev)))
        for g, r in enumerate(refs):
            for b, q in enumerate(qs):
                if evs[g][b] is None:
                    fallbacks += 1
                    continue
                want = ne.parse_event_log(codes[r], codes[q], params)
                if not np.array_equal(evs[g][b], want):
                    raise AssertionError(f"pair ({r},{q}): kernel log "
                                         f"differs from the oracle")
                checked += 1
    return checked, fallbacks


def cli_in_process(fa, out, backend, extra, nthreads, kernel):
    """The port's CLI (``cli.run``, in this process) with `backend`, and
    `kernel`'s counter set to 0 just before and read just after. Returns
    (matcher, launches, wall)."""
    from lzani_tpu_torch import cli

    argv = ["all2all", "--in-fasta", fa, "--out", out, "--out-alignment",
            out + ".aln", "-t", nthreads, "-V", "1", *extra, "--backend",
            backend]
    kernel.launches = 0
    t0 = time.perf_counter()
    rc, matcher = cli.run(argv)
    wall = time.perf_counter() - t0
    launches = kernel.launches
    if rc != 0:
        raise RuntimeError(f"port CLI --backend {backend} exited {rc} "
                           f"({fa})")
    return matcher, launches, wall


def cli_subprocess(fa, out, backend, extra, nthreads):
    """``python -m lzani_tpu_torch all2all ... -V 2 --backend <backend>``
    as a subprocess, so that its wall includes process start. Returns
    (wall, stderr)."""
    cmd = [sys.executable, "-m", "lzani_tpu_torch", "all2all", "--in-fasta",
           fa, "--out", out, "--out-alignment", out + ".aln", "-t",
           nthreads, "-V", "2", *extra, "--backend", backend]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=900)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"port CLI --backend {backend} exited "
                           f"{res.returncode} ({fa}): {res.stderr[-2000:]}")
    return wall, res.stderr


def same_outputs(tag, out_a, out_b):
    """TSV and ids byte-equal, aln equal as a set, every TSV value
    finite. Returns (TSV rows, aln rows)."""
    import numpy as np

    def read(p):
        with open(p, "rb") as fh:
            return fh.read()

    for suffix in (".tsv", ".ids.tsv"):
        if read(out_a[:-4] + suffix) != read(out_b[:-4] + suffix):
            raise AssertionError(f"{tag}: {suffix} differs from --backend "
                                 f"native")
    la = read(out_a + ".aln").splitlines()
    lb = read(out_b + ".aln").splitlines()
    if la[0] != lb[0] or sorted(la[1:]) != sorted(lb[1:]):
        raise AssertionError(f"{tag}: aln rows differ from --backend native")
    rows = [ln.split(b"\t") for ln in read(out_a).splitlines()[1:]]
    vals = np.array([[float(x) for x in r[4:]] for r in rows])
    if len(rows) == 0 or not np.isfinite(vals).all():
        raise AssertionError(f"{tag}: TSV empty or not finite")
    return len(rows), len(la) - 1


def run_both_clis(td, tag, names, codes, extra, nthreads, kernel):
    """The port's CLI with --backend cuda (in-process, `kernel`'s counter
    set to 0 just before and read just after) and --backend native (a
    subprocess) on one FASTA; their TSV and ids byte-equal, aln equal as a
    set. Returns (matcher, launches, cuda wall, native wall, native
    stderr, TSV rows, aln rows)."""
    from lzani_tpu_torch import synth

    fa = os.path.join(td, f"{tag}.fna")
    synth.write_fasta(fa, names, codes)
    out_t = os.path.join(td, f"{tag}_cuda.tsv")
    out_n = os.path.join(td, f"{tag}_native.tsv")
    matcher, launches, t_cuda = cli_in_process(fa, out_t, "cuda", extra,
                                               nthreads, kernel)
    t_native, nat_err = cli_subprocess(fa, out_n, "native", extra, nthreads)
    n_rows, n_aln = same_outputs(tag, out_t, out_n)
    return matcher, launches, t_cuda, t_native, nat_err, n_rows, n_aln


def check_hybrid(td, tag, extra, nthreads, kernel, n_pairs):
    """Phase 11: --backend hybrid with LZANI_TPU_HYBRID_GREEDY=1 (the
    warm-up starts at once and no claim gate holds the device back),
    in-process, `kernel`'s counter set to 0 just before and read just
    after; outputs equal to the native run of the same FASTA. Returns
    (matcher, launches, wall, TSV rows, aln rows)."""
    fa = os.path.join(td, f"{tag}.fna")
    out = os.path.join(td, f"{tag}_hybrid.tsv")
    os.environ["LZANI_TPU_HYBRID_GREEDY"] = "1"
    try:
        m, launches, wall = cli_in_process(fa, out, "hybrid", extra,
                                           nthreads, kernel)
    finally:
        del os.environ["LZANI_TPU_HYBRID_GREEDY"]
    n_rows, n_aln = same_outputs(f"{tag} hybrid", out,
                                 os.path.join(td, f"{tag}_native.tsv"))
    st = m.engine_stats
    if st["warm_why"] is not None or st["failed_rows"]:
        raise AssertionError(f"hybrid device side: warm_why "
                             f"{st['warm_why']!r}, failed rows "
                             f"{st['failed_rows']}")
    if st["device_pairs"] <= 0 or (st["device_pairs"] + st["cpu_pairs"]
                                   != n_pairs):
        raise AssertionError(f"hybrid device pairs {st['device_pairs']} + "
                             f"cpu pairs {st['cpu_pairs']}: not a partition "
                             f"of {n_pairs} with device pairs > 0")
    if launches <= 0 or st["launches"] != launches:
        raise AssertionError(f"hybrid path launched the kernel {launches} "
                             f"times (engine counted {st['launches']})")
    if st["replay_mismatches"]:
        raise AssertionError(f"hybrid replay mismatches "
                             f"{st['replay_mismatches']}")
    return m, launches, wall, n_rows, n_aln


def check_auto(td, tag, extra, nthreads, rerun_native):
    """Phase 12: ``--backend auto`` as a subprocess CLI (process start in
    its wall), with `rerun_native` just after ``--backend native`` run the
    same way (a paired reading), else held against the earlier phase's
    native run of the same FASTA; auto's outputs equal to native's, its
    engine line says the hybrid ran, no warm-up failed (warm_why None, an
    envelope or a cancel) and no row failed over to the host. Returns
    (auto wall, the paired native wall or None, engine stats, stderr)."""
    from lzani_tpu_torch.utils.runinfo import engine_stats

    fa = os.path.join(td, f"{tag}.fna")
    out_n = os.path.join(td, f"{tag}_native.tsv")
    out = os.path.join(td, f"{tag}_auto.tsv")
    t_native = None
    if rerun_native:
        out_n = os.path.join(td, f"{tag}_native2.tsv")
        t_native, _ = cli_subprocess(fa, out_n, "native", extra, nthreads)
    wall, err = cli_subprocess(fa, out, "auto", extra, nthreads)
    same_outputs(f"{tag} auto", out, out_n)
    st = engine_stats(err)
    if st is None or "warm_started" not in st:
        raise AssertionError(f"{tag}: --backend auto did not run the hybrid "
                             f"(engine line {st})")
    why = st["warm_why"]
    if st["failed_rows"] or (why is not None and not why.startswith(
            ("envelope:", "cancelled"))):
        raise AssertionError(f"{tag} auto: warm_why {why!r}, failed rows "
                             f"{st['failed_rows']}")
    return wall, t_native, st, err


def check_round_robin(dev, codes, params, kernel):
    """Phase 13: ``all2all_cuda`` over two device entries on the one card
    on `codes`, `kernel`'s counter set to 0 just before and read just
    after; triples equal to the native engine's. Returns (stats,
    launches, wall, native wall)."""
    import copy

    import numpy as np

    from lzani_tpu_torch.core import native_engine as ne
    from lzani_tpu_torch.ops.cuda_engine import all2all_cuda

    p = copy.copy(params)
    p.adjust_threads()
    st = {}
    kernel.launches = 0
    t0 = time.perf_counter()
    got = all2all_cuda(codes, p, devices=[dev, dev], stats=st)
    wall = time.perf_counter() - t0
    launches = kernel.launches
    t0 = time.perf_counter()
    want = ne.all2all(codes, p)
    t_native = time.perf_counter() - t0
    if not np.array_equal(got, want):
        bad = np.argwhere((got != want).any(axis=-1))[:5].tolist()
        raise AssertionError(f"round-robin triples differ from native at "
                             f"(r, q-slot) {bad}")
    if len(st["device_units"]) != 2 or min(st["device_units"]) <= 0:
        raise AssertionError(f"device entries ran units {st['device_units']}")
    if launches <= 0 or st["launches"] != launches:
        raise AssertionError(f"round-robin path launched the kernel "
                             f"{launches} times (engine counted "
                             f"{st['launches']})")
    if st["replay_mismatches"] or st["native_rows"]:
        raise AssertionError(f"replay mismatches {st['replay_mismatches']}, "
                             f"native rows {st['native_rows']}")
    return st, launches, wall, t_native


def two_process_cli(td, tag, backend, nthreads):
    """Phase 14: ``python -m lzani_tpu_torch all2all ... -V 2 --backend
    <backend>`` as a two-process launch on this host's card, gloo on
    127.0.0.1; process 0's outputs equal to the native run of the same
    FASTA, process 1 writes no file. Returns [(wall, owned rows, owned
    pairs, engine stats, phase timings)] per process, each wall from the
    process's start to its exit."""
    from lzani_tpu_torch.utils.runinfo import cli_timings, engine_stats

    fa = os.path.join(td, f"{tag}.fna")
    d = os.path.join(td, f"{tag}_2p_{backend}")
    os.makedirs(d)
    outs = [os.path.join(d, f"p{pid}.tsv") for pid in range(2)]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []

    def wait(p, t0):
        _, err = p.communicate(timeout=600)
        return p.returncode, err, time.perf_counter() - t0

    try:
        for pid in range(2):
            env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                       JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(pid))
            cmd = [sys.executable, "-m", "lzani_tpu_torch", "all2all",
                   "--in-fasta", fa, "--out", outs[pid], "--out-alignment",
                   outs[pid] + ".aln", "-t", nthreads, "-V", "2",
                   "--backend", backend]
            procs.append((subprocess.Popen(
                cmd, cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
                stderr=subprocess.PIPE, text=True), time.perf_counter()))
        with ThreadPoolExecutor(2) as pool:
            done = [f.result() for f in [pool.submit(wait, *pt)
                                         for pt in procs]]
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    res = []
    for pid, (rc, err, wall) in enumerate(done):
        if rc != 0:
            raise RuntimeError(f"two-process --backend {backend}: process "
                               f"{pid} exited {rc}: {err[-2000:]}")
        m = re.search(rf"multi-host: process {pid}/2 owns (\d+) reference "
                      rf"rows \((\d+) pairs\)", err)
        if m is None:
            raise AssertionError(f"process {pid} logged no share")
        res.append((wall, int(m.group(1)), int(m.group(2)),
                    engine_stats(err), cli_timings(err)))
    same_outputs(f"{tag} two processes --backend {backend}", outs[0],
                 os.path.join(td, f"{tag}_native.tsv"))
    left = sorted(os.listdir(d))
    if left != ["p0.ids.tsv", "p0.tsv", "p0.tsv.aln"]:
        raise AssertionError(f"two-process --backend {backend} left {left} "
                             f"(process 1 must write nothing)")
    return res


def matching_s(marks):
    """Seconds of the 'LZ matching' phase in Matcher.times."""
    for (t0, _), (t, lab) in zip(marks, marks[1:]):
        if lab == "LZ matching":
            return t - t0
    raise AssertionError("no LZ matching phase")


def native_matching_s(stderr):
    """Seconds of the 'LZ matching' phase in a ``-V 2`` run's stderr."""
    m = re.search(r"^LZ matching : ([0-9.eE+-]+)s$", stderr, re.M)
    if m is None:
        raise AssertionError("no LZ matching phase in the native run")
    return float(m.group(1))


def event_ms(fn, reps):
    """CUDA-event ms of ``fn()``, the mean of `reps` calls."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def jax_row_batch(dev, codes, params, reps=3):
    """Phase 15a: the automaton backend's launch of reference row 0, made
    as ``all2all_jax`` makes it: its 255 queries sorted by length,
    gathered from the resident query matrix (``gather_qrows`` and
    ``rows_args``). The parse kernel's logs against the native oracle on
    every pair with a log (its plain version at this shape does not fit
    in the script's time: PERF.md), its ms (CUDA events, the mean of
    `reps` launches after the one that is checked) and bound. The
    counter is restored: these launches do not count."""
    import numpy as np

    from lzani_tpu_torch.core import native_engine as ne
    from lzani_tpu_torch.ops import engine_jax as ej
    from lzani_tpu_torch.ops.cuda_engine import CudaAll2All
    from lzani_tpu_torch.ops.parse_kernel import parse_events
    from lzani_tpu_torch.utils.runinfo import launch_bound_ms

    eng = CudaAll2All(codes, params, devices=[dev])
    qs = sorted(ej.row_queries(0, len(codes), None),
                key=lambda q: eng.dszs[q])
    idx = ej.RefIndexJax(codes[0], params, dev)
    args, overflow = idx.index.rows_args(*eng.gather_qrows(qs, dev), eng.LqP)
    launches0 = parse_events.launches
    ev, nev = parse_events(*args)
    ms = event_ms(lambda: parse_events(*args), reps)
    parse_events.launches = launches0
    cap = args[9]
    nk, ovf = nev[0].cpu().numpy(), overflow[0].cpu().numpy()
    evh = ev[0, :, :max(min(int(nk.max()), cap), 1)].cpu().numpy()
    checked = 0
    for b, q in enumerate(qs):
        if ovf[b] or not 0 <= nk[b] <= cap:
            continue
        if not np.array_equal(evh[b, :nk[b]],
                              ne.parse_event_log(codes[0], codes[q], params)):
            raise AssertionError(f"jax path launch: pair (0, {q})'s log "
                                 f"differs from the oracle")
        checked += 1
    bound, bound_by = launch_bound_ms(args, nev, args[6][None])
    return dict(args=args, overflow=overflow, ev=ev, nev=nev, B=len(qs),
                LqP=eng.LqP, queries=[codes[q] for q in qs], ms=ms,
                bound_ms=bound, bound_by=bound_by, oracle=checked)


def check_fold(batch, ref, queries, params, factors, reps=3):
    """Phase 15a: the fold kernel against its plain version (on the host
    CPU) on the logs of a parse launch (`batch`: its arguments, overflow
    flags, ev and nev), masked as ``RefIndexJax.dispatch`` masks them: as
    the main path calls it (no factors; CUDA events, the mean of `reps`
    launches after one that serves the comparison) and, with `factors`,
    once with factors. Stats, status (and factor counts and factors) must
    be equal, every pair with a log must have status 0 and its stats must
    equal the native engine's (`ref` x `queries`). The counter is
    restored: these launches do not count."""
    import numpy as np
    import torch

    from lzani_tpu_torch.core import native_engine as ne
    from lzani_tpu_torch.ops.fold_stats import fold_stats, fold_stats_plain
    from lzani_tpu_torch.utils.runinfo import fold_bound_ms

    args, ev, nev = batch["args"], batch["ev"], batch["nev"]
    refbuf, qbuf, _, _, _, _, dsz, nrs, cfg, cap = args
    skip = batch["overflow"] | (nev < 0) | (nev > cap)
    fargs = (refbuf, qbuf, ev, torch.where(skip, -1, nev), dsz, nrs, cfg)
    launches0 = fold_stats.launches
    stats, status = fold_stats(*fargs)
    if factors:
        _, _, fac, nfac = fold_stats(*fargs, want_factors=True)
    ms = event_ms(lambda: fold_stats(*fargs), reps)
    fold_stats.launches = launches0
    cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in fargs]
    t0 = time.perf_counter()
    p_stats, p_status = fold_stats_plain(*cpu)
    plain_ms = (time.perf_counter() - t0) * 1e3

    stats, status = stats.cpu(), status.cpu()
    if not (torch.equal(status, p_status) and torch.equal(stats, p_stats)):
        raise AssertionError("fold kernel: stats or status differ from the "
                             "plain version")
    err, n_fac = 0, None
    if factors:
        _, _, p_fac, p_nfac = fold_stats_plain(*cpu, want_factors=True)
        nfac = nfac.cpu()
        if not torch.equal(nfac, p_nfac):
            raise AssertionError("fold kernel: factor counts differ from "
                                 "the plain version")
        k = int(nfac.max())
        fk, pk = fac[0, :, :k].cpu().numpy(), p_fac[0, :, :k].numpy()
        defined = np.arange(k)[None, :] < nfac[0].numpy()[:, None]
        err = int(np.abs(fk[defined].astype(np.int64) - pk[defined]).max(
            initial=0))
        if err:
            raise AssertionError(f"fold kernel: factors differ from the "
                                 f"plain version (max abs err {err})")
        n_fac = int(nfac.sum())
    skipped = skip[0].cpu().numpy()
    want_status = np.where(skipped, 1, 0)
    if not np.array_equal(status[0].numpy(), want_status):
        raise AssertionError(f"fold kernel status {status[0].tolist()}")
    for b in np.flatnonzero(~skipped):
        want = ne.parse_pair(ref, queries[b], params)[0]
        if tuple(stats[0, b].tolist()) != want:
            raise AssertionError(f"fold kernel: pair {b} of the launch "
                                 f"differs from the native engine")
    bound, bound_by = fold_bound_ms(ev, fargs[3], 1, qbuf.shape[0])
    return dict(pairs=int(nev.numel()), skipped=int(skipped.sum()),
                factors=n_fac, ms=ms, plain_ms=plain_ms, max_abs_err=err,
                bound_ms=bound, bound_by=bound_by, plain_on="cpu")


def counted(fn):
    """Run `fn` with both kernels' counters set to 0 just before and read
    just after: (its result, wall s, parse launches, fold launches)."""
    from lzani_tpu_torch.ops.fold_stats import fold_stats
    from lzani_tpu_torch.ops.parse_kernel import parse_events

    parse_events.launches = fold_stats.launches = 0
    t0 = time.perf_counter()
    out = fn()
    wall = time.perf_counter() - t0
    return out, wall, parse_events.launches, fold_stats.launches


def check_jax_cli(td, tag, nthreads, n_pairs):
    """Phase 15b: the port's CLI --backend jax (in-process, no aln file)
    on the FASTA of `tag`; TSV and ids byte-equal to the native run of
    the same FASTA, both kernels launched as often as the engine counted,
    no replay mismatch. Returns (matcher, wall, parse launches, fold
    launches)."""
    from lzani_tpu_torch import cli

    fa = os.path.join(td, f"{tag}.fna")
    out = os.path.join(td, f"{tag}_jax.tsv")
    argv = ["all2all", "--in-fasta", fa, "--out", out, "-t", nthreads, "-V",
            "1", "--backend", "jax"]
    (rc, m), wall, launches, folds = counted(lambda: cli.run(argv))
    if rc != 0:
        raise RuntimeError(f"port CLI --backend jax exited {rc}")
    native = os.path.join(td, f"{tag}_native")
    for suffix in (".tsv", ".ids.tsv"):
        with open(out[:-4] + suffix, "rb") as a, \
                open(native + suffix, "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"{tag} --backend jax: {suffix} differs "
                                     f"from --backend native")
    st = m.engine_stats
    if (launches <= 0 or folds <= 0 or st["launches"] != launches
            or st["fold_launches"] != folds):
        raise AssertionError(f"jax path launched parse {launches} and fold "
                             f"{folds} times (engine counted "
                             f"{st['launches']} and {st['fold_launches']})")
    check_jax_stats("jax CLI", st, n_pairs)
    return m, wall, launches, folds


def check_jax_stats(tag, st, n_pairs):
    """The automaton backend's engine stats: no replay mismatch, every pair
    folded or run natively, and the native route (capacity fallbacks)
    under 1% of the pairs, as in phase 6."""
    if st["replay_mismatches"] or (st["fold_pairs"] + st["cap_fallbacks"]
                                   != n_pairs):
        raise AssertionError(f"{tag}: engine stats {st}")
    if st["cap_fallbacks"] >= 0.01 * n_pairs:
        raise AssertionError(f"{tag}: {st['cap_fallbacks']} capacity "
                             f"fallbacks >= 1% of {n_pairs} pairs")


def check_mesh(dev, codes, params):
    """Phase 15c: ``all2all_sharded`` over the mesh [dev, dev] (both
    kernels' counters set to 0 just before and read just after), equal to
    ``all2all_jax`` on `dev` and to the native engine, its engine stats
    within ``check_jax_stats``. Returns (mesh wall, parse launches, fold
    launches, all2all_jax wall, native wall, capacity fallbacks)."""
    import copy

    import numpy as np

    from lzani_tpu_torch.core import native_engine as ne
    from lzani_tpu_torch.ops.engine_jax import all2all_jax
    from lzani_tpu_torch.parallel.mesh import all2all_sharded, make_mesh

    p = copy.copy(params)
    p.adjust_threads()
    mesh = make_mesh([str(dev)] * 2)
    st = {}
    got, wall, launches, folds = counted(
        lambda: all2all_sharded(codes, p, mesh=mesh, stats=st))
    t0 = time.perf_counter()
    single = all2all_jax(codes, p, device=dev)
    t_single = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = ne.all2all(codes, p)
    t_native = time.perf_counter() - t0
    for name, a in (("all2all_jax", single), ("native", want)):
        if not np.array_equal(got, a):
            bad = np.argwhere((got != a).any(axis=-1))[:5].tolist()
            raise AssertionError(f"mesh triples differ from {name} at "
                                 f"(r, q-slot) {bad}")
    n = len(codes)
    check_jax_stats("mesh", st, n * (n - 1))
    if (launches != 2 * n or folds != 2 * n or st["launches"] != launches
            or st["fold_launches"] != folds):
        raise AssertionError(f"mesh path: parse {launches} and fold {folds} "
                             f"launches, not 2 per row ({2 * n}), or not "
                             f"the engine's count: {st}")
    return wall, launches, folds, t_single, t_native, st["cap_fallbacks"]


def probe_ms():
    """The CLI's card check (``utils.cudadev.cuda_device_count``: libcuda's
    cuInit and cuDeviceGetCount) in a fresh process: (devices, ms of the
    first call, ms of the second)."""
    code = ("import time\n"
            "from lzani_tpu_torch.utils.cudadev import cuda_device_count\n"
            "t0 = time.perf_counter(); n = cuda_device_count()\n"
            "t1 = time.perf_counter(); cuda_device_count()\n"
            "t2 = time.perf_counter()\n"
            "print(n, (t1 - t0) * 1e3, (t2 - t1) * 1e3)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    if res.returncode != 0:
        raise RuntimeError(f"card check failed: {res.stderr[-2000:]}")
    n, first, second = res.stdout.split()
    return int(n), float(first), float(second)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    from lzani_tpu_torch import synth
    from lzani_tpu_torch.core import native_engine
    from lzani_tpu_torch.ops import fold_stats
    from lzani_tpu_torch.ops.parse_kernel import load as load_kernels
    from lzani_tpu_torch.ops.parse_kernel import (parse_events,
                                                  parse_events_big,
                                                  parse_events_plain)
    from lzani_tpu_torch.params import Params
    from lzani_tpu_torch.utils.runinfo import (card_name_and_power,
                                               cli_timings)

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = card_name_and_power()
    say(1, f"device {kind} (count {count}); nvidia-smi: {smi}")

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    # one compiler per source, started together
    with ThreadPoolExecutor(3) as pool:
        nvcc = pool.submit(timed, load_kernels)
        nvcc_fold = pool.submit(timed, fold_stats.load)
        gxx = pool.submit(timed, native_engine.get_lib)
        t_nvcc, t_fold, t_gxx = (nvcc.result(), nvcc_fold.result(),
                                 gxx.result())
    say(2, f"built parse_events.cu (lzt_parse_events, lzt_parse_events_big) "
           f"with nvcc in {t_nvcc:.2f} s, fold_stats.cu (lzt_fold_stats) "
           f"with nvcc in {t_fold:.2f} s and the port's native engine "
           f"(lzani_core.cpp, g++) in {t_gxx:.2f} s, in parallel")

    # ---- group path --------------------------------------------------
    names, codes = synth.viral_set(seed=SEED, n=N_GENOMES)
    params = Params()
    k = check_kernel(dev, codes, params)
    say(3, f"kernel == plain on one dispatch (G=4, B={k['B']}, "
           f"LrP={k['LrP']}, LqP={k['LqP']}): {k['pairs']} pairs, "
           f"{k['records']} event records equal; kernel {k['ms']:.2f} ms, "
           f"plain {k['plain_ms']:.1f} ms, bound {k['bound_ms']:.4f} ms "
           f"({k['bound_by']}) [{smi}]")

    nthreads = str(os.cpu_count() or 1)
    n_pairs = N_GENOMES * (N_GENOMES - 1)
    bact_names, bact_codes = synth.bacterial_set(SEED)
    bp = synth.bacterial_params()
    bact_flags = ["--mal", str(bp.min_anchor_len), "--msl",
                  str(bp.min_seed_len), "--reg", str(bp.min_region_len)]
    with tempfile.TemporaryDirectory(dir=ROOT, prefix="chip_smoke_") as td:
        (m, launches, t_cuda, t_native, nat_err, n_rows,
         n_aln) = run_both_clis(td, "viral", names, codes, [], nthreads,
                                parse_events)
        st = m.engine_stats
        t_cuda_match, t_native_match = (matching_s(m.times),
                                        native_matching_s(nat_err))
        say(4, f"port CLI --backend cuda: {t_cuda:.2f} s, "
               f"{n_pairs / t_cuda:.1f} pairs/s, launches {launches}, "
               f"engine {json.dumps(st)}; phases: {phase_times(m.times)}")
        say(5, f"port CLI --backend native: {t_native:.2f} s; TSV ({n_rows} "
               f"rows) and ids byte-equal, aln ({n_aln} rows) equal as a "
               f"set; phases: {cli_timings(nat_err)}")
        if launches <= 0 or st["launches"] != launches:
            raise AssertionError(f"main path launched the kernel {launches} "
                                 f"times (engine counted {st['launches']})")
        if st["native_rows"] or st["replay_mismatches"] or st["big_rows"]:
            raise AssertionError(f"native rows {st['native_rows']}, big rows "
                                 f"{st['big_rows']}, replay mismatches "
                                 f"{st['replay_mismatches']}")
        if st["cap_fallbacks"] >= 0.01 * n_pairs:
            raise AssertionError(f"{st['cap_fallbacks']} capacity fallbacks "
                                 f">= 1% of {n_pairs} pairs")
        checked, fb = sampled_oracle_check(dev, codes, params,
                                           np.random.RandomState(SEED))
        say(6, f"launches {launches}, native rows 0, replay mismatches 0, "
               f"cap fallbacks {st['cap_fallbacks']}/{n_pairs}; {checked} "
               f"sampled pairs' event logs equal the oracle ({fb} capacity "
               f"fallbacks)")
        say(7, f"wall: port cuda {t_cuda:.2f} s ({n_pairs / t_cuda:.1f} "
               f"pairs/s), port native {t_native:.2f} s "
               f"({n_pairs / t_native:.1f} pairs/s), -t {nthreads} [{smi}]")

        # ---- long-genome path ----------------------------------------
        # the Matcher parses longest first: the same order here
        order = sorted(range(len(bact_codes)),
                       key=lambda i: -len(bact_codes[i]))
        red, full = check_big_kernel(dev, [bact_codes[i] for i in order],
                                     [bact_names[i] for i in order], bp)
        say(8, f"big kernel == plain on a reduced launch (G={red['G']}, "
               f"B={red['B']}, LrP={red['LrP']}, LqP={red['LqP']}): "
               f"{red['pairs']} pairs, {red['records']} records equal; "
               f"kernel {red['ms']:.3f} ms, plain {red['plain_ms']:.1f} ms, "
               f"bound {red['bound_ms']:.4f} ms ({red['bound_by']}); and on "
               f"the bacterial main path's first launch (G={full['G']}, "
               f"B={full['B']}, LrP={full['LrP']}, LqP={full['LqP']}): "
               f"{full['pairs']} pairs, {full['records']} records equal; "
               f"kernel {full['ms']:.1f} ms, plain {full['plain_ms']:.1f} ms,"
               f" bound {full['bound_ms']:.3f} ms ({full['bound_by']}); "
               f"oracle equal on {', '.join(full['oracle'])} [{smi}]")

        n_bact = len(bact_codes)
        b_pairs = n_bact * (n_bact - 1)
        torch.cuda.reset_peak_memory_stats(dev)
        (m, big_launches, tb_cuda, tb_native, nat_err, n_rows,
         n_aln) = run_both_clis(td, "bacterial", bact_names, bact_codes,
                                bact_flags, nthreads, parse_events_big)
        peak = torch.cuda.max_memory_allocated(dev)
        bs = m.engine_stats
        if big_launches <= 0 or bs["big_launches"] != big_launches:
            raise AssertionError(f"bacterial path launched the big kernel "
                                 f"{big_launches} times (engine counted "
                                 f"{bs['big_launches']})")
        if bs["native_rows"] or bs["replay_mismatches"] or bs["launches"]:
            raise AssertionError(f"native rows {bs['native_rows']}, replay "
                                 f"mismatches {bs['replay_mismatches']}, "
                                 f"group launches {bs['launches']}")
        if (full["G"], full["B"]) != (bs["G_big"], bs["B_big"]):
            raise AssertionError(f"phase 8 held the big kernel at G="
                                 f"{full['G']} x B={full['B']}, the main "
                                 f"path launched G={bs['G_big']} x "
                                 f"B={bs['B_big']}")
        if bs["big_pairs"] + bs["big_cap_fallbacks"] != b_pairs:
            raise AssertionError(f"big pairs {bs['big_pairs']} + fallbacks "
                                 f"{bs['big_cap_fallbacks']} != {b_pairs}")
        sp = [nm.split("_")[0] for nm in m.store.names]
        fb_pairs = [(m.store.names[r], m.store.names[q])
                    for r, q in bs["big_fallback_pairs"]]
        if any(a.split("_")[0] == b.split("_")[0] for a, b in fb_pairs):
            raise AssertionError(f"within-species pairs fell back to the "
                                 f"native engine: {fb_pairs}")
        within = sum(sp[r] == sp[q] for r in range(n_bact)
                     for q in range(n_bact) if r != q)
        say(9, f"bacterial CLI (--mal 20 --msl 11 --reg 80, {n_bact} "
               f"genomes, {b_pairs} pairs): cuda {tb_cuda:.2f} s "
               f"({b_pairs / tb_cuda:.2f} pairs/s) vs native "
               f"{tb_native:.2f} s ({b_pairs / tb_native:.2f} pairs/s), "
               f"-t {nthreads}; TSV ({n_rows} rows) and ids byte-equal, aln "
               f"({n_aln} rows) equal as a set; big launches {big_launches}"
               f" (kernel {full['ms']:.1f} ms per launch of G={bs['G_big']} "
               f"x B_big={bs['B_big']}), big pairs {bs['big_pairs']}, all "
               f"{within} within-species pairs replayed from kernel logs, "
               f"capacity fallbacks {bs['big_cap_fallbacks']} {fb_pairs}, "
               f"native rows 0, replay mismatches 0; peak device memory "
               f"{peak / 2**30:.2f} GiB; phases: {phase_times(m.times)}; "
               f"native phases: {cli_timings(nat_err)} [{smi}]")

        # ---- per-reference routes --------------------------------------
        rr = check_ref_routes(dev, names, codes, params, parse_events,
                              parse_events_plain)
        for key, what in (("batch", "CudaRefIndex.parse_events_batch"),
                          ("range", "CudaAll2All.dispatch_range")):
            r = rr[key]
            say(10, f"{what} (G=1, B={r['B']}, LqP={r['LqP']}): launches "
                    f"{r['launches']}, kernel == plain on {r['pairs']} "
                    f"pairs, {r['records']} records; {r['oracle']} sampled "
                    f"logs equal the oracle; kernel {r['ms']:.3f} ms, plain "
                    f"{r['plain_ms']:.1f} ms (host CPU), bound "
                    f"{r['bound_ms']:.4f} ms ({r['bound_by']}) [{smi}]")

        # ---- hybrid path (the default backend) -----------------------
        hm, h_launches, t_hyb, n_rows, n_aln = check_hybrid(
            td, "viral", [], nthreads, parse_events, n_pairs)
        hs = hm.engine_stats
        say(11, f"port CLI --backend hybrid (LZANI_TPU_HYBRID_GREEDY=1): "
                f"{t_hyb:.2f} s, {n_pairs / t_hyb:.1f} pairs/s against native "
                f"{t_native:.2f} s, -t {nthreads}; TSV ({n_rows} rows) and ids"
                f" byte-equal, aln ({n_aln} rows) equal as a set; launches "
                f"{h_launches} (the warm-up's dummy group included), device "
                f"pairs {hs['device_pairs']} + cpu pairs {hs['cpu_pairs']} = "
                f"{n_pairs}, warm_why None, failed rows 0, replay mismatches "
                f"0; engine {json.dumps(hs)}; phases: {phase_times(hm.times)}"
                f" [{smi}]")
        n_dev, first_ms, second_ms = probe_ms()
        if n_dev < 1:
            raise AssertionError("libcuda reports no device")
        say(12, f"the CLI's card check (libcuda cuInit + cuDeviceGetCount, "
                f"a fresh process): {n_dev} device(s), first call "
                f"{first_ms:.2f} ms, second {second_ms:.4f} ms [{smi}]")
        # the bacterial native run is a few seconds: rerun it beside auto
        for tag, extra, t_nat, rerun in (
                ("viral", [], t_native, False),
                ("bacterial", bact_flags, tb_native, True)):
            t_auto, t_nat2, auto_st, err = check_auto(td, tag, extra,
                                                      nthreads, rerun)
            paired = (f"{t_nat2:.2f} s just before it (and " if rerun
                      else "(")
            say(12, f"{tag} CLI --backend auto (subprocess, process start "
                    f"included): {t_auto:.2f} s against --backend native "
                    f"{paired}{t_nat:.2f} s in an earlier phase), -t "
                    f"{nthreads}; TSV and ids "
                    f"byte-equal, aln equal as a set; hybrid stats "
                    f"{json.dumps(auto_st)}; "
                    f"phases: {cli_timings(err)} [{smi}]")

        # ---- several device entries, several processes -------------
        t_mp0 = time.perf_counter()
        rs, rr_launches, t_rr, t_rr_nat = check_round_robin(
            dev, codes[:96], params, parse_events)
        say(13, f"all2all_cuda(devices=[{dev}, {dev}]) on the first 96 "
                f"viral genomes: {t_rr:.2f} s against native "
                f"{t_rr_nat:.2f} s; triples equal; units per entry "
                f"{rs['device_units']}, launches {rr_launches}, replay "
                f"mismatches 0 [{smi}]")
        mp_launches = {}
        for backend in ("cuda", "auto"):
            res = two_process_cli(td, "viral", backend, "4")
            mp_launches[backend] = [r[3]["launches"] for r in res]
            if backend == "cuda" and min(mp_launches[backend]) <= 0:
                raise AssertionError(f"a process of the cuda launch ran no "
                                     f"kernel: {mp_launches[backend]}")
            say(14, f"two-process CLI --backend {backend} (one card, gloo "
                    f"on 127.0.0.1, -t 4 each): " + "; ".join(
                        f"process {pid} {w:.2f} s, {rows} rows, {pairs} "
                        f"pairs, launches {st['launches']}"
                        + ("" if backend == "cuda" else
                           f", device pairs {st['device_pairs']}, warm_why "
                           f"{st['warm_why']!r}") + f" (phases: {ph})"
                        for pid, (w, rows, pairs, st, ph) in enumerate(res))
                    + f"; process 0's TSV and ids byte-equal to native, aln "
                    f"equal as a set, process 1 wrote nothing; native "
                    f"single-process {t_native:.2f} s in phase 5 [{smi}]")
        say(14, f"phases 13-14 took {time.perf_counter() - t_mp0:.1f} s")

        # ---- automaton backend (--backend jax) ------------------------
        t_p15 = time.perf_counter()
        f64 = check_fold(rr["batch"], codes[0], codes[:64], params,
                         factors=True)
        say(15, f"fold kernel == plain on phase 10's launch (G=1, "
                f"B={f64['pairs']}, LqP={rr['batch']['LqP']}): stats, "
                f"status (0 for every pair with a log, {f64['skipped']} "
                f"skipped), {f64['factors']} factors equal, stats equal to "
                f"the native engine; kernel {f64['ms']:.3f} ms, plain "
                f"{f64['plain_ms']:.1f} ms (host CPU), bound "
                f"{f64['bound_ms']:.5f} ms ({f64['bound_by']}) [{smi}]")
        jb = jax_row_batch(dev, codes, params)
        fk = check_fold(jb, codes[0], jb["queries"], params, factors=False)
        say(15, f"the jax path's launch of row 0 (G=1, B={jb['B']}, LqP="
                f"{jb['LqP']}, queries from the resident matrix): parse "
                f"kernel {jb['ms']:.3f} ms, bound {jb['bound_ms']:.4f} ms "
                f"({jb['bound_by']}), {jb['oracle']} logs equal the oracle; "
                f"fold kernel == plain (stats, status: {fk['skipped']} "
                f"skipped), stats equal to the native engine; fold kernel "
                f"{fk['ms']:.3f} ms, plain {fk['plain_ms']:.1f} ms (host "
                f"CPU), bound {fk['bound_ms']:.5f} ms ({fk['bound_by']}) "
                f"[{smi}]")
        jm, t_jax, j_launches, j_folds = check_jax_cli(td, "viral", nthreads,
                                                       n_pairs)
        js = jm.engine_stats
        if js["batches"] != N_GENOMES or jb["B"] != N_GENOMES - 1:
            raise AssertionError(f"the jax path ran {js['batches']} batches"
                                 f" (one of B={N_GENOMES - 1} per row was "
                                 f"checked above)")
        t_jax_match = matching_s(jm.times)
        say(15, f"port CLI --backend jax (no aln file): {t_jax:.2f} s; LZ "
                f"matching {t_jax_match:.2f} s against cuda {t_cuda_match:.2f}"
                f" s (phase 4) and native {t_native_match:.2f} s (phase 5); "
                f"TSV and ids byte-equal to native; parse launches "
                f"{j_launches}, fold launches {j_folds}, capacity fallbacks "
                f"{js['cap_fallbacks']}/{n_pairs}, replay mismatches 0; "
                f"engine {json.dumps(js)}; phases: {phase_times(jm.times)} "
                f"[{smi}]")
        (t_mesh, m_launches, m_folds, t_single, t_mesh_nat,
         m_fallbacks) = check_mesh(dev, codes[:48], params)
        say(15, f"all2all_sharded over [{dev}, {dev}] on the first 48 viral "
                f"genomes: {t_mesh:.2f} s, parse launches {m_launches}, fold "
                f"launches {m_folds}, capacity fallbacks {m_fallbacks}/"
                f"{48 * 47}; equal to all2all_jax ({t_single:.2f} s) and "
                f"native ({t_mesh_nat:.2f} s) [{smi}]")
        say(15, f"phase 15 took {time.perf_counter() - t_p15:.1f} s")

    if any(mod == "jax" or mod.startswith(("jax.", "lzani_tpu."))
           or mod == "lzani_tpu" for mod in sys.modules):
        raise AssertionError("jax or the JAX package was imported")

    def route(name, replaces, r):
        """The kernel line's entry of a per-reference route: the group
        kernel (lzt_parse_events) on that route's inputs."""
        return {"name": name, "route": "cuda",
                "source": "lzani_tpu_torch/csrc/parse_events.cu",
                "replaces": replaces, "entry": "lzt_parse_events",
                "launches": r["launches"], "max_abs_err": r["max_abs_err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "plain_on": r["plain_on"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None}

    say("end", "all phases passed")
    print(smi, flush=True)
    print(json.dumps({"kernels": [
        {"name": "parse_events", "route": "cuda",
         "source": "lzani_tpu_torch/csrc/parse_events.cu",
         "replaces": "lzani_tpu/ops/pallas_v7.py:56",
         "also_serves": ["lzani_tpu/ops/pallas_engine.py:2214",
                         "lzani_tpu/ops/pallas_v5.py:56"],
         "launches": launches, "hybrid_launches": h_launches,
         "round_robin_launches": rr_launches,
         "two_process_launches": mp_launches,
         "max_abs_err": k["max_abs_err"],
         "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
         "bound_by": k["bound_by"], "library_ms": None},
        dict(route("parse_events_batch",
                   "lzani_tpu/ops/pallas_engine.py:1353", rr["batch"]),
             jax_path={"G": 1, "B": jb["B"], "launches": j_launches,
                       "ms": jb["ms"], "bound_ms": jb["bound_ms"],
                       "bound_by": jb["bound_by"],
                       "oracle_pairs": jb["oracle"], "plain_ms": None}),
        route("dispatch_range", "lzani_tpu/ops/pallas_engine.py:2337",
              rr["range"]),
        {"name": "parse_events_big", "route": "cuda",
         "source": "lzani_tpu_torch/csrc/parse_events.cu",
         "replaces": "lzani_tpu/ops/pallas_engine.py:307",
         "launches": big_launches,
         "max_abs_err": max(red["max_abs_err"], full["max_abs_err"]),
         "ms": full["ms"], "plain_ms": full["plain_ms"],
         "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
         "library_ms": None, "reduced_ms": red["ms"],
         "reduced_plain_ms": red["plain_ms"],
         "reduced_bound_ms": red["bound_ms"]},
        {"name": "fold_stats", "route": "cuda",
         "source": "lzani_tpu_torch/csrc/fold_stats.cu",
         "replaces": "lzani_tpu/ops/parse.py:535",
         "also_replaces": ["lzani_tpu/ops/parse.py:78"],
         "launches": j_folds, "mesh_launches": m_folds, "G": 1,
         "B": jb["B"], "max_abs_err": fk["max_abs_err"], "ms": fk["ms"],
         "plain_ms": fk["plain_ms"], "plain_on": fk["plain_on"],
         "bound_ms": fk["bound_ms"], "bound_by": fk["bound_by"],
         "library_ms": None, "batch64_ms": f64["ms"],
         "batch64_plain_ms": f64["plain_ms"],
         "batch64_bound_ms": f64["bound_ms"],
         "batch64_max_abs_err": f64["max_abs_err"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
