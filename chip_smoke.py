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
     both C entries, and its probe build, -DLZT_PROBE), the fold kernel
     (one nvcc build of fold_stats.cu, and its probe build) and the port's
     native C++ engine (g++), from the sources in this checkout, the five
     compilers started together; ptxas's registers, shared memory and
     spills of each kernel;
  Group path (default parameters, viral-sized genomes):
  3. kernel = plain: one whole group dispatch of the main path (G = 4
     references x B = 256 queries at the run's LrP/LqP buckets), the
     kernel's event logs against the plain PyTorch version's, element for
     element, on the same card inputs, with its launch plan (the
     reference in shared memory, warps a block, blocks a reference, the
     blocks an SM holds) and its 10 timed launches beside the 10 before
     them (their mean, the device-memory segments each set allocated, the
     SM clock before and after); then the kernel's device-memory instantiation
     (the one a reference too large for shared memory takes) on the same
     inputs, its logs against the same plain logs, timed; then the probe
     build: the heaviest pair's warp span and counts by kind of step;
     then the dispatch's logs, downloaded as the main path downloads
     them, replayed with regions as one unit by the batched native entry
     (``UnitReplay``, ``lza_replay_unit``) and pair by pair
     (``Finalizer``): triples and region records (as a set) equal, both
     timed; then the fold kernel on the same logs, masked as the main
     path masks them without an aln file (``cuda_engine.fold_args``):
     stats and status against its plain version (on the host CPU), the
     stats of every replayed pair with a log against the batched
     replay's triples, timed, with its bound and launch plan;
  4. the port's CLI (``python -m lzani_tpu_torch all2all ... --backend
     cuda``, driven in-process through ``cli.run``) on a seeded synthetic
     viral set: 256 genomes of 20-60 kb in 24 families plus 15% unrelated
     genomes (65,280 ordered pairs), and the split of its LZ matching:
     set-up, dispatch, download, the replay's native calls and wall, and
     the wait for the replay pool after the last download;
  5. the port's native CLI (``python -m lzani_tpu_torch ... --backend
     native``, a subprocess) on the same file: TSV and ids byte-equal,
     aln as a set;
  6. counters: kernel launches > 0 in the main path, no natively routed
     rows, no replay mismatches, capacity fallbacks under 1% of pairs; and
     200 sampled pairs' event logs against the native oracle;
 6b. the main path as the benchmark's viral cells run it: the port's CLI
     ``--backend cuda`` (in-process) without an aln file on the same
     file, both kernels' counters set to 0 just before and read just
     after: TSV and ids byte-equal to phase 5's, one fold launch a
     dispatch, every kernel pair folded on the card, the replay pool
     given only the capacity fallbacks, no replay mismatch;
  7. wall times and pairs/s of both CLIs (cuda with and without an aln
     file);
  Long-genome path (the tuned bacterial parameters mal 20, msl 11, reg 80;
  mal > 13 sends every row to the big kernel):
  8. big kernel = plain on two whole launches: a reduced one (8 genomes
     of two viral families plus a tandem-repeat pair whose k-mers have
     ~150 candidates: G = 10 x B = 16) and one at the main path's shapes
     (the 6 bacterial genomes below: G = 6 x B = 8 at LqP = 2^23); every
     pair's nev and defined records equal; that launch's plan (warps a
     block, blocks) and its probe build's heaviest pair (warp span and
     counts by kind of step), the probe build's logs equal; 4
     within-species logs of the full launch against the native oracle;
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
     oracle. Then ``parse_events_batch`` on a 300 kb reference (LrP 2^20:
     its planes do not fit in shared memory) x its 1% relative and an
     unrelated genome: one launch, of the device-memory instantiation,
     logs equal to the oracle, timed.
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
     card; no region file, so its group units fold), the kernel's and
     the fold's counters set to 0 just before and read just after:
     triples equal to the native engine's, both entries ran units,
     launches > 0 and equal to the engine's count, one fold a dispatch,
     every kernel pair folded, no replay mismatches; then the same over
     the first 158 viral genomes with a 300 kb genome and its 1% relative
     (the group route at LqP 2^19, B = 256, the fold's stack 4.3 GB a
     launch), without and with a region file: triples equal to native,
     and the peak device memory of each;
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
     the same logs with a ring of 32 stack entries a warp (the stacks'
     bottoms in device memory) equal to the plain version; the same logs
     with each log's middle ext raised by one: every pair with records
     rejected (status -1, no stats), equal to the plain version;
     then the main path's launch of reference row 0 (its 255 queries from
     the resident query matrix, as ``all2all_jax`` makes it): the parse
     kernel's logs against the native oracle (its plain version at this
     shape does not fit in the script's time), the fold kernel against
     its plain version, both timed, the fold's launch plan, and the
     fold's probe build: the heaviest pair's warp span and counts; then
     the port's CLI ``--backend jax``
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
plain time and bound of each, from this run; the fold kernel's entry
also has its launches on the cuda path (phases 6b and 13), its time,
plain time, bound and launch plan at 4 x 256 and phase 13's memory at
LqP 2^19; the group kernel's entry
also has the hybrid, round-robin and two-process paths' launches, the
launches of each instantiation, its ms at the three launch shapes of the
main paths (4 x 256, 1 x 64, 1 x 255), the launches before phase 3's
timed ones (``event_ms``'s series), the device-memory instantiation's
checks and the heaviest pair's span; the long-genome kernel's its
launch plan and heaviest pair), and the result line last.
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


def same_logs(tag, ev_a, nev_a, other, ev_b, nev_b):
    """Every pair's nev and defined records equal, or raise; returns
    (defined records, max abs error = 0)."""
    import numpy as np

    na, nb = nev_a.cpu().numpy(), nev_b.cpu().numpy()
    if not np.array_equal(na, nb):
        bad = np.argwhere(na != nb)[:5].tolist()
        raise AssertionError(f"{tag} nev != {other} nev at (g, b) {bad}")
    mx = max(int(na.max(initial=0)), 1)
    ea, eb = ev_a[:, :, :mx].cpu().numpy(), ev_b[:, :, :mx].cpu().numpy()
    defined = (np.arange(mx)[None, None, :] < np.maximum(na, 0)[..., None])
    err = int(np.abs(ea[defined].astype(np.int64)
                     - eb[defined]).max(initial=0))
    if err:
        raise AssertionError(f"{tag} event logs differ from {other} (max "
                             f"abs err {err})")
    return int(defined.sum()), err


COUNTERS = ("launches", "launches_shared", "launches_device")


def launch_counts(kernel):
    """The wrapper's launch counters (the group kernel's also by
    instantiation)."""
    return {c: getattr(kernel, c) for c in COUNTERS if hasattr(kernel, c)}


def set_launch_counts(kernel, counts=None):
    """Set the wrapper's counters to `counts`, or all to 0."""
    for c in COUNTERS:
        if hasattr(kernel, c):
            setattr(kernel, c, 0 if counts is None else counts[c])


def kernel_vs_plain(kernel, plain, args, dsz_pairs, reps, plain_on=None,
                    series=None):
    """Time `kernel` (``event_ms``: the mean of `reps` launches after one
    that also serves the comparison and `reps` others; `series` as
    there) and `plain`
    (host clock, one call) on the same inputs: the card's, or with
    ``plain_on="cpu"`` copies of them on the host CPU (where a small
    launch's plain version runs faster);
    every pair's nev and defined records must be equal. The counter is
    restored: these launches do not count."""
    import numpy as np
    import torch

    from lzani_tpu_torch.utils.runinfo import launch_bound_ms

    launches0 = launch_counts(kernel)
    ev_k, nev_k = kernel(*args)
    ms = event_ms(lambda: kernel(*args), reps, series)
    set_launch_counts(kernel, launches0)
    p_args = args if plain_on is None else [
        a.to(plain_on) if isinstance(a, torch.Tensor) else a for a in args]
    t0 = time.perf_counter()
    ev_p, nev_p = plain(*p_args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3

    records, err = same_logs(f"{kernel.__name__}: kernel", ev_k, nev_k,
                             "plain", ev_p, nev_p)
    bound, bound_by = launch_bound_ms(args, nev_k, dsz_pairs)
    return dict(pairs=nev_k.numel(), records=records, ms=ms,
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
    gi = eng.routes["group"].build([0, 1, 2, 3], dev)
    args, overflow = eng.routes["group"].args(gi, 0, dev)
    series = {}
    k = kernel_vs_plain(parse_events, parse_events_plain, args,
                        args[6].expand(4, -1), reps=10, series=series)
    return dict(k, LrP=gi.LrP, LqP=eng.LqP, B=eng.B, args=args,
                series=series, eng=eng, overflow=overflow)


def check_replay_unit(codes, params, k, td):
    """Phase 3d: phase 3's G = 4 x B logs (the kernel's, equal to the
    plain version's) downloaded as the main path downloads them, then
    replayed with regions twice: as one unit through the batched native
    entry (``UnitReplay``, one call) and pair by pair (``Finalizer``).
    The triples and the region records (as a set) must be equal. Returns
    (pairs, records, pairs without a log, batched s, per-pair s, (g, b,
    triples) of the replayed pairs for ``check_fold``)."""
    import numpy as np

    from lzani_tpu_torch.core.native_engine import read_region_dump
    from lzani_tpu_torch.ops.finalize import (Finalizer, UnitReplay,
                                              row_wanted, unit_pairs)

    eng = k["eng"]
    logs = eng.routes["group"].collect((k["ev"], k["nev"], k["overflow"]))
    n, B = len(codes), eng.B
    r_list = [0, 1, 2, 3]
    pg, pr, pq, pslot, pb = unit_pairs(
        r_list, [row_wanted(r, n) for r in r_list],
        lambda qs: (qs < B, qs))
    nev = logs.nev[pg, pb]
    res = {}
    for how in ("unit", "pairs"):
        out = np.zeros((n * (n - 1), 3), np.int32)
        path = os.path.join(td, f"replay_{how}.bin")
        with open(path, "wb") as rf:
            t0 = time.perf_counter()
            if how == "unit":
                UnitReplay(codes, params, out, rf)(
                    pr, pq, pslot, nev, logs.offsets(pg, pb), logs.ev)
            else:
                fin = Finalizer(codes, params, out, rf)
                rows = [logs[g] for g in range(len(r_list))]
                for g, r, q, s in zip(pg.tolist(), pr.tolist(), pq.tolist(),
                                      pslot.tolist()):
                    fin(r, q, rows[g][q], s)
            dt = time.perf_counter() - t0
        recs = sorted((r, q, regs.tobytes())
                      for r, q, regs in read_region_dump(path))
        res[how] = (out, recs, dt)
    (out_u, recs_u, t_u), (out_p, recs_p, t_p) = res["unit"], res["pairs"]
    if not np.array_equal(out_u, out_p) or recs_u != recs_p:
        raise AssertionError("batched replay differs from the per-pair "
                             "replay on phase 3's logs")
    if not out_u[pslot].any() or len(recs_u) != len(pr):
        raise AssertionError("phase 3's replay wrote no triple, or not one "
                             "region record a pair")
    return (len(pr), len(recs_u), int((nev < 0).sum()), t_u, t_p,
            (pg, pb, out_u[pslot]))


def check_device_words(args, ref, reps=3):
    """Phase 3b: the group kernel's other instantiation (the reference's
    planes read from device memory, which a reference too large for
    shared memory takes) on phase 3's dispatch: its logs against phase
    3's (`ref`, equal to the plain version's), its ms (CUDA events, the
    mean of `reps` launches after the checked one). The counters are
    restored: these launches do not count."""
    from lzani_tpu_torch.ops.parse_kernel import parse_events as kernel

    counts = launch_counts(kernel)
    ev, nev = kernel(*args, smem_max=0)
    ms = event_ms(lambda: kernel(*args, smem_max=0), reps)
    ran = kernel.launches_device - counts["launches_device"]
    set_launch_counts(kernel, counts)
    if ran != 2 * reps + 1:
        raise AssertionError(f"device-memory instantiation ran {ran} of "
                             f"{2 * reps + 1} launches")
    records, err = same_logs("device-memory instantiation", ev, nev,
                             "phase 3's plain", ref["ev"], ref["nev"])
    return dict(ms=ms, records=records, max_abs_err=err)


def probe_heaviest(args, ref, big=False):
    """Phase 3c (phase 8 with `big`): the probe build of the group (the
    long-genome) kernel (-DLZT_PROBE) on that phase's launch, its logs
    equal to `ref`'s (the kernel's, equal to the plain version's): the
    pair of longest warp span (clock64() cycles) with its counts by kind
    of step, and the SM clock (MHz, now and at most) read just after."""
    from lzani_tpu_torch.ops import parse_kernel as pk
    from lzani_tpu_torch.utils.runinfo import sm_clock_mhz

    G, B = args[3].shape[:2]
    probe_fn = pk.parse_events_big_probe if big else pk.parse_events_probe
    ev, nev, probe = probe_fn(*args)
    same_logs("probe build", ev, nev, "the plain version", ref["ev"],
              ref["nev"])
    pr = probe.reshape(G * B, pk.NPROBE).cpu().numpy()
    j = int(pr[:, 0].argmax())
    out = {f: int(pr[j, n]) for n, f in enumerate(pk.PROBE_FIELDS)}
    out["pair"] = list(divmod(j, B))
    out["sm_clock_mhz"] = sm_clock_mhz()
    return out


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
    bidx = eng.routes["big"].build(r_list, dev)
    return eng, r_list, eng.routes["big"].args(bidx, r_list, 0, dev)


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
    launch and on the main path's first launch over the bacterial set,
    with that launch's plan and its probe build's heaviest pair; 4
    within-species logs of the latter against the oracle."""
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
    full.update(G=eng.G_big, B=eng.B_big, LqP=eng.LqP, LrP=eng.LrP_big,
                heavy=probe_heaviest(args, full, big=True))
    warps, blocks = parse_events_big.last_plan    # the timed launches
    full["plan"] = dict(warps=warps, blocks=blocks)
    logs = eng.routes["big"].collect((full["ev"], full["nev"]))
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
    set_launch_counts(kernel)
    idx = ce.CudaRefIndex(codes[0], params)
    logs_b = idx.parse_events_batch(queries)
    launches_b = launch_counts(kernel)

    eng = ce.CudaAll2All(queries, params, devices=[dev])
    set_launch_counts(kernel)
    logs_r = eng.collect(eng.dispatch_range(0, 0))
    launches_r = launch_counts(kernel)

    args, ovf = idx.batch_args(queries)
    res = kernel_vs_plain(kernel, plain, args, args[6][None], reps=3,
                          plain_on="cpu")
    out = {"batch": dict(res, launches=launches_b["launches"],
                         by_instantiation=launches_b, B=len(queries),
                         LqP=args[1].shape[1], skipped=int(ovf.sum()),
                         logs=logs_b, args=args, overflow=ovf)}
    args, _ = eng.routes["group"].args(eng.build_index(0, dev), 0, dev)
    res = kernel_vs_plain(kernel, plain, args, args[6][None], reps=3,
                          plain_on="cpu")
    out["range"] = dict(res, launches=launches_r["launches"],
                        by_instantiation=launches_r, B=eng.B, LqP=eng.LqP,
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


def check_large_reference(dev, params, kernel, reps=3):
    """Phase 10b: ``CudaRefIndex.parse_events_batch`` on a reference whose
    planes do not fit in shared memory (a 300 kb genome: a composite of
    600,120 symbols, LrP 2^20) x its 1% relative and an unrelated 30 kb
    genome, `kernel`'s counters set to 0 just before and read just after:
    one launch, of the device-memory instantiation; both logs equal to
    the oracle; its ms (CUDA events, the mean of `reps` launches of the
    same batch, not counted)."""
    import numpy as np

    from lzani_tpu_torch import synth
    from lzani_tpu_torch.core import native_engine as ne
    from lzani_tpu_torch.ops import cuda_engine as ce

    rng = np.random.RandomState(23)
    ref = rng.randint(0, 4, 300_000).astype(np.uint8)
    rel = synth.mutate(rng, ref, 0.01, n_ns=3, indels=10)
    queries = [rel, rng.randint(0, 4, 30_000).astype(np.uint8)]
    idx = ce.CudaRefIndex(ref, params, dev)
    set_launch_counts(kernel)
    logs = idx.parse_events_batch(queries)
    counts = launch_counts(kernel)
    if (counts["launches_device"], counts["launches_shared"]) != (1, 0):
        raise AssertionError(f"a 2^20 reference launched {counts}, not one "
                             f"device-memory launch")
    for q, ev in zip(queries, logs):
        if ev is None or not np.array_equal(
                ev, ne.parse_event_log(ref, q, params)):
            raise AssertionError("large reference: a log differs from the "
                                 "oracle")
    args, _ = idx.batch_args(queries)
    ms = event_ms(lambda: kernel(*args), reps)
    set_launch_counts(kernel, counts)
    return dict(ms=ms, LrP=idx.gidx.LrP, LqP=args[1].shape[1],
                records=sum(len(ev) for ev in logs), launches=counts)


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
        route = eng.routes["group"]
        gi = route.build(refs, dev)
        evs = route.collect(route.dispatch(gi, refs, None, dev, idx))
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
    set_launch_counts(kernel)
    t0 = time.perf_counter()
    rc, matcher = cli.run(argv)
    wall = time.perf_counter() - t0
    launches = kernel.launches
    matcher.launch_counts = launch_counts(kernel)
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
    """Phase 13: ``all2all_cuda`` (no region file: its group units fold)
    over two device entries on the one card on `codes`, `kernel`'s and
    the fold's counters set to 0 just before and read just after;
    triples equal to the native engine's, one fold a dispatch and every
    kernel pair folded. Returns (stats, launches, fold launches, wall,
    native wall)."""
    import copy

    import numpy as np

    from lzani_tpu_torch.core import native_engine as ne
    from lzani_tpu_torch.ops.cuda_engine import all2all_cuda
    from lzani_tpu_torch.ops.fold_stats import fold_stats

    p = copy.copy(params)
    p.adjust_threads()
    st = {}
    set_launch_counts(kernel)
    fold_stats.launches = 0
    t0 = time.perf_counter()
    got = all2all_cuda(codes, p, devices=[dev, dev], stats=st)
    wall = time.perf_counter() - t0
    launches, folds = kernel.launches, fold_stats.launches
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
    if folds != st["dispatches"] or st["fold_pairs"] != st["kernel_pairs"]:
        raise AssertionError(f"round-robin path folded {folds} times in "
                             f"{st['dispatches']} dispatches, "
                             f"{st['fold_pairs']} of {st['kernel_pairs']} "
                             f"kernel pairs")
    return st, launches, folds, wall, t_native


def check_fold_memory(dev, codes, params, td):
    """Phase 13b: the group route at the largest query bucket it takes,
    LqP 2^19: ``all2all_cuda`` over two device entries on the one card on
    `codes` (B = 256) with a 300 kb genome and its 1% relative added (a
    composite of 600,120 symbols: still the group route), with no region
    file (its units fold: the fold's stack is G x B x (LqP + 4) x 8
    bytes a launch) and with one (the host replay); the peak device
    memory of each, triples equal to the native engine's, every kernel
    pair folded in the first and none in the second. Returns (LqP, B,
    peak folding, peak replaying, a fold stack's bytes, stats folding)."""
    import copy

    import numpy as np
    import torch

    from lzani_tpu_torch import synth
    from lzani_tpu_torch.core import native_engine as ne
    from lzani_tpu_torch.ops.cuda_engine import CudaAll2All, all2all_cuda
    from lzani_tpu_torch.ops.fold_stats import fold_stats

    rng = np.random.RandomState(29)
    big = rng.randint(0, 4, 300_000).astype(np.uint8)
    codes = list(codes) + [big, synth.mutate(rng, big, 0.01, n_ns=3,
                                              indels=10)]
    p = copy.copy(params)
    p.adjust_threads()
    want = ne.all2all(codes, p)
    eng = CudaAll2All(codes, p, devices=[dev])
    LqP, B, G = eng.LqP, eng.B, CudaAll2All.GROUP
    if LqP != 1 << 19 or B != 256 or set(eng.paths) != {"group"}:
        raise AssertionError(f"fold memory set: LqP {LqP}, B {B}, paths "
                             f"{set(eng.paths)}")
    del eng
    peaks, stats = [], []
    for region in (None, os.path.join(td, "fold_memory.bin")):
        st = {}
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        folds0 = fold_stats.launches
        got = all2all_cuda(codes, p, devices=[dev, dev], stats=st,
                           region_path=region)
        peaks.append(torch.cuda.max_memory_allocated(dev))
        folds = fold_stats.launches - folds0
        if not np.array_equal(got, want):
            raise AssertionError(f"LqP 2^19 run (region file {region}): "
                                 f"triples differ from native")
        folded = st["dispatches"] if region is None else 0
        if (folds != folded or st["replay_mismatches"]
                or st["fold_pairs"] != (st["kernel_pairs"] if region is None
                                        else 0)):
            raise AssertionError(f"LqP 2^19 run (region file {region}): "
                                 f"{folds} folds, engine {st}")
        stats.append(st)
    return LqP, B, peaks[0], peaks[1], G * B * (LqP + 4) * 8, stats[0]


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


def event_ms(fn, reps, series=None):
    """CUDA-event ms of ``fn()``: the mean of `reps` calls that follow
    `reps` others, timed apart. With a dict `series`, it also gets the
    first calls' mean (``first_ms``), the device-memory segments each set
    of calls made the caching allocator take (``first_segments``,
    ``segments``) and the SM clock (MHz, nvidia-smi) just before the
    first call and just after the last (``clock_before_mhz``,
    ``clock_after_mhz``)."""
    import torch

    from lzani_tpu_torch.utils.runinfo import sm_clock_mhz

    def segments():
        return torch.cuda.memory_stats().get("segment.all.allocated", 0)

    if series is not None:
        series["clock_before_mhz"] = sm_clock_mhz()[0]
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    seg = [segments()]
    marks[0].record()
    for _ in range(reps):
        fn()
    marks[1].record()
    seg.append(segments())
    for _ in range(reps):
        fn()
    marks[2].record()
    torch.cuda.synchronize()
    seg.append(segments())
    if series is not None:
        series.update(first_ms=marks[0].elapsed_time(marks[1]) / reps,
                      clock_after_mhz=sm_clock_mhz()[0],
                      first_segments=seg[1] - seg[0],
                      segments=seg[2] - seg[1])
    return marks[1].elapsed_time(marks[2]) / reps


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
    launches0 = launch_counts(parse_events)
    ev, nev = parse_events(*args)
    ms = event_ms(lambda: parse_events(*args), reps)
    set_launch_counts(parse_events, launches0)
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


def native_triples(ref, queries, params):
    """(g, b, triples) of a G = 1 launch of `ref` x `queries`: the native
    engine's triple of each pair, for ``check_fold``."""
    import numpy as np

    from lzani_tpu_torch.core import native_engine as ne

    tri = np.array([ne.parse_pair(ref, q, params)[0] for q in queries],
                   np.int32).reshape(-1, 3)
    return np.zeros(len(queries), np.int64), np.arange(len(queries)), tri


def check_fold(batch, want, factors, reps=3):
    """Phase 3e (phase 15a): the fold kernel against its plain version (on
    the host CPU) on the logs of a parse launch (`batch`: its arguments,
    overflow flags, ev and nev), masked as the main path masks them
    (``cuda_engine.fold_args``): as the main path calls it (no factors;
    CUDA events, the mean of `reps` launches after one that serves the
    comparison) and, with `factors`, once with factors. Stats, status (and
    factor counts and factors) must be equal, every pair with a log must
    have status 0, and the stats of the pairs `want` names ((g, b,
    triples) arrays) must equal its triples: the native engine's, or the
    host replay's of the same logs. The counter is restored: these
    launches do not count."""
    import numpy as np
    import torch

    from lzani_tpu_torch.ops.cuda_engine import fold_args
    from lzani_tpu_torch.ops.fold_stats import fold_stats, fold_stats_plain
    from lzani_tpu_torch.utils.runinfo import fold_bound_ms

    skip, fargs = fold_args(batch["args"], batch["ev"], batch["nev"],
                            batch["overflow"])
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
        fk, pk = fac[:, :, :k].cpu().numpy(), p_fac[:, :, :k].numpy()
        defined = np.arange(k) < nfac.numpy()[..., None]
        err = int(np.abs(fk[defined].astype(np.int64) - pk[defined]).max(
            initial=0))
        if err:
            raise AssertionError(f"fold kernel: factors differ from the "
                                 f"plain version (max abs err {err})")
        n_fac = int(nfac.sum())
    skipped = skip.cpu().numpy()
    if not np.array_equal(status.numpy(), np.where(skipped, 1, 0)):
        raise AssertionError(f"fold kernel status {status.tolist()}")
    g, b, tri = want
    kept = ~skipped[g, b]
    bad = np.flatnonzero((stats.numpy()[g, b] != tri).any(-1) & kept)
    if len(bad):
        raise AssertionError(f"fold kernel: pairs (g, b) "
                             f"{list(zip(g[bad][:5], b[bad][:5]))} of the "
                             f"launch differ from the reference triples")
    G, B = skipped.shape
    bound, bound_by = fold_bound_ms(batch["ev"], fargs[3], G, B)
    return dict(pairs=int(skipped.size), skipped=int(skipped.sum()),
                checked=int(kept.sum()), G=G, B=B, factors=n_fac, ms=ms,
                plain_ms=plain_ms, max_abs_err=err, bound_ms=bound,
                bound_by=bound_by, plain_on="cpu", fargs=fargs,
                plain=(p_stats, p_status, p_fac, p_nfac)
                if factors else None)


def check_fold_spill(f64, ring=32):
    """Phase 15a: the fold kernel on the logs of `f64` (``check_fold``'s
    launch with factors) with a ring of `ring` stack entries a warp, so
    that most pairs' stacks pass it: their bottom entries and the stats
    pass read device memory. Stats, status, factor counts and factors
    equal to the plain version's; returns the pairs whose factor count
    passed the ring. These launches do not count."""
    import torch

    from lzani_tpu_torch.ops.fold_stats import fold_stats

    launches0 = fold_stats.launches
    stats, status, fac, nfac = (t.cpu() for t in fold_stats(
        *f64["fargs"], want_factors=True, ring=ring))
    fold_stats.launches = launches0
    p_stats, p_status, p_fac, p_nfac = f64["plain"]
    if not (torch.equal(stats, p_stats) and torch.equal(status, p_status)
            and torch.equal(nfac, p_nfac)):
        raise AssertionError(f"fold kernel with a ring of {ring}: stats, "
                             f"status or factor counts differ from the "
                             f"plain version")
    for b in range(nfac.shape[1]):
        k = int(p_nfac[0, b])
        if not torch.equal(fac[0, b, :k], p_fac[0, b, :k]):
            raise AssertionError(f"fold kernel with a ring of {ring}: pair "
                                 f"{b}'s factors differ from the plain "
                                 f"version")
    return int((p_nfac > ring).sum())


def check_fold_rejects(f64):
    """Phase 15a: the logs of `f64` with the ext of each log's middle
    record raised by one, on the card: every pair with a record has
    status -1 and no stats, every other as before; equal to the plain
    version. Returns the pairs rejected. These launches do not count."""
    import torch

    from lzani_tpu_torch.ops.fold_stats import fold_stats, fold_stats_plain

    refbuf, qbuf, ev, nev, dsz, nrs, cfg = f64["fargs"]
    ev = ev.clone()
    n = nev[0].cpu()
    for b in torch.nonzero(n > 0).flatten().tolist():
        ev[0, b, int(n[b]) // 2, 4] += 1
    args = (refbuf, qbuf, ev, nev, dsz, nrs, cfg)
    launches0 = fold_stats.launches
    stats, status = (t.cpu() for t in fold_stats(*args))
    fold_stats.launches = launches0
    p_stats, p_status = fold_stats_plain(
        *[a.cpu() if isinstance(a, torch.Tensor) else a for a in args])
    if not (torch.equal(stats, p_stats) and torch.equal(status, p_status)):
        raise AssertionError("fold kernel on corrupted logs: stats or status "
                             "differ from the plain version")
    want = torch.where(n > 0, -1, f64["plain"][1][0])
    if not torch.equal(status[0], want) or stats[0, n > 0].any():
        raise AssertionError(f"fold kernel accepted a corrupted log: status "
                             f"{status[0].tolist()}")
    return int((n > 0).sum())


def fold_probe_heaviest(fk):
    """Phase 15a: the fold's probe build (-DLZT_PROBE) on the row launch
    of `fk`, its stats and status equal to the kernel's: the pair of
    longest warp span (clock64() cycles) with its counts, and the SM clock
    (MHz, now and at most) read just after."""
    import torch

    from lzani_tpu_torch.ops import fold_stats as fs
    from lzani_tpu_torch.utils.runinfo import sm_clock_mhz

    stats, status, probe = fs.fold_stats_probe(*fk["fargs"])
    launches0 = fs.fold_stats.launches
    want = fs.fold_stats(*fk["fargs"])
    fs.fold_stats.launches = launches0
    if not (torch.equal(stats, want[0]) and torch.equal(status, want[1])):
        raise AssertionError("fold probe build: stats or status differ")
    pr = probe.reshape(-1, fs.NPROBE).cpu().numpy()
    j = int(pr[:, 0].argmax())
    out = {f: int(pr[j, k]) for k, f in enumerate(fs.PROBE_FIELDS)}
    out["pair"] = [0, j]
    out["median_span"] = int(sorted(pr[:, 0])[len(pr) // 2])
    out["sm_clock_mhz"] = sm_clock_mhz()
    return out


def fold_plan(dev, G, B, LrP, LqP):
    """The fold kernel's launch plan for G x B pairs at buckets LrP / LqP
    on `dev`: shared bytes, the reference's and the queries' planes in
    shared memory or not, warps a block, blocks a reference, its ring and
    the blocks an SM holds."""
    from lzani_tpu_torch.ops import fold_stats
    from lzani_tpu_torch.ops.parse_kernel import sm_count

    plan = fold_stats.launch_plan(G, B, LrP, LqP, sm_count(dev),
                                  fold_stats.smem_limit(dev))
    return dict(smem=plan[0], ref_smem=plan[1], q_smem=plan[2],
                warps=plan[3], blocks_per_ref=plan[4], ring=fold_stats.RING,
                blocks_per_sm_max=fold_stats.occupancy(plan[0], plan[3]))


def counted(fn):
    """Run `fn` with both kernels' counters set to 0 just before and read
    just after: (its result, wall s, parse launches, fold launches)."""
    from lzani_tpu_torch.ops.fold_stats import fold_stats
    from lzani_tpu_torch.ops.parse_kernel import parse_events

    set_launch_counts(parse_events)
    fold_stats.launches = 0
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


def check_fold_cli(td, tag, nthreads, n_pairs):
    """Phase 6b: the main path as the benchmark's viral cells run it: the
    port's CLI --backend cuda (in-process) without an aln file on the
    FASTA of `tag`, both kernels' counters set to 0 just before and read
    just after; TSV and ids byte-equal to the native run of the same
    FASTA, one fold launch a dispatch (as many as parse launches), every
    kernel pair folded, the pool given only the capacity fallbacks, no
    replay mismatch. Returns (matcher, wall, parse launches, fold
    launches)."""
    from lzani_tpu_torch import cli

    fa = os.path.join(td, f"{tag}.fna")
    out = os.path.join(td, f"{tag}_fold.tsv")
    argv = ["all2all", "--in-fasta", fa, "--out", out, "-t", nthreads, "-V",
            "1", "--backend", "cuda"]
    (rc, m), wall, launches, folds = counted(lambda: cli.run(argv))
    if rc != 0:
        raise RuntimeError(f"port CLI --backend cuda (no aln) exited {rc}")
    native = os.path.join(td, f"{tag}_native")
    for suffix in (".tsv", ".ids.tsv"):
        with open(out[:-4] + suffix, "rb") as a, \
                open(native + suffix, "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"{tag} --backend cuda, no aln: "
                                     f"{suffix} differs from native")
    st = m.engine_stats
    if (launches <= 0 or folds != launches or st["launches"] != launches
            or st["dispatches"] != folds):
        raise AssertionError(f"cuda path without aln launched parse "
                             f"{launches} and fold {folds} times (engine "
                             f"counted {st['launches']} launches, "
                             f"{st['dispatches']} dispatches)")
    if (st["fold_pairs"] != st["kernel_pairs"] or st["replay_mismatches"]
            or st["replay_pairs"] != st["cap_fallbacks"]
            or st["kernel_pairs"] + st["cap_fallbacks"] != n_pairs
            or st["cap_fallbacks"] >= 0.01 * n_pairs):
        raise AssertionError(f"cuda path without aln: engine stats {st}")
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
    from lzani_tpu_torch.ops.build import build_report
    from lzani_tpu_torch.ops.parse_kernel import load as load_kernels
    from lzani_tpu_torch.ops.parse_kernel import (occupancy, parse_events,
                                                  parse_events_big,
                                                  parse_events_plain)
    from lzani_tpu_torch.params import Params
    from lzani_tpu_torch.utils.runinfo import (card_name_and_power,
                                               cli_timings, ptxas_lines)

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = card_name_and_power()
    say(1, f"device {kind} (count {count}); nvidia-smi: {smi}")

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    # one compiler per source and build, started together
    with ThreadPoolExecutor(5) as pool:
        nvcc = pool.submit(timed, load_kernels)
        nvcc_probe = pool.submit(timed, lambda: load_kernels(probe=True))
        nvcc_fold = pool.submit(timed, fold_stats.load)
        nvcc_fold_probe = pool.submit(timed,
                                      lambda: fold_stats.load(probe=True))
        gxx = pool.submit(timed, native_engine.get_lib)
        t_nvcc, t_probe, t_fold, t_fold_probe, t_gxx = (
            nvcc.result(), nvcc_probe.result(), nvcc_fold.result(),
            nvcc_fold_probe.result(), gxx.result())
    ptxas = (ptxas_lines(build_report("parse_events"))
             + ptxas_lines(build_report("fold_stats")))
    say(2, f"built parse_events.cu (lzt_parse_events, lzt_parse_events_big) "
           f"with nvcc in {t_nvcc:.2f} s, its probe build (-DLZT_PROBE) in "
           f"{t_probe:.2f} s, fold_stats.cu (lzt_fold_stats) with nvcc in "
           f"{t_fold:.2f} s, its probe build in {t_fold_probe:.2f} s and the "
           f"port's native engine (lzani_core.cpp, g++) in {t_gxx:.2f} s, "
           f"in parallel; ptxas: " + "; ".join(ptxas))

    # ---- group path --------------------------------------------------
    names, codes = synth.viral_set(seed=SEED, n=N_GENOMES)
    params = Params()
    k = check_kernel(dev, codes, params)
    plan = parse_events.last_plan                 # the timed launches
    k["plan"] = dict(smem=plan[0], warps=plan[1], blocks_per_ref=plan[2],
                     blocks_per_sm_max=occupancy(plan[0], plan[1]))
    say(3, f"kernel == plain on one dispatch (G=4, B={k['B']}, "
           f"LrP={k['LrP']}, LqP={k['LqP']}): {k['pairs']} pairs, "
           f"{k['records']} event records equal; kernel {k['ms']:.2f} ms, "
           f"plain {k['plain_ms']:.1f} ms, bound {k['bound_ms']:.4f} ms "
           f"({k['bound_by']}); launch plan {json.dumps(k['plan'])}; the "
           f"10 launches before the timed ones {json.dumps(k['series'])} "
           f"[{smi}]")
    dw = check_device_words(k["args"], k)
    say(3, f"device-memory instantiation on the same dispatch: "
           f"{dw['records']} records equal to the plain version's; kernel "
           f"{dw['ms']:.2f} ms [{smi}]")
    heavy = probe_heaviest(k["args"], k)
    say(3, f"probe build on the same dispatch, logs equal: the heaviest "
           f"pair {json.dumps(heavy)} [{smi}]")
    with tempfile.TemporaryDirectory(dir=ROOT, prefix="chip_smoke_") as td:
        ru = check_replay_unit(codes, params, k, td)
    say(3, f"the same dispatch's logs replayed with regions: one batched "
           f"native call (lza_replay_unit) == per pair (Finalizer) on "
           f"{ru[0]} pairs ({ru[2]} without a log, parsed natively): "
           f"triples equal, {ru[1]} region records equal as a set; "
           f"{ru[3]:.3f} s batched (one thread) against {ru[4]:.3f} s per "
           f"pair [{smi}]")
    f3 = check_fold(k, ru[5], factors=False)
    f3["plan"] = fold_plan(dev, f3["G"], f3["B"], k["LrP"], k["LqP"])
    say(3, f"fold kernel on the same dispatch's logs, as the main path "
           f"folds them without an aln file (G={f3['G']}, B={f3['B']}, "
           f"LrP={k['LrP']}, LqP={k['LqP']}): == plain (stats, status: "
           f"{f3['skipped']} skipped), the stats of {f3['checked']} pairs "
           f"equal to the batched replay's triples; kernel {f3['ms']:.3f} "
           f"ms, plain {f3['plain_ms']:.1f} ms (host CPU), bound "
           f"{f3['bound_ms']:.5f} ms ({f3['bound_by']}); launch plan "
           f"{json.dumps(f3['plan'])} [{smi}]")

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
        main_counts = m.launch_counts
        t_cuda_match, t_native_match = (matching_s(m.times),
                                        native_matching_s(nat_err))
        say(4, f"port CLI --backend cuda: {t_cuda:.2f} s, "
               f"{n_pairs / t_cuda:.1f} pairs/s, launches {launches} "
               f"{json.dumps(m.launch_counts)}, "
               f"engine {json.dumps(st)}; phases: {phase_times(m.times)}")
        say(4, f"LZ matching {t_cuda_match:.2f} s (native "
               f"{t_native_match:.2f} s): set-up {st['setup_s']:.2f} s, "
               f"dispatch {st['dispatch_s']:.2f} s, download "
               f"{st['download_s']:.2f} s (its sync "
               f"{st['download_sync_s']:.2f} s), replay in C "
               f"{st['replay_c_s']:.2f} s summed over the pool's threads, "
               f"replay wall {st['replay_wall_s']:.2f} s for "
               f"{st['replay_pairs']} pairs, the wait for the pool after "
               f"the last download {st['replay_tail_s']:.2f} s [{smi}]")
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
        fm, t_fold, f_launches, f_folds = check_fold_cli(td, "viral",
                                                         nthreads, n_pairs)
        fs_ = fm.engine_stats
        say("6b", f"port CLI --backend cuda without an aln file (the "
                  f"benchmark's viral cells): {t_fold:.2f} s, TSV and ids "
                  f"byte-equal to native; parse launches {f_launches}, fold "
                  f"launches {f_folds} = dispatches, fold pairs "
                  f"{fs_['fold_pairs']} = kernel pairs, pool pairs "
                  f"{fs_['replay_pairs']} = capacity fallbacks, replay "
                  f"mismatches 0; dispatch {fs_['dispatch_s']:.2f} s, "
                  f"download {fs_['download_s']:.2f} s (its sync "
                  f"{fs_['download_sync_s']:.2f} s), replay tail "
                  f"{fs_['replay_tail_s']:.3f} s; phases: "
                  f"{phase_times(fm.times)} [{smi}]")
        say(7, f"wall: port cuda {t_cuda:.2f} s ({n_pairs / t_cuda:.1f} "
               f"pairs/s) with an aln file, {t_fold:.2f} s "
               f"({n_pairs / t_fold:.1f} pairs/s) without, port native "
               f"{t_native:.2f} s ({n_pairs / t_native:.1f} pairs/s), -t "
               f"{nthreads} [{smi}]")

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
               f"launch plan {json.dumps(full['plan'])}; probe build, logs "
               f"equal, the heaviest pair {json.dumps(full['heavy'])}; "
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

        lr = check_large_reference(dev, params, parse_events)
        say(10, f"CudaRefIndex.parse_events_batch on a 300 kb reference "
                f"(LrP={lr['LrP']}, LqP={lr['LqP']}) x 2 queries: launches "
                f"{json.dumps(lr['launches'])}, {lr['records']} records "
                f"equal to the oracle; kernel {lr['ms']:.3f} ms [{smi}]")

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
        rs, rr_launches, rr_folds, t_rr, t_rr_nat = check_round_robin(
            dev, codes[:96], params, parse_events)
        say(13, f"all2all_cuda(devices=[{dev}, {dev}]) on the first 96 "
                f"viral genomes: {t_rr:.2f} s against native "
                f"{t_rr_nat:.2f} s; triples equal; units per entry "
                f"{rs['device_units']}, launches {rr_launches}, fold "
                f"launches {rr_folds} = dispatches, fold pairs "
                f"{rs['fold_pairs']} = kernel pairs, replay mismatches 0 "
                f"[{smi}]")
        (m_LqP, m_B, peak_fold, peak_replay, stack,
         ms_) = check_fold_memory(dev, codes[:158], params, td)
        fold_mem = dict(LqP=m_LqP, G=4, B=m_B, entries=2,
                        peak_fold_bytes=peak_fold,
                        peak_replay_bytes=peak_replay, stack_bytes=stack)
        say(13, f"all2all_cuda(devices=[{dev}, {dev}]) at LqP {m_LqP} (the "
                f"first 158 viral genomes, a 300 kb genome and its 1% "
                f"relative; G=4 x B={m_B}): triples equal to native with and "
                f"without a region file; folding {ms_['dispatches']} "
                f"dispatches, peak device memory {peak_fold} bytes, "
                f"replaying on the host {peak_replay} bytes; a fold stack "
                f"{stack} bytes (G x B x (LqP + 4) x 8) [{smi}]")
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
        f64 = check_fold(rr["batch"],
                         native_triples(codes[0], codes[:64], params),
                         factors=True)
        say(15, f"fold kernel == plain on phase 10's launch (G=1, "
                f"B={f64['pairs']}, LqP={rr['batch']['LqP']}): stats, "
                f"status (0 for every pair with a log, {f64['skipped']} "
                f"skipped), {f64['factors']} factors equal, stats equal to "
                f"the native engine; kernel {f64['ms']:.3f} ms, plain "
                f"{f64['plain_ms']:.1f} ms (host CPU), bound "
                f"{f64['bound_ms']:.5f} ms ({f64['bound_by']}) [{smi}]")
        n_spill = check_fold_spill(f64)
        n_rej = check_fold_rejects(f64)
        say(15, f"fold kernel on the same logs with a ring of 32 stack "
                f"entries ({n_spill} pairs' stacks pass it): equal to the "
                f"plain version; with each log's middle ext raised by one: "
                f"all {n_rej} pairs with records rejected (status -1, no "
                f"stats), equal to the plain version [{smi}]")
        jb = jax_row_batch(dev, codes, params)
        fk = check_fold(jb, native_triples(codes[0], jb["queries"], params),
                        factors=False)
        fplan = fold_plan(dev, 1, jb["B"], jb["args"][0].shape[1],
                          jb["LqP"])
        fheavy = fold_probe_heaviest(fk)
        say(15, f"the jax path's launch of row 0 (G=1, B={jb['B']}, LqP="
                f"{jb['LqP']}, queries from the resident matrix): parse "
                f"kernel {jb['ms']:.3f} ms, bound {jb['bound_ms']:.4f} ms "
                f"({jb['bound_by']}), {jb['oracle']} logs equal the oracle; "
                f"fold kernel == plain (stats, status: {fk['skipped']} "
                f"skipped), stats equal to the native engine; fold kernel "
                f"{fk['ms']:.3f} ms, plain {fk['plain_ms']:.1f} ms (host "
                f"CPU), bound {fk['bound_ms']:.5f} ms ({fk['bound_by']}); "
                f"fold launch plan {json.dumps(fplan)}; fold probe build, "
                f"the heaviest pair {json.dumps(fheavy)} [{smi}]")
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
                "launches": r["launches"],
                "launches_by_instantiation": r["by_instantiation"],
                "max_abs_err": r["max_abs_err"],
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
         "launches": launches,
         "launches_by_instantiation": main_counts,
         "hybrid_launches": h_launches,
         "round_robin_launches": rr_launches,
         "two_process_launches": mp_launches,
         "max_abs_err": k["max_abs_err"],
         "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
         "bound_by": k["bound_by"], "library_ms": None,
         "ms_by_shape": {"4x256": k["ms"], "1x64": rr["batch"]["ms"],
                         "1x255": jb["ms"]},
         "timing_4x256": k["series"],
         "launch_plan_4x256": k["plan"],
         "device_instantiation": {"G": 4, "B": k["B"], "ms": dw["ms"],
                                  "max_abs_err": dw["max_abs_err"],
                                  "large_reference": lr},
         "heaviest_pair": heavy},
        dict(route("parse_events_batch",
                   "lzani_tpu/ops/pallas_engine.py:1353", rr["batch"]),
             jax_path={"G": 1, "B": jb["B"], "launches": j_launches,
                       "ms": jb["ms"],
                       "bound_ms": jb["bound_ms"],
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
         "reduced_bound_ms": red["bound_ms"],
         "launch_plan": full["plan"], "heaviest_pair": full["heavy"]},
        {"name": "fold_stats", "route": "cuda",
         "source": "lzani_tpu_torch/csrc/fold_stats.cu",
         "replaces": "lzani_tpu/ops/parse.py:536",
         "also_replaces": ["lzani_tpu/ops/parse.py:78"],
         "launches": j_folds, "mesh_launches": m_folds,
         "cuda_launches": f_folds, "round_robin_launches": rr_folds,
         "ms_by_shape": {"4x256": f3["ms"], "1x255": fk["ms"],
                         "1x64": f64["ms"]},
         "plain_ms_4x256": f3["plain_ms"], "bound_ms_4x256": f3["bound_ms"],
         "bound_by_4x256": f3["bound_by"], "launch_plan_4x256": f3["plan"],
         "memory_lqp_2e19": fold_mem, "G": 1,
         "B": jb["B"], "max_abs_err": fk["max_abs_err"], "ms": fk["ms"],
         "plain_ms": fk["plain_ms"], "plain_on": fk["plain_on"],
         "bound_ms": fk["bound_ms"], "bound_by": fk["bound_by"],
         "library_ms": None, "batch64_ms": f64["ms"],
         "batch64_plain_ms": f64["plain_ms"],
         "batch64_bound_ms": f64["bound_ms"],
         "batch64_max_abs_err": f64["max_abs_err"],
         "launch_plan_1x255": fplan, "heaviest_pair": fheavy,
         "ring32_spill_pairs": n_spill, "corrupted_pairs_rejected": n_rej}]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
