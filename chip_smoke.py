#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lzani_tpu_torch) on one GPU.

    python3 chip_smoke.py

Three paths of the port are driven end to end through its CLI, each
with its kernel's launch counter set to 0 just before and read just after:
the cuda backend's group path, its long-genome path, and the hybrid
backend (the default).
Phases (each prints one line; any failure raises, so the exit code is
non-zero):
  1. the card: torch's device name and nvidia-smi's name and power limit;
  2. build: the CUDA parse kernels (one nvcc build of parse_events.cu,
     both C entries) and the port's native C++ engine (g++), from the
     sources in this checkout, the two compilers started together;
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
Then the card's name and power limit, one JSON line of the kernels (time,
plain time and bound of each, from this run; the group kernel's entry
also has the hybrid path's launches), and the result line last.
Without a CUDA device the script exits 1 and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
N_GENOMES = 256
SEED = 2024
N_SAMPLED = 200      # pairs checked against the oracle in phase 6


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


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
                         logs=logs_b)}
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
    with ThreadPoolExecutor(2) as pool:
        nvcc = pool.submit(timed, load_kernels)
        gxx = pool.submit(timed, native_engine.get_lib)
        t_nvcc, t_gxx = nvcc.result(), gxx.result()
    say(2, f"built parse_events.cu (lzt_parse_events, lzt_parse_events_big) "
           f"with nvcc in {t_nvcc:.2f} s and the port's native engine "
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

    print(smi, flush=True)
    print(json.dumps({"kernels": [
        {"name": "parse_events", "route": "cuda",
         "source": "lzani_tpu_torch/csrc/parse_events.cu",
         "replaces": "lzani_tpu/ops/pallas_v7.py:56",
         "also_serves": ["lzani_tpu/ops/pallas_engine.py:2214",
                         "lzani_tpu/ops/pallas_v5.py:56"],
         "launches": launches, "hybrid_launches": h_launches,
         "max_abs_err": k["max_abs_err"],
         "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
         "bound_by": k["bound_by"], "library_ms": None},
        route("parse_events_batch", "lzani_tpu/ops/pallas_engine.py:1353",
              rr["batch"]),
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
         "reduced_bound_ms": red["bound_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
