"""Dispatch probe of the CUDA engine on one card: what sets the time of a
launch, on the smoke sets of ``chip_smoke.py``.

    python -m lzani_tpu_torch.dispatch_probe [--n 256] [--seed 2024] \\
        [--baseline OTHER_CHECKOUT] [--skip-profile] [--timing] \\
        [--probe [--save F]] [--fold [--save F]] [--big [--probe]]

Prints, each line beside the card's name and power limit:
  - with ``--big``, only the long-genome kernel on the bacterial launch
    below (``_big``): with ``--probe`` first its probe build's ten pairs
    of longest warp span with their counts and the shares of the span
    spent in the anchor search, the seed window, the extensions, the
    literal-run lookahead and the desync jumps, its logs equal to the
    plain build's; its ms (CUDA events, the mean of 2 launches after
    one), bound, launch plan and device time by kernel (torch.profiler:
    the plane packs and the parse); with ``--baseline`` the other
    checkout's kernel in turns, logs equal; ptxas's report;
  - with ``--fold``, only the fold kernel (``ops/fold_stats.py``), on the
    logs of the automaton backend's row launch (G = 1 x 255 queries
    sorted by length, masked as ``RefIndexJax.dispatch`` masks them) and
    of ``chip_smoke.py`` phase 10's batch (1 x 64): its probe build's ten
    pairs of longest warp span (``clock64()``) with their counts (events,
    extension scans and their symbols, symbols emitted, gaps with their
    lengths, scans and splits, pushes and top merges, region kills and
    their pops, the stack's depth, entries read below the shared-memory
    ring) and the cycles spent in records, gaps, back and forward scans,
    emission, kills and the stats pass, its stats equal to the plain
    build's (`--save` writes every pair's counts); ptxas's report; the
    kernel's ms at both shapes (CUDA events, the mean of 3 launches after
    3 others) with its bound, launch plan and occupancy; and with
    ``--baseline``, the other checkout's fold kernel in turns (baseline,
    this, this, baseline) on the same inputs, whose stats and status must
    be equal;
  - with ``--timing``, first the G = 4 x B = 256 group dispatch of
    ``chip_smoke.py`` phase 3 launched in series, each launch timed alone
    (CUDA events), with the allocator's new device-memory segments and
    the SM clock before and after each series: after a first launch whose
    output is held, then 10 more, after 20 s idle, after emptying the
    allocator's cache (with and without that output held), and through
    the device-memory instantiation;
  - with ``--probe``, first the probe build of the group kernel
    (``-DLZT_PROBE``, its own build key) on the G = 4 x B = 256 group
    dispatch of ``chip_smoke.py`` phase 3 and on the automaton backend's
    launch of reference row 0 (G = 1 x 255 queries sorted by length):
    the ten pairs with the longest warp span (``clock64()``), each with
    its counts by kind of step (desync jumps, anchor candidates and their
    LCE steps, synced and synced literal steps, seed-window chunks,
    prefix loads, survivors and their LCE steps, extension steps back and
    forward, events) and the cycles spent in the anchor search, the seed
    window and the extensions; the logs equal the plain build's; `--save`
    writes every pair's counts (numpy .npz);
  - ptxas's registers, shared memory and spills of each kernel;
  - kernel ms of one group dispatch at G = 4 / 8 / 16 references x B =
    256 queries, and at B = 64 / 128 / 256 queries for G = 4 (CUDA
    events, the mean of 3 launches after a warm-up), of the automaton
    backend's row launch (1 x 255) and of ``chip_smoke.py`` phase 10's
    batch (1 x 64), each with its launch plan (shared or device memory,
    warps a block, blocks a reference, the blocks an SM holds); and of
    the G = 4 x 256 dispatch through the device-memory instantiation,
    whose logs must equal the shared-memory one's;
  - the three pairs of the G = 4, B = 256 dispatch that log the most
    events, each launched alone (G = B = 1);
  - the first long-genome launch of ``synth.bacterial_set`` at the tuned
    parameters (G_big x B_big as ``all2all_cuda`` sizes it), as with
    ``--big`` (its probe build with ``--probe``);
  - kernel ms and bound of a group dispatch at LqP = 2^19 (two 261 kb
    genomes: the query bucket where the JAX engine leaves its v7 kernel),
    and its plain version's time (one call, host clock, on the card and
    on the host CPU), its logs equal to the kernel's;
  - with ``--baseline``, the G = 4 x B = 256 dispatch, the row launch,
    the batch and the bacterial launch also through the other checkout's
    ``csrc/parse_events.cu`` (its entries called through the C interface
    of its ``lzt_parse_abi``), in turns (baseline, this, this, baseline)
    on the same inputs; both must give the same logs;
  - unless ``--skip-profile``, ``all2all_cuda`` on the first 48 genomes
    under ``torch.profiler``: the parse kernel's share of device time, and
    the device-busy time against the wall time.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import time

import numpy as np
import torch

from . import synth
from .ops import build
from .ops import cuda_engine as ce
from .ops import fold_stats as fs
from .ops import parse_kernel as pk
from .params import Params
from .utils.runinfo import (card_name_and_power, fold_bound_ms,
                            launch_bound_ms, ptxas_lines, sm_clock_mhz)


def _other_kernels(tree):
    """(library, C interface version) of the parse kernels of another
    checkout's csrc/parse_events.cu, built and loaded under their own
    name, its entries' argument types set: version 3 (``lzt_parse_abi``)
    is this tree's; 2 has a long-genome entry that takes the common
    arguments only (one-byte symbols, no scratch); 1 (no
    ``lzt_parse_abi``: the one-warp-per-pair kernel) also a group entry
    without the plane scratch."""
    lib = build.load_library("parse_events_baseline", [os.path.join(
        tree, "lzani_tpu_torch", "csrc", "parse_events.cu")])
    abi = lib.lzt_parse_abi() if hasattr(lib, "lzt_parse_abi") else 1
    if abi not in (1, 2, 3):
        raise ValueError(f"{tree}: unknown parse kernel interface {abi}")
    head = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 15 + [ctypes.c_void_p]
    scratch = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
    lib.lzt_parse_events.argtypes = head + ([] if abi == 1 else scratch)
    lib.lzt_parse_events_big.argtypes = head + (
        [] if abi < 3 else [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2)
    lib.lzt_parse_events.restype = ctypes.c_int
    lib.lzt_parse_events_big.restype = ctypes.c_int
    return lib, abi


def _launch_head(fn, refbuf, qbuf, poslist, cand, next_hit, win, dsz, nrs,
                 cfg, ev_cap):
    """(ev, nev) of one launch of an entry that takes the common arguments
    only (a version-1 group entry, a version-1 or 2 long-genome entry) on
    the current stream; raises when the launch is refused."""
    G, LrP = refbuf.shape
    B, LqP = qbuf.shape
    evc = ev_cap + 1
    ev = torch.empty((G, B, evc, 8), dtype=torch.int32, device=refbuf.device)
    nev = torch.empty((G, B), dtype=torch.int32, device=refbuf.device)
    rc = fn(refbuf.data_ptr(), qbuf.data_ptr(), poslist.data_ptr(),
            cand.data_ptr(), next_hit.data_ptr(), win.data_ptr(),
            dsz.data_ptr(), nrs.data_ptr(), ev.data_ptr(), nev.data_ptr(),
            G, B, LrP, LqP, poslist.shape[1], win.shape[1], evc, cfg.mal,
            cfg.msl, cfg.mrd, cfg.mqd, cfg.reg, cfg.aw, cfg.am, cfg.ar,
            torch.cuda.current_stream(refbuf.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"baseline {fn.__name__}: kernel launch failed "
                           f"(cudaError {rc})")
    return ev, nev


def _kernel_ms(entry, args, reps=3, base=None, smem_max=None):
    """(mean kernel ms of `reps` launches after a warm-up, warm-up output)
    of the C entry `entry` of this package's build, or of `base`
    (``_other_kernels``); `smem_max` as ``parse_kernel.parse_events``."""
    lib, abi = base or (pk.load(), 3)
    fn = getattr(lib, entry)
    group = entry == "lzt_parse_events"

    def launch():
        if abi == 1 or (not group and abi == 2):
            return _launch_head(fn, *args)
        return pk._launch(entry, fn, *args, group=group,
                          smem_max=smem_max)[:2]

    out = launch()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        launch()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def _probe(tag, args, smi, save, key, big=False):
    """The probe build on one launch (of the long-genome kernel if `big`):
    the ten pairs of longest span with their counts and the shares of
    their span by kind of step; its logs must equal the plain build's."""
    G, B = args[3].shape[:2]
    probe_fn, entry = ((pk.parse_events_big_probe, "lzt_parse_events_big")
                       if big else (pk.parse_events_probe,
                                    "lzt_parse_events"))
    *out, probe = probe_fn(*args)
    ref = pk._launch(entry, getattr(pk.load(), entry), *args,
                     group=not big)[:2]
    torch.cuda.synchronize()
    if not _same_logs(out, ref):
        raise AssertionError(f"{tag}: the probe build's logs differ")
    pr = probe.cpu().numpy().reshape(G * B, pk.NPROBE)
    save[key] = pr
    dsz = (args[6] if big else args[6].expand(G, -1)).cpu().numpy()
    clk = "{} / {} MHz".format(*sm_clock_mhz())
    f = {n: j for j, n in enumerate(pk.PROBE_FIELDS)}
    tot = pr.sum(0)
    print(f"probe {tag}: {G * B} pairs, spans max {pr[:, 0].max()} / median "
          f"{int(np.median(pr[:, 0]))} cycles (SM clock now, max: {clk}); "
          f"totals " + ", ".join(f"{n} {tot[j]}" for n, j in f.items()
                                 if n != "span") + f" [{smi}]", flush=True)
    parts = ("cyc_anc", "cyc_seed", "cyc_ext", "cyc_run", "cyc_jump")
    for flat in np.argsort(pr[:, 0])[::-1][:10]:
        g, b = divmod(int(flat), B)
        row = pr[flat]
        span = max(int(row[0]), 1)
        rest = 1 - sum(row[f[n]] for n in parts) / span
        print(f"  pair (g {g}, b {b}) dsz {int(dsz[g, b])}: "
              + ", ".join(f"{n} {row[j]}" for n, j in f.items())
              + "; share " + ", ".join(f"{n[4:]} {row[f[n]] / span:.3f}"
                                       for n in parts)
              + f", other {rest:.3f}", flush=True)


def _series(tag, args, n, smi, smem_max=None):
    """`n` group launches back to back, each timed alone (CUDA events),
    with the device-memory segments the caching allocator took for them
    and the SM clock before and after."""
    def segments():
        return torch.cuda.memory_stats().get("segment.all.allocated", 0)

    c0 = sm_clock_mhz()[0]
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    s0 = segments()
    marks[0].record()
    for j in range(n):
        pk.parse_events(*args, smem_max=smem_max)
        marks[j + 1].record()
    s1 = segments()
    torch.cuda.synchronize()
    ts = [marks[j].elapsed_time(marks[j + 1]) for j in range(n)]
    print(f"{tag}: " + ", ".join(f"{t:.3f}" for t in ts) + f" ms (mean "
          f"{sum(ts) / n:.3f}); new segments {s1 - s0}; SM clock {c0} -> "
          f"{sm_clock_mhz()[0]} MHz [{smi}]", flush=True)


def _timing(args, smi):
    """What a timed series of the group dispatch reads, by what came just
    before it: the first launch's output held (as ``chip_smoke.py`` holds
    the launch it checks), 20 s of idle card, an emptied allocator
    cache."""
    held = pk.parse_events(*args)
    torch.cuda.synchronize()
    _series("timing: 3 launches after the first (held)", args, 3, smi)
    _series("timing: 10 more", args, 10, smi)
    time.sleep(20)
    _series("timing: after 20 s idle", args, 5, smi)
    torch.cuda.empty_cache()
    _series("timing: after emptying the cache, the first output held",
            args, 5, smi)
    del held
    torch.cuda.empty_cache()
    _series("timing: after emptying the cache, nothing held", args, 5, smi)
    _series("timing: the device-memory instantiation", args, 5, smi,
            smem_max=0)


def _same_logs(a, b):
    (ev, nev), (ev2, nev2) = a, b
    if not torch.equal(nev, nev2):
        return False
    k = max(int(nev.max()), 0)
    live = (torch.arange(k, device=nev.device)[None, None]
            < nev.clamp(min=0)[..., None])
    return torch.equal(ev[:, :, :k][live], ev2[:, :, :k][live])


def _versus(tag, entry, args, base_lib, reps, smi):
    """The baseline library and this one in turns on the same inputs."""
    times = {"baseline": [], "this": []}
    outs = {}
    for who in ("baseline", "this", "this", "baseline"):
        ms, out = _kernel_ms(entry, args, reps,
                             base_lib if who == "baseline" else None)
        times[who].append(ms)
        outs[who] = out
    same = _same_logs(outs["baseline"], outs["this"])
    base, this = (" / ".join(f"{t:.2f}" for t in times[who])
                  for who in ("baseline", "this"))
    print(f"{tag}: baseline {base} ms, this tree {this} ms (mean of "
          f"{reps}); logs equal: {same} [{smi}]", flush=True)
    if not same:
        raise AssertionError(f"{tag}: the two kernels' logs differ")


def _fold_args(args, overflow):
    """The fold's arguments on the logs of one parse launch of `args`,
    masked as ``engine_jax.RefIndexJax.dispatch`` masks them (a pair with
    an overflowed bucket, no log or too many records: nev = -1)."""
    refbuf, qbuf, _, _, _, _, dsz, nrs, cfg, cap = args
    ev, nev = pk.parse_events(*args)
    skip = overflow | (nev < 0) | (nev > cap)
    return (refbuf, qbuf, ev, torch.where(skip, -1, nev), dsz, nrs, cfg)


def _other_fold(tree):
    """(library, C interface version) of the fold kernel of another
    checkout's csrc/fold_stats.cu, built and loaded under its own name:
    version 2 (``lzt_fold_abi``) is this tree's; 1 (no ``lzt_fold_abi``:
    the one-thread-per-pair kernel) has the entry without scratch."""
    lib = build.load_library("fold_stats_baseline", [os.path.join(
        tree, "lzani_tpu_torch", "csrc", "fold_stats.cu")])
    abi = lib.lzt_fold_abi() if hasattr(lib, "lzt_fold_abi") else 1
    if abi not in (1, 2):
        raise ValueError(f"{tree}: unknown fold kernel interface {abi}")
    if abi == 1:
        lib.lzt_fold_stats.argtypes = ([ctypes.c_void_p] * 10
                                       + [ctypes.c_int] * 14
                                       + [ctypes.c_void_p])
        lib.lzt_fold_stats.restype = ctypes.c_int
    else:
        fs.set_argtypes(lib)
    return lib, abi


def _fold_abi1(fn, refbuf, qbuf, ev, nev, dsz, nrs, cfg):
    """(stats, status) of one launch of a version-1 fold entry on the
    current stream; raises when the launch is refused."""
    dev = refbuf.device
    G, LrP = refbuf.shape
    B, LqP = qbuf.shape
    F = fs.stack_entries(LqP)
    stats = torch.empty((G, B, 3), dtype=torch.int32, device=dev)
    status = torch.empty((G, B), dtype=torch.int32, device=dev)
    nfac = torch.empty((G, B), dtype=torch.int32, device=dev)
    stack = torch.empty((G, B, F, 2), dtype=torch.int32, device=dev)
    rc = fn(refbuf.data_ptr(), qbuf.data_ptr(), ev.data_ptr(),
            nev.data_ptr(), dsz.data_ptr(), nrs.data_ptr(), stats.data_ptr(),
            status.data_ptr(), stack.data_ptr(), nfac.data_ptr(), G, B, LrP,
            LqP, ev.shape[2], F, 2, cfg.msl, cfg.mrd, cfg.mqd, cfg.reg,
            cfg.aw, cfg.am, cfg.ar,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"baseline lzt_fold_stats: kernel launch failed "
                           f"(cudaError {rc})")
    return stats, status


def _fold_ms(fargs, reps=3, base=None):
    """(mean kernel ms of `reps` launches after `reps` others, the first
    launch's (stats, status)) of this package's fold kernel, or of `base`
    (``_other_fold``)."""
    lib, abi = base or (fs.load(), 2)

    def launch():
        if abi == 1:
            return _fold_abi1(lib.lzt_fold_stats, *fargs)
        return fs._launch(lib, *fargs, False)[:2]

    out = launch()
    for _ in range(reps):
        launch()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        launch()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def _fold_probe(tag, fargs, smi, save, key):
    """The fold's probe build on one launch: the ten pairs of longest span
    with their counts; its stats and status must equal the plain
    build's."""
    G, B = fargs[3].shape
    stats, status, probe = fs.fold_stats_probe(*fargs)
    ref = fs._launch(fs.load(), *fargs, False)[:2]
    if not (torch.equal(stats, ref[0]) and torch.equal(status, ref[1])):
        raise AssertionError(f"{tag}: the probe build's stats differ")
    pr = probe.cpu().numpy().reshape(G * B, fs.NPROBE)
    save[key] = pr
    clk = "{} / {} MHz".format(*sm_clock_mhz())
    f = {n: j for j, n in enumerate(fs.PROBE_FIELDS)}
    tot = pr.sum(0)
    print(f"fold probe {tag}: {G * B} pairs, spans max {pr[:, 0].max()} / "
          f"median {int(np.median(pr[:, 0]))} cycles (SM clock now, max: "
          f"{clk}); totals " + ", ".join(f"{n} {tot[j]}" for n, j in f.items()
                                         if n not in ("span", "max_n"))
          + f" [{smi}]", flush=True)
    for flat in np.argsort(pr[:, 0])[::-1][:10]:
        g, b = divmod(int(flat), B)
        row = pr[flat]
        span = max(int(row[0]), 1)
        print(f"  pair (g {g}, b {b}) dsz {int(fargs[4][b])}, status "
              f"{int(status[g, b])}: "
              + ", ".join(f"{n} {row[j]}" for n, j in f.items())
              + "; share " + ", ".join(
                  f"{n[4:]} {row[j] / span:.3f}" for n, j in f.items()
                  if n.startswith("cyc_")), flush=True)


def _fold(a, dev, smi, codes, params, rows, batch) -> None:
    """--fold: the fold kernel on the automaton backend's row launch
    (`rows`: parse arguments and overflow flags) and on phase 10's batch
    (`batch`)."""
    base = _other_fold(a.baseline) if a.baseline else None
    inputs = {f"row launch G=1 B={rows[0][1].shape[0]}": _fold_args(*rows),
              "batch G=1 B=64": _fold_args(*batch)}
    saved = {}
    for (tag, fargs), key in zip(inputs.items(), ("row", "batch")):
        _fold_probe(tag, fargs, smi, saved, key)
    if a.save:
        np.savez(a.save, fields=np.array(fs.PROBE_FIELDS), **saved)
    for ln in ptxas_lines(build.build_report("fold_stats")):
        print(f"ptxas {ln}", flush=True)
    for tag, fargs in inputs.items():
        ms, _ = _fold_ms(fargs)
        bound, by = fold_bound_ms(fargs[2], fargs[3], 1,
                                  fargs[1].shape[0])
        G, LrP = fargs[0].shape
        B, LqP = fargs[1].shape
        smem, ref_s, q_s, warps, slices = fs.launch_plan(
            G, B, LrP, LqP, pk.sm_count(dev), fs.smem_limit(dev))
        print(f"fold {tag}: {ms:.3f} ms, bound {bound:.5f} ms ({by}); "
              f"plan: {smem} B of shared memory (reference planes "
              f"{'shared' if ref_s else 'device'}, query planes "
              f"{'shared' if q_s else 'device'}, a ring of {fs.RING} "
              f"entries a warp), {warps} warps x {slices} blocks, "
              f"{fs.occupancy(smem, warps)} blocks an SM at most [{smi}]",
              flush=True)
    if base is None:
        return
    for tag, fargs in inputs.items():
        times = {"baseline": [], "this": []}
        outs = {}
        for who in ("baseline", "this", "this", "baseline"):
            ms, out = _fold_ms(fargs, base=base if who == "baseline"
                               else None)
            times[who].append(ms)
            outs[who] = out
        same = all(torch.equal(x, y) for x, y in zip(outs["baseline"],
                                                     outs["this"]))
        b_ms, t_ms = (" / ".join(f"{t:.3f}" for t in times[who])
                      for who in ("baseline", "this"))
        print(f"fold {tag}: baseline {b_ms} ms, this tree {t_ms} ms (mean "
              f"of 3 after 3); stats and status equal: {same} [{smi}]",
              flush=True)
        if not same:
            raise AssertionError(f"fold {tag}: the two kernels differ")


def _by_kernel(fn) -> str:
    """'kernel ms, ...': the device time of each kernel that one call of
    `fn` launches (``torch.profiler``, after a call outside it)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [(getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0)), e.key)
           for e in prof.key_averages()]
    return ", ".join(f"{key[:48]} {us / 1e3:.3f} ms"
                     for us, key in sorted(evs, reverse=True) if us > 0)


def _big(a, dev, smi, base_lib, saved) -> None:
    """The long-genome kernel on the first launch of ``synth.bacterial_set``
    at the tuned parameters (G_big x B_big as ``all2all_cuda`` sizes it):
    with --probe its probe build first; its ms and bound; with
    --baseline the other checkout's kernel in turns."""
    _, bcodes = synth.bacterial_set(a.seed)
    bcodes = sorted(bcodes, key=len, reverse=True)   # the Matcher's order
    beng = ce.CudaAll2All(bcodes, synth.bacterial_params(), devices=[dev])
    Gb, Bb = beng.big_launch_shape(len(bcodes), dev)
    r_list = list(range(Gb))
    broute = beng.routes["big"]
    bargs = broute.args(broute.build(r_list, dev), r_list, 0, dev)
    tag = f"bacterial launch G_big={Gb} x B_big={Bb}"
    if a.probe:
        _probe(tag, bargs, smi, saved, "big", big=True)
    ms, out = _kernel_ms("lzt_parse_events_big", bargs, reps=2)
    bound, by = launch_bound_ms(bargs, out[1], bargs[6])
    def launch():
        return pk._launch("parse_events_big", pk.load().lzt_parse_events_big,
                          *bargs, group=False)[2]

    warps, blocks = launch()

    print(f"{tag} (LqP {beng.LqP}, LrP {beng.LrP_big}): {ms:.2f} ms, "
          f"{int(out[1].clamp(min=0).sum())} records, bound {bound:.4f} ms "
          f"({by}); plan {warps} warps x {blocks} blocks; device time by "
          f"kernel: {_by_kernel(launch)} [{smi}]", flush=True)
    if base_lib is not None:
        _versus(tag, "lzt_parse_events_big", bargs, base_lib, 2, smi)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--seed", type=int, default=2024)
    ap.add_argument("--baseline", help="another checkout of the repo")
    ap.add_argument("--skip-profile", action="store_true")
    ap.add_argument("--probe", action="store_true",
                    help="the probe build's per-pair spans and counts")
    ap.add_argument("--timing", action="store_true",
                    help="first, the group dispatch's launches timed one "
                    "by one: after the first, after 20 s idle, after "
                    "emptying the allocator's cache")
    ap.add_argument("--fold", action="store_true",
                    help="only the fold kernel: its probe build's spans "
                    "and counts, its times (and --baseline's in turns)")
    ap.add_argument("--big", action="store_true",
                    help="only the long-genome kernel on the bacterial "
                    "launch: (with --probe) its probe build, its ms, "
                    "bound and launch plan (and --baseline's in turns)")
    ap.add_argument("--save", help="with --probe or --fold: .npz of every "
                    "pair's counts")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dispatch_probe: no CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    smi = card_name_and_power()
    base_lib = (_other_kernels(a.baseline) if a.baseline and not a.fold
                else None)
    if a.big:
        saved = {}
        _big(a, dev, smi, base_lib, saved)
        for ln in ptxas_lines(build.build_report("parse_events")):
            if "big" in ln or "pack_planes" in ln:
                print(f"ptxas {ln}", flush=True)
        if a.probe and a.save:
            np.savez(a.save, fields=np.array(pk.PROBE_FIELDS), **saved)
        return 0
    _, codes = synth.viral_set(seed=a.seed, n=a.n)
    params = Params()
    eng = ce.CudaAll2All(codes, params, devices=[dev])
    B = eng.B

    def launch_args(gi, Bq):
        """Kernel arguments of gi's references x the first Bq queries."""
        qrows = (eng.Q[dev][:Bq], eng.DSZ[dev][:Bq])
        return eng.routes["group"].args(gi, None, dev, qrows)[0]

    qs = sorted(range(1, len(codes)), key=lambda q: eng.dszs[q])
    idx = ce.CudaRefIndex(codes[0], params, dev)
    # the automaton backend's launch of row 0 (its queries sorted by
    # length) and phase 10's batch (genome 0 x genomes 0-63)
    rargs, rovf = idx.rows_args(*eng.gather_qrows(qs, dev), eng.LqP)
    bargs64, bovf = idx.batch_args(codes[:64])
    if a.fold:
        _fold(a, dev, smi, codes, params, (rargs, rovf), (bargs64, bovf))
        return 0
    if a.timing:
        _timing(launch_args(eng.routes["group"].build([0, 1, 2, 3], dev), B),
                smi)
    saved = {}
    if a.probe:
        _probe("group dispatch G=4 B=256", launch_args(
            eng.routes["group"].build([0, 1, 2, 3], dev), B), smi, saved,
            "group")
        _probe(f"row launch G=1 B={len(qs)}", rargs, smi, saved, "row")

    for ln in ptxas_lines(build.build_report("parse_events")):
        print(f"ptxas {ln}", flush=True)

    def plan(G, Bq, LrP):
        smem, warps, slices = pk.launch_plan(G, Bq, LrP, pk.sm_count(dev),
                                             pk.smem_limit(dev))
        return (f"{'shared' if smem else 'device'} memory ({smem} B), "
                f"{warps} warps x {slices} blocks a reference, "
                f"{pk.occupancy(smem, warps)} blocks an SM at most")

    gis = {}
    for G in (4, 8, 16):
        gis[G] = eng.routes["group"].build(list(range(G)), dev)
        ms, out = _kernel_ms("lzt_parse_events", launch_args(gis[G], B))
        print(f"G={G} B={B}: {ms:.2f} ms, {ms / (G * B):.4f} ms per pair; "
              f"{plan(G, B, eng.LrP_ref)} [{smi}]", flush=True)
        if G == 4:
            out4, nev4 = out, out[1].cpu().numpy()
    for Bq in (64, 128):
        ms, _ = _kernel_ms("lzt_parse_events", launch_args(gis[4], Bq))
        print(f"G=4 B={Bq}: {ms:.2f} ms; {plan(4, Bq, eng.LrP_ref)} "
              f"[{smi}]", flush=True)
    for tag, args in ((f"row launch G=1 B={len(qs)}", rargs),
                      ("batch G=1 B=64", bargs64)):
        ms, _ = _kernel_ms("lzt_parse_events", args)
        where = plan(1, args[1].shape[0], args[0].shape[1])
        print(f"{tag}: {ms:.3f} ms; {where} [{smi}]", flush=True)
    ms, dout = _kernel_ms("lzt_parse_events", launch_args(gis[4], B),
                          smem_max=0)
    if not _same_logs(dout, out4):
        raise AssertionError("the two instantiations' logs differ")
    print(f"G=4 B={B}, the reference read from device memory: {ms:.2f} ms,"
          f" logs equal to the shared-memory instantiation's [{smi}]",
          flush=True)

    for flat in np.argsort(nev4, axis=None)[::-1][:3]:
        g, b = np.unravel_index(flat, nev4.shape)
        gi = eng.routes["group"].build([int(g)], dev)
        args, _ = eng.routes["group"].args(gi, None, dev,
                                 eng.gather_qrows([int(b)], dev))
        ms, _ = _kernel_ms("lzt_parse_events", args)
        print(f"pair ({g},{b}) alone: {len(codes[g])} x {len(codes[b])} bp, "
              f"{nev4[g, b]} events, {ms:.2f} ms [{smi}]", flush=True)

    # the group path at 2^18 < LqP <= 2^19 (the JAX engine's route to
    # make_parse_kernel(big=False), pallas_engine.py:2214): a 261 kb
    # genome and a 1% relative with an unrelated stretch
    rng = np.random.RandomState(19)
    ref = rng.randint(0, 4, 261_200).astype(np.uint8)
    rel = synth.mutate(rng, ref, 0.01, n_ns=3, indels=10)
    rel[100_000:101_500] = rng.randint(0, 4, 1500)
    leng = ce.CudaAll2All([ref, rel], params, devices=[dev])
    lroute = leng.routes["group"]
    largs, _ = lroute.args(lroute.build([0, 1, -1, -1], dev), 0, dev)
    ms, out = _kernel_ms("lzt_parse_events", largs)
    bound, by = launch_bound_ms(largs, out[1], largs[6].expand(4, -1))
    plain_ms = {}
    for where in (dev, torch.device("cpu")):
        p_args = [x.to(where) if isinstance(x, torch.Tensor) else x
                  for x in largs]
        t0 = time.perf_counter()
        p_out = pk.parse_events_plain(*p_args)
        torch.cuda.synchronize()
        plain_ms[where.type] = (time.perf_counter() - t0) * 1e3
        if not _same_logs(out, [t.to(dev) for t in p_out]):
            raise AssertionError(f"LqP={leng.LqP} dispatch: kernel logs "
                                 f"differ from the plain version's on "
                                 f"{where}")
    print(f"group dispatch at LqP={leng.LqP} (G=4 with two dummy slots x "
          f"B={leng.B}; 261 kb genomes): {ms:.2f} ms, "
          f"{int(out[1].clamp(min=0).sum())} records, bound {bound:.4f} ms "
          f"({by}); plain version, logs equal, {plain_ms['cuda']:.1f} ms on "
          f"the card, {plain_ms['cpu']:.1f} ms on the host CPU [{smi}]",
          flush=True)

    if base_lib is not None:
        _versus(f"group dispatch G=4 B={B}", "lzt_parse_events",
                launch_args(gis[4], B), base_lib, 3, smi)
        _versus(f"row launch G=1 B={len(qs)}", "lzt_parse_events", rargs,
                base_lib, 3, smi)
        _versus("batch G=1 B=64", "lzt_parse_events", bargs64, base_lib, 3,
                smi)
    _big(a, dev, smi, base_lib, saved)
    if a.probe and a.save:
        np.savez(a.save, fields=np.array(pk.PROBE_FIELDS), **saved)
    if a.skip_profile:
        return 0

    from torch.profiler import ProfilerActivity, profile

    sub = codes[:48]
    ce.all2all_cuda(sub, params, device=dev)          # build and warm up
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ce.all2all_cuda(sub, params, device=dev)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    evs = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    total = sum(dev_us(e) for e in evs)
    kern = sum(dev_us(e) for e in evs if "parse_events_kernel" in e.key)
    top = sorted(evs, key=dev_us, reverse=True)[:4]
    print(f"profile, 48 genomes: device busy {total / 1e6:.2f} s of "
          f"{wall:.2f} s wall (profiler on); parse kernel "
          f"{100 * kern / max(total, 1):.1f}% of device time; top: "
          + ", ".join(f"{e.key[:40]} {dev_us(e) / 1e3:.1f} ms" for e in top)
          + f" [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
