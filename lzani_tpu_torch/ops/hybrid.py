"""Hybrid CPU + CUDA all-vs-all scheduler (torch-free at import).

Counterpart of ``lzani_tpu/ops/hybrid.py``: the native C++ thread pool
and the CUDA group engine (``cuda_engine.CudaAll2All``) take reference
rows from one shared two-ended queue and write into one triples buffer.
This module imports neither torch nor the CUDA engine. The warm-up
thread imports them, and it starts only once the native pool's early
rate projects the queue to outlast LZANI_TPU_WARM_MIN_S, so a run too
short to profit never pays for the device, torch's import included.

Where it differs from the JAX function:
  * ``device=None`` means the current CUDA device. Without a card
    ``all2all_hybrid`` raises at entry (``utils.cudadev`` asks libcuda,
    without torch); it never quietly runs the native pool in the card's
    place. ``device="cpu"`` runs the kernel's plain version (tests).
  * A warm-up or a drain that fails on a CUDA device migrates its work
    to the host, as in the JAX function, and the run then raises once
    it has ended, so a run that was asked to use the card never
    succeeds without it. A warm-up that stops on the envelope or on a
    cancel is policy, not a failure.
  * Event logs are replayed by ``finalize.Finalizer``: a log the replay
    rejects is counted, and the run raises once it has ended, as
    ``all2all_cuda`` does (the JAX function re-parses such a pair).
  * Rows off the group path (``CudaAll2All.paths``) run on the host, as
    in the JAX function. When every row would take the long-genome path
    (``CudaAll2All.big_only_reason``) the warm-up stops with
    ``warm_why = "envelope: ..."`` and the native pool owns the run.
  * After a device failure the host re-runs only the claimed pairs that
    no replay task took, so no region record is written twice.
"""

from __future__ import annotations

import copy
import ctypes as ct
import os
import sys
import threading
import time
from collections import defaultdict, deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..core import native_engine
from ..utils import cudadev
from .finalize import Finalizer

# ---- warm-thread lifecycle -------------------------------------------------
# A warm-up thread still inside torch's import, the engine's construction
# or the kernel build when the interpreter exits can abort the process at
# teardown (daemon threads are killed mid-C++). all2all_hybrid sets the
# cancel flag and joins for a bounded time; a thread that outlives the
# join is parked here and joined, without a bound, by an atexit hook,
# which runs while the interpreter is still whole. The warm-up checks the
# cancel flag at every step boundary, so that wait is bounded by one step.
_parked_warm: list = []
_parked_lock = threading.Lock()
_atexit_registered = False


def _join_parked_warm():
    for t, st in list(_parked_warm):
        st["cancel"] = True
        t.join()
    _parked_warm.clear()


def _park_warm_thread(t, warm_state):
    global _atexit_registered
    import atexit

    with _parked_lock:
        # drop entries that have since finished
        _parked_warm[:] = [(pt, ps) for pt, ps in _parked_warm
                           if pt.is_alive()]
        _parked_warm.append((t, warm_state))
        if not _atexit_registered:
            atexit.register(_join_parked_warm)
            _atexit_registered = True


def _thread_idle_priority():
    """Best effort: drop the CALLING thread's scheduling priority to idle
    (Linux per-thread nice 19). The device side's host threads (warm-up,
    scheduling, downloads, replay) run so, and take only the cycles the
    native pool leaves spare. Returns (tid, old nice) for
    _restore_priority, or None."""
    try:
        import platform

        nr = {"x86_64": 186, "aarch64": 178}.get(platform.machine())
        if nr is None:
            return None
        libc = ct.CDLL(None, use_errno=True)
        tid = libc.syscall(nr)
        if tid <= 0:
            return None
        old = libc.getpriority(0, tid)
        libc.setpriority(0, tid, 19)
        return (tid, old)
    except (OSError, AttributeError):
        return None


def _restore_priority(tok):
    if tok is None:
        return
    try:
        ct.CDLL(None, use_errno=True).setpriority(0, tok[0], tok[1])
    except (OSError, AttributeError):
        pass


def _current_cuda_device() -> str:
    """'cuda:<i>' for the calling thread's current CUDA device, without
    importing torch: the index torch has set when it has already set up
    CUDA in this process, else 0. Raises RuntimeError without a card."""
    if cudadev.cuda_device_count() == 0:
        raise RuntimeError("all2all_hybrid: no CUDA device")
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        return f"cuda:{torch.cuda.current_device()}"
    return "cuda:0"


def all2all_hybrid(codes, params, filter_csr=None, progress=None,
                   region_path: str | None = None, device=None,
                   cpu_threads: int | None = None, replay_threads: int = 0,
                   stats: dict | None = None):
    """Heterogeneous all-vs-all: the native thread pool and the CUDA
    event-log engine pop reference rows from one shared two-ended queue.
    Layout of the result as ``native_engine.all2all``.

    Scheduling (the JAX function's, constants unchanged):
      * Two-ended queue (``lza_claim_head`` / ``lza_claim_tail`` on one
        packed int64 {tail:32|head:32}): the native pool keeps the
        longest-first schedule from the head; the device claims groups
        of GROUP short rows from the tail, so it never holds an expensive
        head row at the end of the run.
      * Tail throttle, one probe group until the first drain, and an
        outstanding-pairs cap (``claim_rows``); a duty-cycle controller
        that stops claims while the device side slows the native pool.
      * Lazy asynchronous warm-up: it starts only once the native pool's
        early rate projects the queue to outlast LZANI_TPU_WARM_MIN_S
        (default 20 s), the device claims only after a dummy group has
        completed, and the run returns as soon as the queue drains (a
        slow warm-up never gates completion).
    LZANI_TPU_HYBRID_GREEDY=1 starts the warm-up at once and lifts every
    claim gate; LZANI_TPU_HYBRID_DEBUG=1 logs the scheduler's steps;
    LZANI_TPU_GROUP sets the references per group (4).

    Failures migrate work, never lose it: a device dead at warm-up leaves
    the run to the native pool, a device failing mid-run has its claimed
    pairs re-run on the host (a warning at -V 1 for both). On a CUDA
    device the run then raises RuntimeError, its output complete but
    not returned (``stats`` says what failed).

    `device`: None for the current CUDA device (raises without a card),
    or a torch device or its name; ``"cpu"`` runs the plain versions.
    cpu_threads=0 delegates to ``all2all_cuda``.

    `stats`, when given, receives: device_pairs (pairs whose logs the
    device side downloaded), cpu_rows / cpu_pairs (the native pool's),
    warm_s (the dummy group's time), warm_started, warm_pending (still
    warming when the run ended), warm_why (why the device took no part:
    a cancel, an envelope, an error; None otherwise), t_unit_s (the
    drain-to-drain EMA), duty_latched, launches (kernel launches, the
    dummy group's included), cap_fallbacks, replay_mismatches,
    native_rows (claimed rows off the group path) and failed_rows (rows
    re-run on the host after a device failure).
    """
    if cpu_threads is None:
        # the caller's -t; when unset, every core: the device side's
        # threads run at idle priority and take what the pool leaves
        cpu_threads = (getattr(params, "no_threads", 0)
                       or os.cpu_count() or 1)
    if cpu_threads <= 0:
        from .cuda_engine import all2all_cuda
        return all2all_cuda(codes, params, filter_csr=filter_csr,
                            progress=progress, replay_threads=replay_threads,
                            region_path=region_path, device=device,
                            stats=stats)
    if device is None:
        device = _current_cuda_device()

    n = len(codes)
    if filter_csr is None:
        indptr = ids = None
        out = np.zeros((n, max(n - 1, 0), 3), dtype=np.int32)
        total_pairs = n * (n - 1)
    else:
        indptr, ids = filter_csr
        out = np.zeros((len(ids), 3), dtype=np.int32)
        total_pairs = len(ids)

    lib = native_engine.get_lib()
    # two-ended row queue packed as {tail:32|head:32}
    counter = np.array([n << 32], np.int64)
    cptr = counter.ctypes.data_as(ct.POINTER(ct.c_int64))

    def queue_rem():
        v = int(counter[0])
        return (v >> 32) - (v & 0xFFFFFFFF)

    verbosity = getattr(params, "verbosity_level", 1)
    greedy = bool(int(os.environ.get("LZANI_TPU_HYBRID_GREEDY", "0")))
    debug = bool(int(os.environ.get("LZANI_TPU_HYBRID_DEBUG", "0")))
    warm_min_s = float(os.environ.get("LZANI_TPU_WARM_MIN_S", "20"))
    GROUP = max(1, int(os.environ.get("LZANI_TPU_GROUP", "4")))
    depth = 2   # units in flight on the one device

    def _warn(msg):
        if verbosity >= 1:
            print(msg, file=sys.stderr)

    def _dbg(msg):
        if debug:
            print(f"[hyb +{time.perf_counter() - t_run0:6.1f}s] {msg}",
                  file=sys.stderr, flush=True)

    def wanted_of(r):
        """{query: output slot} of reference row r."""
        if filter_csr is None:
            return {q: (r, q - 1 if q > r else q) for q in range(n) if q != r}
        return {int(q): int(indptr[r]) + k
                for k, q in enumerate(ids[indptr[r]:indptr[r + 1]])}

    side_path = region_path + ".device" if region_path else None
    rf = open(side_path, "wb") if side_path else None
    fin = Finalizer(codes, params, out, rf)

    # ---- CPU side: the native pool claims rows from the shared queue ----
    p2 = copy.copy(params)
    p2.no_threads = cpu_threads
    nat_prog = np.zeros(2, np.int64)
    nat_exc: list[BaseException] = []

    def run_native():
        try:
            native_engine.all2all(codes, p2, filter_csr=filter_csr,
                                  region_path=region_path, progress=nat_prog,
                                  ext_counter=counter, out=out)
        except BaseException as e:  # surfaced after the join
            nat_exc.append(e)

    # ---- device side ------------------------------------------------------
    # the engine is built in the warm thread, off the run's critical path
    eng = None
    lock = threading.Lock()
    device_pairs = 0     # drained (event logs downloaded)
    dev_claimed = 0      # pairs on claimed device rows
    dev_done = [0]       # finalized (replayed and stored)
    dev_rows = [0]       # reference rows the device side has finished
    cap_fallbacks = 0
    native_rows = 0
    sent = defaultdict(set)   # r -> queries handed to a replay task

    def fin_many(r, items):
        # one replay task per reference row
        for q, ev, slot in items:
            fin(r, q, ev, slot)
        with lock:
            dev_done[0] += len(items)

    def host_row(r, wanted):
        # a claimed row run on the host: off the group path, or recovered
        _native_row(codes, params, r, wanted, out, fin)
        with lock:
            dev_rows[0] += 1
        report()

    def report():
        if progress is not None:
            progress(int(nat_prog[1]) + device_pairs, total_pairs,
                     int(nat_prog[0]) + dev_rows[0], n)

    nat_thread = threading.Thread(target=run_native, daemon=True)
    t_run0 = time.perf_counter()
    nat_thread.start()

    nthreads = replay_threads or max(2, (os.cpu_count() or 2) - 1)
    # every device-side host thread runs at idle priority
    dl_pool = ThreadPoolExecutor(max_workers=2,
                                 initializer=_thread_idle_priority)
    pool = ThreadPoolExecutor(max_workers=nthreads,
                              initializer=_thread_idle_priority)
    pending = []
    drain_futs = []
    inflight = deque()   # (r_list, (subs, lo), handles, t_dispatch, ...)
    unit_q = deque()     # (r_list, lo, subs, index future, device, ...)
    # steady-state device unit service time: EMA of drain-to-drain
    # intervals (pipeline-aware, unlike per-dispatch wall time)
    t_group = [None]
    t_last_drain = [None]

    # The warm-up builds the engine and completes an all-dummy group
    # before the device claims a row: asynchronously, so that a slow
    # import, context or kernel build never gates a run the native pool
    # can finish alone, and lazily, since building the engine (packing
    # and uploading the queries) costs host CPU the pool could use.
    warm_state: dict = {"s": None, "ok": None, "why": None}

    def _stop(why):
        warm_state["ok"] = False
        warm_state["why"] = why

    def _warm():
        nonlocal eng
        _dbg("warm thread entered")
        if not greedy and warm_state.get("projected_s", 0.0) < 60.0:
            # a short queue: the warm-up takes only the cycles the pool
            # leaves spare. A long one (>= 60 s projected) warms at
            # normal priority: the seconds it takes are a small share of
            # the run, and an idle-priority warm-up under a saturated
            # pool may never finish
            _thread_idle_priority()
        try:
            # torch's import is part of the warm-up by design: a run that
            # never warms never pays it
            import torch

            if warm_state.get("cancel"):   # the run drained meanwhile
                return _stop("cancelled-after-import")
            from . import parse_kernel
            from .cuda_engine import (CudaAll2All, device_envelope_reason,
                                      query_shape)

            warm_state["launches0"] = parse_kernel.parse_events.launches
            warm_state["kernels"] = parse_kernel
            shape = query_shape(codes, params.max_dist_in_ref)
            why = (device_envelope_reason(params)
                   or CudaAll2All.big_only_reason(shape[1],
                                                  params.min_anchor_len))
            if why is not None:
                # policy, not a failure: the native pool owns the run
                return _stop(f"envelope: {why}")
            if warm_state.get("cancel"):
                return _stop("cancelled-before-engine")
            if not greedy:
                # re-project before the engine's construction: the gate
                # used the pool's early rate, which understates its
                # steady rate. If the queue no longer outlasts 60 s,
                # build only on spare cycles (usually then cancelled)
                el = time.perf_counter() - t_run0
                pdone = int(nat_prog[1])
                if pdone > 0 and el > 0:
                    if (total_pairs - pdone) / (pdone / el) < 60.0:
                        _thread_idle_priority()
            dev = torch.device(device)
            _dbg(f"warm: device {dev}")
            e = CudaAll2All(codes, params, devices=[dev], shape=shape)
            _dbg("warm: engine constructed")
            if warm_state.get("cancel"):
                return _stop("cancelled-before-dispatch")
            if dev.type == "cuda":
                parse_kernel.load()      # nvcc at first use
                if warm_state.get("cancel"):
                    return _stop("cancelled-after-build")
            gi = e.build_group_index([-1] * GROUP, dev)
            t0 = time.perf_counter()
            e.collect_group(e.dispatch_group(gi, 0, dev))
            warm_state["s"] = time.perf_counter() - t0
            eng = e
            warm_state["ok"] = True
            _dbg(f"warm: dummy group done ({warm_state['s']:.2f}s)")
        except Exception as ex:  # device dead at start: the pool owns the run
            _stop(f"{type(ex).__name__}: {ex}"[:200])
            _warn(f"lz-ani-torch: device warm-up failed ({type(ex).__name__}:"
                  f" {ex}); hybrid run continues on the native pool alone")

    warm_thread = threading.Thread(target=_warm, name="lzani-hybrid-warm",
                                   daemon=True)

    def drain(r_list, subs_lo, handles, t_disp, urem, nrows):
        nonlocal device_pairs, cap_fallbacks
        subs, lo = subs_lo
        evs = eng.collect_group(handles)
        n_sub = n_fb = 0
        for g, r in enumerate(r_list):
            items = [(q, evs[g][q - lo], slot) for q, slot in subs[g].items()]
            if items:
                n_fb += sum(ev is None for _, ev, _ in items)
                with lock:
                    sent[r].update(q for q, _, _ in items)
                pending.append(pool.submit(fin_many, r, items))
            n_sub += len(items)
        with lock:
            device_pairs += n_sub
            cap_fallbacks += n_fb
            urem[0] -= 1
            if urem[0] == 0:   # the group's last unit: its rows are done
                dev_rows[0] += nrows
            now = time.perf_counter()
            if t_last_drain[0] is not None:
                dt = now - t_last_drain[0]
                t_group[0] = (dt if t_group[0] is None
                              else 0.5 * t_group[0] + 0.5 * dt)
            t_last_drain[0] = now
        report()

    grp_pairs_est = max(1, GROUP * total_pairs // max(1, n))

    # ---- duty-cycle displacement controller --------------------------------
    # The device side's host work (index builds, downloads, replay)
    # competes with the native pool for cores, and can displace more
    # native throughput than the device adds. A baseline taken at the
    # start cannot see it (the longest-first schedule makes the native
    # rate rise over the run), so claims are duty-cycled (ACT s on, PAUSE
    # s off), each ~1 s bucket of native progress is classed by whether
    # the device pipeline was active, and the active and idle rate EMAs
    # are compared: active < RATIO * idle latches claims off for RETRY s.
    ACT, PAUSE, BUCKET = 6.0, 1.5, 0.8
    RATIO, RETRY = 0.985, 45.0
    duty = {"b0": None, "p0": 0, "act": False,   # current bucket
            "ema_a": None, "ema_i": None, "n_a": 0, "n_i": 0,
            "off_until": 0.0, "latched": 0}

    def device_active():
        return (len(inflight) + len(unit_q) > 0
                or dev_claimed - dev_done[0] > 0)

    def duty_sample(el):
        """Advance the bucket clock; True while the duty and latch state
        allow claims."""
        d = duty
        if d["b0"] is None:
            d["b0"], d["p0"] = el, int(nat_prog[1])
            d["act"] = device_active()
            return True
        d["act"] = d["act"] or device_active()
        span = el - d["b0"]
        if span >= BUCKET and nat_thread.is_alive():
            rate = (int(nat_prog[1]) - d["p0"]) / span
            k = "ema_a" if d["act"] else "ema_i"
            nk = "n_a" if d["act"] else "n_i"
            d[k] = rate if d[k] is None else 0.6 * d[k] + 0.4 * rate
            d[nk] += 1
            d["b0"], d["p0"] = el, int(nat_prog[1])
            d["act"] = device_active()
            if (d["n_a"] >= 2 and d["n_i"] >= 2
                    and d["ema_a"] < RATIO * d["ema_i"]):
                d["off_until"] = el + RETRY
                d["latched"] += 1
                # forget the verdict's inputs so the re-probe is fresh
                d["ema_a"] = d["ema_i"] = None
                d["n_a"] = d["n_i"] = 0
                _dbg(f"displacement latch (active < {RATIO} * idle)")
        if el < d["off_until"]:
            return False
        # the duty cycle guarantees idle buckets for the comparison
        return ((el - d["off_until"]) % (ACT + PAUSE)) < ACT

    def claim_rows():
        """Up to GROUP rows from the tail (the shortest references), only
        while the device adds throughput: (1) the duty-cycle controller;
        (2) one probe group until the first drain gives the device's
        service time; (3) the tail backlog: never claim what the pool
        would finish before the device drains its own queue. Plus a cap
        on outstanding pairs: replay work queued behind the drains would
        otherwise build up unseen and land at the end of the run."""
        rem = queue_rem()
        if rem <= 0:
            return None
        el = time.perf_counter() - t_run0
        rows_done = int(nat_prog[0])
        if not greedy:
            allow = duty_sample(el)
            if dev_claimed - dev_done[0] > 2 * grp_pairs_est:
                return None
            if not allow:
                return None
            if t_group[0] is None and (len(inflight) + len(unit_q)) >= 1:
                return None
            if rows_done > 0 and el > 0:
                cpu_rate = rows_done / el
                # a real group costs ~2.5-4x the all-dummy warm dispatch
                tg = (t_group[0] if t_group[0] is not None
                      else 4.0 * (warm_state["s"] or 1.0))
                backlog = (len(inflight) + len(unit_q) + 1) * tg
                if rem / cpu_rate < backlog:
                    return None
        got = ct.c_int64(0)
        start = int(lib.lza_claim_tail(cptr, GROUP, ct.byref(got)))
        if start < 0:
            return None
        return list(range(start, start + int(got.value)))

    k_disp = 0
    done_claiming = False
    current = None  # unit popped but not yet in `inflight`
    warm_started = False
    failed_rows: set[int] = set()
    finished = False
    # the scheduler loop is device-side host work too: idle priority,
    # restored before returning (greedy keeps normal priority)
    prio_tok = None if greedy else _thread_idle_priority()
    try:
        try:
            while True:
                if not warm_started:
                    # lazy warm-up gate: start only if the queue will
                    # outlast the threshold at the pool's early rate
                    if queue_rem() <= 0 or not nat_thread.is_alive():
                        break
                    el = time.perf_counter() - t_run0
                    pdone = int(nat_prog[1])
                    if greedy:
                        warm_started = True
                    elif el >= 0.5 and pdone > 0:
                        projected = (total_pairs - pdone) / (pdone / el)
                        if projected <= warm_min_s:
                            break  # too small to profit from the device
                        warm_state["projected_s"] = projected
                        warm_started = True
                    if warm_started:
                        warm_thread.start()
                    else:
                        time.sleep(0.02)
                        continue
                if warm_state["ok"] is None:
                    # still warming: the pool owns the queue meanwhile,
                    # and a drained queue ends the run without waiting
                    if queue_rem() <= 0:
                        break
                    time.sleep(0.05)
                    continue
                if warm_state["ok"] is False:
                    break
                while not done_claiming and len(unit_q) < depth + 1:
                    rows = claim_rows()
                    if rows is None:
                        # a throttled claim is not final; only an
                        # exhausted queue ends claiming
                        if queue_rem() <= 0:
                            done_claiming = True
                        break
                    on_dev = [r for r in rows if eng.paths[r] == "group"]
                    for r in rows:
                        if eng.paths[r] != "group":
                            native_rows += 1
                            pending.append(pool.submit(host_row, r,
                                                       wanted_of(r)))
                    if not on_dev:
                        continue
                    r_list = on_dev + [-1] * (GROUP - len(on_dev))
                    dev = eng.device_for(k_disp)
                    gf = pool.submit(eng.build_group_index, r_list, dev)
                    wanteds = [wanted_of(r) if r >= 0 else {}
                               for r in r_list]
                    dev_claimed += sum(len(w) for w in wanteds)
                    g_units = []
                    for lo in range(0, eng.n_pad, eng.B):
                        subs = [{q: s for q, s in w.items()
                                 if lo <= q < lo + eng.B} for w in wanteds]
                        if any(subs):
                            g_units.append((lo, subs))
                    urem = [len(g_units)]   # rows count at the last drain
                    for lo, subs in g_units:
                        unit_q.append((r_list, lo, subs, gf, dev, urem,
                                       len(on_dev)))
                if not unit_q and not inflight:
                    if done_claiming:
                        break
                    # throttled: the pool owns the rest; wait for it
                    if not nat_thread.is_alive():
                        done_claiming = queue_rem() <= 0
                        if done_claiming:
                            break
                    time.sleep(0.02)
                    continue
                if unit_q:
                    current = unit_q.popleft()
                    r_list, lo, subs, gf, dev, urem, nrows = current
                    idx = gf.result()
                    t_disp = time.perf_counter()
                    handles = eng.dispatch_group(idx, lo, dev)
                    inflight.append((r_list, (subs, lo), handles, t_disp,
                                     urem, nrows))
                    current = None
                    k_disp += 1
                if len(inflight) >= depth or not unit_q:
                    if inflight:
                        u = inflight.popleft()
                        drain_futs.append((dl_pool.submit(drain, *u), u[0]))

            for f, rl in drain_futs:
                try:
                    f.result()
                except Exception as e:
                    _warn(f"lz-ani-torch: device drain failed "
                          f"({type(e).__name__}: {e}); group recovered on "
                          f"the host")
                    failed_rows.update(r for r in rl if r >= 0)
        except Exception as e:
            # device failure mid-run: every claimed row not yet handed to
            # replay is re-run on the host
            if current is not None:
                failed_rows.update(r for r in current[0] if r >= 0)
            for u in list(unit_q) + list(inflight):
                failed_rows.update(r for r in u[0] if r >= 0)
            for f, rl in drain_futs:
                try:
                    f.result()
                except Exception:
                    failed_rows.update(r for r in rl if r >= 0)
            _warn(f"lz-ani-torch: device failed mid-run ({type(e).__name__}:"
                  f" {e}); {len(failed_rows)} claimed rows recovered on the "
                  f"host, run continues on the native pool")
        # every drain has ended: `sent` is final
        for r in sorted(failed_rows):
            left = {q: s for q, s in wanted_of(r).items()
                    if q not in sent.get(r, ())}
            pending.append(pool.submit(host_row, r, left))
        warm_state["cancel"] = True  # a pending warm-up stops at its next
        #                              step boundary
        if warm_started and warm_thread.is_alive():
            # bounded join; a thread stuck in an uninterruptible step
            # (torch's import, the engine's construction, a kernel build)
            # is parked for the atexit join
            warm_thread.join(timeout=2.0)
            if warm_thread.is_alive():
                _park_warm_thread(warm_thread, warm_state)
        nat_thread.join()
        _restore_priority(prio_tok)
        if nat_exc:
            raise nat_exc[0]
        for f in pending:
            f.result()
        finished = True
    finally:
        pool.shutdown(wait=True)
        dl_pool.shutdown(wait=True)
        if rf is not None:
            rf.close()
            if finished:
                # the device side's region records go after the native
                # pool's (records are self-delimiting, order-free)
                with open(region_path, "ab") as dst, \
                        open(side_path, "rb") as src:
                    while chunk := src.read(1 << 20):
                        dst.write(chunk)
            os.remove(side_path)
    report()
    kernels = warm_state.get("kernels")
    st = dict(
        device_pairs=device_pairs, cpu_rows=int(nat_prog[0]),
        cpu_pairs=int(nat_prog[1]), warm_s=warm_state["s"],
        warm_started=warm_started,
        warm_pending=warm_started and warm_state["ok"] is None,
        warm_why=warm_state["why"], t_unit_s=t_group[0],
        duty_latched=duty["latched"],
        launches=(kernels.parse_events.launches - warm_state["launches0"]
                  if kernels is not None else 0),
        cap_fallbacks=cap_fallbacks, replay_mismatches=fin.replay_mismatches,
        native_rows=native_rows, failed_rows=len(failed_rows))
    if stats is not None:
        stats.update(st)
    if fin.replay_mismatches:
        raise RuntimeError(
            f"lz-ani-torch: {fin.replay_mismatches} kernel event logs "
            f"failed the replay cross-check (first pairs (r, q): "
            f"{fin.mismatched[:5]}); the kernel's output is wrong")
    why = warm_state["why"]
    warm_failed = why is not None and not why.startswith(("envelope:",
                                                          "cancelled"))
    if _on_card(device) and (warm_failed or failed_rows):
        raise RuntimeError(
            f"lz-ani-torch: the CUDA device failed during this hybrid run "
            f"(warm-up: {why if warm_failed else 'ok'}; rows re-run on the "
            f"host: {len(failed_rows)}); the native pool completed the "
            f"output, but the run was asked to use the card")
    return out


def _on_card(device) -> bool:
    """Whether `device` (a torch device or its name) is a CUDA device."""
    return str(device).split(":")[0] == "cuda"


def _native_row(codes, params, r, wanted, out, fin):
    """Run reference row r's `wanted` pairs ({query: slot}) on the host
    into the shared buffer: pair by pair through the finalizer when it
    writes regions, else one single-threaded native call (one index
    build)."""
    if not wanted:
        return
    if fin.rf is not None:
        for q, slot in wanted.items():
            fin(r, q, None, slot)
        return
    n = len(codes)
    qs = sorted(wanted)
    indptr = np.zeros(n + 1, np.int64)
    indptr[r + 1:] = len(qs)
    p1 = copy.copy(params)
    p1.no_threads = 1
    sub = native_engine.all2all(codes, p1,
                                filter_csr=(indptr, np.array(qs, np.int32)))
    for k, q in enumerate(qs):
        out[wanted[q]] = sub[k]
