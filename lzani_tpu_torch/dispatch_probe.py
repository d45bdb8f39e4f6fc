"""Dispatch probe of the CUDA engine on one card: what sets the time of a
launch, on the smoke sets of ``chip_smoke.py``.

    python -m lzani_tpu_torch.dispatch_probe [--n 256] [--seed 2024] \\
        [--baseline OTHER_CHECKOUT] [--skip-profile]

Prints, each line beside the card's name and power limit:
  - kernel ms of one group dispatch at G = 4 / 8 / 16 references x B =
    256 queries, and at B = 64 / 128 / 256 queries for G = 4 (CUDA
    events, the mean of 3 launches after a warm-up);
  - the three pairs of the G = 4, B = 256 dispatch that log the most
    events, each launched alone (G = B = 1);
  - kernel ms of the first long-genome launch of ``synth.bacterial_set``
    at the tuned parameters (G_big x B_big as ``all2all_cuda`` sizes it);
  - kernel ms and bound of a group dispatch at LqP = 2^19 (two 261 kb
    genomes: the query bucket where the JAX engine leaves its v7 kernel);
  - with ``--baseline``, the G = 4 x B = 256 dispatch and the bacterial
    launch also through the other checkout's ``csrc/parse_events.cu`` (same
    C interface), in turns (baseline, this, this, baseline) on the same
    inputs; both must give the same logs;
  - unless ``--skip-profile``, ``all2all_cuda`` on the first 48 genomes
    under ``torch.profiler``: the parse kernel's share of device time, and
    the device-busy time against the wall time.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from . import synth
from .ops import build
from .ops import cuda_engine as ce
from .ops import parse_kernel as pk
from .params import Params
from .utils.runinfo import card_name_and_power, launch_bound_ms


def _other_kernels(tree):
    """The parse kernels of another checkout's csrc/parse_events.cu (the
    same C interface), built and loaded under their own name."""
    lib = build.load_library("parse_events_baseline", [os.path.join(
        tree, "lzani_tpu_torch", "csrc", "parse_events.cu")])
    ours = pk.load()
    for entry in ("lzt_parse_events", "lzt_parse_events_big"):
        fn, like = getattr(lib, entry), getattr(ours, entry)
        fn.argtypes, fn.restype = like.argtypes, like.restype
    return lib


def _kernel_ms(entry, args, reps=3, lib=None):
    """(mean kernel ms of `reps` launches after a warm-up, warm-up output)
    of the C entry `entry` of `lib` (default: this package's build)."""
    fn = getattr(lib or pk.load(), entry)
    out = pk._launch(entry, fn, *args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        pk._launch(entry, fn, *args)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--seed", type=int, default=2024)
    ap.add_argument("--baseline", help="another checkout of the repo")
    ap.add_argument("--skip-profile", action="store_true")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dispatch_probe: no CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    smi = card_name_and_power()
    base_lib = _other_kernels(a.baseline) if a.baseline else None
    _, codes = synth.viral_set(seed=a.seed, n=a.n)
    params = Params()
    eng = ce.CudaAll2All(codes, params, devices=[dev])
    B = eng.B

    def group_args(gi, Bq):
        """Kernel arguments of gi's references x the first Bq queries."""
        qrows = (eng.Q[dev][:Bq], eng.DSZ[dev][:Bq])
        return eng.group_args(gi, None, dev, qrows)[0]

    gis = {}
    for G in (4, 8, 16):
        gis[G] = eng.build_group_index(list(range(G)), dev)
        ms, out = _kernel_ms("lzt_parse_events", group_args(gis[G], B))
        print(f"G={G} B={B}: {ms:.2f} ms, {ms / (G * B):.4f} ms per pair "
              f"[{smi}]", flush=True)
        if G == 4:
            nev4 = out[1].cpu().numpy()
    for Bq in (64, 128):
        ms, _ = _kernel_ms("lzt_parse_events", group_args(gis[4], Bq))
        print(f"G=4 B={Bq}: {ms:.2f} ms [{smi}]", flush=True)

    for flat in np.argsort(nev4, axis=None)[::-1][:3]:
        g, b = np.unravel_index(flat, nev4.shape)
        gi = eng.build_group_index([int(g)], dev)
        args, _ = eng.group_args(gi, None, dev,
                                 eng.gather_qrows([int(b)], dev))
        ms, _ = _kernel_ms("lzt_parse_events", args)
        print(f"pair ({g},{b}) alone: {len(codes[g])} x {len(codes[b])} bp, "
              f"{nev4[g, b]} events, {ms:.2f} ms [{smi}]", flush=True)

    _, bcodes = synth.bacterial_set(a.seed)
    bcodes = sorted(bcodes, key=len, reverse=True)   # the Matcher's order
    beng = ce.CudaAll2All(bcodes, synth.bacterial_params(), devices=[dev])
    Gb, Bb = beng.big_launch_shape(len(bcodes), dev)
    r_list = list(range(Gb))
    bargs = beng.big_args(beng.build_big_index(r_list, dev), r_list, 0, dev)
    ms, out = _kernel_ms("lzt_parse_events_big", bargs, reps=2)
    print(f"bacterial launch G_big={Gb} x B_big={Bb} (LqP {beng.LqP}): "
          f"{ms:.2f} ms, {int(out[1].clamp(min=0).sum())} records "
          f"[{smi}]", flush=True)

    # the group path at 2^18 < LqP <= 2^19 (the JAX engine's route to
    # make_parse_kernel(big=False), pallas_engine.py:2214): a 261 kb
    # genome and a 1% relative with an unrelated stretch
    rng = np.random.RandomState(19)
    ref = rng.randint(0, 4, 261_200).astype(np.uint8)
    rel = synth.mutate(rng, ref, 0.01, n_ns=3, indels=10)
    rel[100_000:101_500] = rng.randint(0, 4, 1500)
    leng = ce.CudaAll2All([ref, rel], params, devices=[dev])
    largs, _ = leng.group_args(leng.build_group_index([0, 1, -1, -1], dev),
                               0, dev)
    ms, out = _kernel_ms("lzt_parse_events", largs)
    bound, by = launch_bound_ms(largs, out[1], largs[6].expand(4, -1))
    print(f"group dispatch at LqP={leng.LqP} (G=4 with two dummy slots x "
          f"B={leng.B}; 261 kb genomes): {ms:.2f} ms, "
          f"{int(out[1].clamp(min=0).sum())} records, bound {bound:.4f} ms "
          f"({by}) [{smi}]", flush=True)

    if base_lib is not None:
        _versus(f"group dispatch G=4 B={B}", "lzt_parse_events",
                group_args(gis[4], B), base_lib, 3, smi)
        _versus(f"bacterial launch G_big={Gb} x B_big={Bb}",
                "lzt_parse_events_big", bargs, base_lib, 1, smi)
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
