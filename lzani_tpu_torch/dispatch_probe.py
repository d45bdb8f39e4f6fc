"""Dispatch probe of the CUDA engine on one card: what sets the time of a
group dispatch, on the smoke set of ``chip_smoke.py``.

    python -m lzani_tpu_torch.dispatch_probe [--n 256] [--seed 2024]

Prints, each line beside the card's name and power limit:
  - kernel ms of one dispatch at G = 4 / 8 / 16 references x B = 256
    queries, and at B = 64 / 256 queries for G = 4 (CUDA events, the mean
    of 3 launches after a warm-up);
  - the three pairs of the G = 4, B = 256 dispatch that log the most
    events, each launched alone (G = B = 1);
  - ``all2all_cuda`` on the first 48 genomes under ``torch.profiler``:
    the parse kernel's share of device time, and the device-busy time
    against the wall time.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from . import synth
from .ops import cuda_engine as ce
from .ops.parse_kernel import parse_events
from .params import Params
from .utils.runinfo import card_name_and_power


def _kernel_ms(eng, gi, qrows, dev, reps=3):
    """Mean kernel ms of one dispatch (prep outside the timed region)."""
    cfg = eng.cfg
    q_rows, dsz = qrows
    qbuf, cand, nh, _ = ce.query_prep(q_rows, dsz, gi.ptab, eng.LqP,
                                      cfg.mal, cfg.msl, eng.CNT_CAP)
    args = (gi.refbuf, qbuf, gi.poslist, cand, nh, gi.win, dsz.contiguous(),
            gi.nrs, cfg, eng.EV_CAP)
    parse_events(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = parse_events(*args)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--seed", type=int, default=2024)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dispatch_probe: no CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    smi = card_name_and_power()
    _, codes = synth.viral_set(seed=a.seed, n=a.n)
    params = Params()
    eng = ce.CudaAll2All(codes, params, devices=[dev])
    full = (eng.Q[dev][:eng.B], eng.DSZ[dev][:eng.B])

    for G in (4, 8, 16):
        gi = eng.build_group_index(list(range(G)), dev)
        ms, out = _kernel_ms(eng, gi, full, dev)
        print(f"G={G} B={eng.B}: {ms:.1f} ms, {ms / (G * eng.B):.3f} ms "
              f"per pair [{smi}]", flush=True)
        if G == 4:
            gi4, nev4 = gi, out[1].cpu().numpy()
    ms, _ = _kernel_ms(eng, gi4, (full[0][:64], full[1][:64]), dev)
    print(f"G=4 B=64: {ms:.1f} ms [{smi}]", flush=True)

    for flat in np.argsort(nev4, axis=None)[::-1][:3]:
        g, b = np.unravel_index(flat, nev4.shape)
        gi = eng.build_group_index([int(g)], dev)
        ms, _ = _kernel_ms(eng, gi, eng.gather_qrows([int(b)], dev), dev)
        print(f"pair ({g},{b}) alone: {len(codes[g])} x {len(codes[b])} bp, "
              f"{nev4[g, b]} events, {ms:.1f} ms [{smi}]", flush=True)

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
