"""What the port's measurement scripts print beside their numbers
(``chip_smoke.py``, ``ab_cli.py``, ``dispatch_probe.py``): the card, the
CLI's phase timings, and a parse launch's bound."""

from __future__ import annotations

import subprocess

#: the card's peaks (NVIDIA's H100 SXM data sheet): HBM bytes/s, and the
#: non-tensor float32 rate, the sheet's closest entry for the kernels'
#: int32 compares
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12


def card_name_and_power() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (the
    first card's line). Raises when nvidia-smi fails."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cli_timings(stderr: str) -> str:
    """'label s, ...' from the 'Timings' block that a ``-V 2`` run of the
    CLI writes to stderr."""
    tail = stderr.split("Timings", 1)[-1].splitlines()
    items = [ln.rsplit(" : ", 1) for ln in tail if " : " in ln]
    return ", ".join(f"{lab} {float(v.rstrip('s')):.2f} s"
                     for lab, v in items if lab)


def launch_bound_ms(args, nev, dsz_pairs):
    """(ms, 'bytes' or 'operations'): the least time the card could take
    for one parse launch (the arguments of ``parse_events`` or
    ``parse_events_big``, its output counts `nev` and the (G, B) query
    lengths `dsz_pairs`), counting what this launch's pairs need. A pair
    is live when its dsz exceeds msl (self pairs and padding rows do
    nothing). Bytes, each read or written once: per live pair the first
    dsz positions of its candidate plane(s) and of next_hit; per query
    with a live pair its longest dsz symbols; per reference with a live
    pair its nr symbols, nr entries of its position list and its WIN
    table; the dsz and nr inputs; every defined event record (32 B) and
    nev. Operations: one symbol comparison per query position of every
    live pair, at least."""
    import torch

    refbuf, qbuf, poslist, cand, next_hit, win, _, nrs, cfg = args[:9]
    dsz = dsz_pairs.long().cpu()
    live = dsz > cfg.msl
    d = torch.where(live, dsz, 0)
    planes = cand.numel() // next_hit.numel()   # 1 packed, or start + count
    ref_live = live.any(dim=1)
    nr = nrs.long().cpu()[ref_live]
    nbytes = (int(d.sum()) * 4 * (planes + 1)
              + int(d.max(dim=0).values.sum()) * qbuf.element_size()
              + int(nr.sum()) * refbuf.element_size()
              + int(nr.clamp(max=poslist.shape[1]).sum())
              * poslist.element_size()
              + int(ref_live.sum()) * win.shape[1] * win.element_size()
              + (dsz.numel() + nrs.numel()) * 4
              + int(nev.clamp(min=0).sum()) * 32 + nev.numel() * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = int(d.sum()) / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
