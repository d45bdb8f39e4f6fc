"""What the port's measurement scripts print beside their numbers
(``chip_smoke.py``, ``dispatch_probe.py``): the card, the
CLI's phase timings and engine counters, and the bounds of a parse
launch and of a fold launch."""

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


def sm_clock_mhz() -> list[int]:
    """The first card's SM clock now and at most (MHz), as ``nvidia-smi
    --query-gpu=clocks.sm,clocks.max.sm`` prints them."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return [int(v) for v in res.stdout.splitlines()[0].split(",")]


def ptxas_lines(report: str) -> list[str]:
    """'kernel: ptxas line' for each register/shared-memory and spill line
    of an nvcc ``-Xptxas -v`` report (``build.build_report``), the
    kernel's mangled name cut to its own name (and its template
    argument)."""
    out, kern = [], None
    for ln in report.splitlines():
        if "Compiling entry function" in ln or "Function properties for" in ln:
            name = ln.split("'")[1] if "'" in ln else ln.split()[-1]
            kern = name
            for short in ("parse_group_kernel", "parse_big_kernel",
                          "pack_planes_kernel", "fold_kernel",
                          "fold_stats"):
                if short in name:
                    kern = short + ("<true>" if "ILb1E" in name else
                                    "<false>" if "ILb0E" in name else "")
        elif kern and ("Used" in ln or "spill" in ln):
            out.append(f"{kern}: {ln.split(':', 1)[-1].strip()}")
    return out


def cli_timings(stderr: str) -> str:
    """'label s, ...' from the 'Timings' block that a ``-V 2`` run of the
    CLI writes to stderr."""
    tail = stderr.split("Timings", 1)[-1].splitlines()
    items = [ln.rsplit(" : ", 1) for ln in tail if " : " in ln]
    return ", ".join(f"{lab} {float(v.rstrip('s')):.2f} s"
                     for lab, v in items if lab)


def engine_stats(stderr: str) -> dict | None:
    """The engine counters that a ``-V 2`` cuda or hybrid run of the CLI
    writes to stderr (its 'lz-ani-torch engine: {...}' line), or None."""
    import json

    for ln in stderr.splitlines():
        if ln.startswith("lz-ani-torch engine: "):
            return json.loads(ln.split(": ", 1)[1])
    return None


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


def fold_bound_ms(ev, nev, n_refs: int, n_queries: int, nfac=None):
    """(ms, 'bytes' or 'operations'): the least time the card could take
    for one ``fold_stats`` launch over the logs `ev` (G, B, evc, 8) and
    `nev` (G, B) (a pair with nev < 0 is skipped), with `nfac` (G, B)
    when the launch writes the factors. Bytes, each read or written once:
    every defined event record (32 B) and nev; the reference and query
    symbols of each event's extensions (bwd + ext, 1 B each: the aligned
    ranges the fold compares symbol by symbol); the dsz and nr inputs;
    the stats, status and factor count of every pair, and the factors
    (16 B each) when written. Operations: one symbol comparison per
    aligned symbol."""
    import torch

    n = nev.long().cpu().clamp(min=0)
    evh = ev.cpu()
    defined = (torch.arange(evh.shape[2])[None, None, :] < n[..., None])
    aligned = int((evh[..., 3].long() + evh[..., 4].long())[defined].sum())
    nbytes = (int(n.sum()) * 32 + nev.numel() * 4 + 2 * aligned
              + (n_refs + n_queries) * 4 + nev.numel() * (12 + 4 + 4)
              + (int(nfac.long().sum()) * 16 if nfac is not None else 0))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = aligned / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
