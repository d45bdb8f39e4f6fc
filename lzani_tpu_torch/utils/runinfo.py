"""What the port's measurement scripts print beside their numbers
(``chip_smoke.py``, ``ab_cli.py``, ``dispatch_probe.py``)."""

from __future__ import annotations

import subprocess


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
