"""The control of the check: the plain reference put in the program's
place, computed in the precision below the one LZ-ANI states (float32
for its doubles: the anchor-against-seed decision of the parse and the
ratios of the TSV). Its lines go through the same comparison
(``check.compare_job``) as a run's; it must come out as not correct.

    python benchmark/control.py --workload <cell> --seeds 1 2 3

For each seed it builds the cell's two collections at the cell's size,
draws the check's samples as a run does, and prints the comparison's
numbers for the control and the seconds the reference and the control
took. The benchmark's own runs do not run it; it needs no card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import check, generate, harness  # noqa: E402
from benchmark.reference import tsv  # noqa: E402


def control_tsv(ref: check.Collection, ctl: check.Collection) -> list[str]:
    """The TSV the control puts in the program's place: every line's keys
    as the reference orders them, and the control's lines where the
    sample asks for values."""
    lines = [ctl.header()]
    names = ref.names
    for r, q in tsv.key_columns(ref.n).tolist():
        lines.append(f"{q}\t{r}\t{names[q]}\t{names[r]}\t\n")
    for (r, q), pair in ctl.expected.items():
        k = 1 + tsv.line_index(ref.n, r, q)
        lines[k:k + 2] = pair
    return lines


def control_numbers(cell: dict, seed: int, real: str = "float32") -> dict:
    """The comparison's numbers of the reference computed in `real`, put
    in the program's place, on `seed`'s two collections, summed, with the
    seconds each side took. In ``float64`` it is the reference itself."""
    config, traffic = cell["config"], cell["traffic"]
    cfg = check.lz_cfg(config["params"])
    comps = tsv.FORMATS[config["output"]["format"]]
    workers = min(int(config["check"].get("workers", 1)),
                  os.cpu_count() or 1)
    refs, ctls = [], []
    for c in (0, 1):
        names, codes, fam = generate.collection(seed, c,
                                                config["collection"], traffic)
        sample = check.sample_of(seed, c, fam, codes, config["check"])
        refs.append(check.Collection(names, codes, cfg, sample, comps))
        ctls.append(check.Collection(names, codes, cfg, sample, comps,
                                     real))
    secs = {}
    for side, cols in (("reference_s", refs), ("control_s", ctls)):
        t = time.perf_counter()
        check.compute_all(cols, workers)
        secs[side] = time.perf_counter() - t
    nums = dict.fromkeys(check.LIMITS, 0)
    for ref, ctl in zip(refs, ctls):
        got = check.compare_job(ref, control_tsv(ref, ctl), ctl.ids_lines())
        for k, v in got.items():
            nums[k] += v
    return {**nums, **secs, "pairs": sum(len(r.sample) for r in refs)}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = harness.load_cell(harness.ROOT, args.workload)
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": "float32",
                          **control_numbers(cell, seed)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
