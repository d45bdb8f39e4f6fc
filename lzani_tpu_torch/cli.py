"""Command-line interface of the port, flag-compatible with the reference
lz-ani (lz-ani.cpp:105-336): the port's own copy of ``lzani_tpu/cli.py``
with ``--backend native|cuda|hybrid|auto`` (auto = hybrid, as in the JAX
package). ``cuda`` and ``hybrid`` without a CUDA device exit 1; they never
run on the CPU in the card's place. The CLI checks for the card through
libcuda, without torch (``utils.cudadev``).

A multi-process launch runs the same command in every process, with the
JAX package's variables set: ``JAX_COORDINATOR_ADDRESS`` (host:port of
process 0), ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``. Each process
computes its share of the reference rows on its own card, and process 0
writes the outputs (``matcher.py``, ``parallel/distributed.py``).

    python -m lzani_tpu_torch all2all --in-fasta x.fna --out x.tsv \\
        [--out-alignment x.aln.tsv] [-t N] [--backend hybrid]
"""

from __future__ import annotations

import os
import sys

from . import VERSION_STRING, __version__
from .matcher import Matcher
from .params import ParamError, Params

BACKENDS = ("native", "cuda", "hybrid", "auto")

USAGE = """\
{info}
Tool for rapid determination of similarities among sets of DNA sequences
Usage:
python -m lzani_tpu_torch <mode> [options]
Modes:
  all2all                        - all to all
Options - input specification:
      --in-fasta <file_name>     - FASTA file (for multisample-fasta mode)
      --in-txt <file_name>       - text file with FASTA file names
      --in-dir <path>            - directory with FASTA files
      --multisample-fasta <bool> - multi sample FASTA input (default: true)
      --flt-kmerdb <fn> <float>  - filtering file (kmer-db output) and threshold
Options - output specification:
  -o, --out <file_name>          - output file name
      --out-ids <file_name>      - output file name for ids file (optional)
      --out-alignment <file_name>- output file name for alignments (optional)
      --out-in-percent <bool>    - output in percent (default: false)
      --out-type <type>          - tsv | single-txt (default: tsv)
      --out-format <list>        - comma-separated columns or meta-names
                                   (standard, lite, complete; default: standard)
      --out-filter <par> <float> - keep only results with <par> >= <float>
Options - LZ-parsing-related:
  -a, --mal <int>                - min. anchor length (default: 11)
  -s, --msl <int>                - min. seed length (default: 7)
  -r, --mrd <int>                - max. dist. between approx. matches in reference (default: 40)
  -q, --mqd <int>                - max. dist. between approx. matches in query (default: 40)
  -g, --reg <int>                - min. considered region length (default: 35)
      --aw <int>                 - approx. window length (default: 15)
      --am <int>                 - max. no. of mismatches in approx. window (default: 7)
      --ar <int>                 - min. length of run ending approx. extension (default: 3)
Options - other:
  -t, --threads <int>            - no of threads; 0 means auto-detect (default: 0)
  -V, --verbose <int>            - verbosity level (default: 1)
      --backend <name>           - compute backend: native | cuda | hybrid | auto
                                   (default: auto = hybrid: the native pool and
                                   the CUDA engine share one row queue)
Multi-process launch (every process runs the same command; one process per
card; process 0 writes the outputs): set JAX_COORDINATOR_ADDRESS=<host:port>,
JAX_NUM_PROCESSES=<n> and JAX_PROCESS_ID=<0..n-1> in each process's environment
"""



def parse_args(argv: list[str]) -> Params | None:
    if len(argv) == 1 and argv[0] == "--version":
        print(__version__, file=sys.stderr)
        return None
    if len(argv) < 2:
        print(USAGE.format(info=VERSION_STRING), file=sys.stderr)
        raise SystemExit(0)
    if argv[0] != "all2all":
        print(f"Unknown mode: {argv[0]}", file=sys.stderr)
        raise SystemExit(1)

    p = Params(backend="hybrid")
    i = 1

    while i < len(argv):
        a = argv[i]
        try:
            if a == "--in-txt" and i + 1 < len(argv):
                # missing file: the reference's load_input_names prints a
                # clean message and bails (lz-ani.cpp:88-102,134-138)
                try:
                    with open(argv[i + 1]) as fh:
                        p.input_file_names = fh.read().split()
                except OSError:
                    print(f"Cannot open file: {argv[i + 1]}",
                          file=sys.stderr)
                    raise SystemExit(1)
                i += 2
            elif a == "--in-dir" and i + 1 < len(argv):
                d = argv[i + 1]
                if not os.path.isdir(d):
                    print(f"Non-existing directory: {d}", file=sys.stderr)
                    raise SystemExit(1)
                p.input_file_names = sorted(
                    os.path.join(d, f) for f in os.listdir(d))
                i += 2
            elif a == "--in-fasta" and i + 1 < len(argv):
                p.input_file_names = [argv[i + 1]]
                i += 2
            elif a in ("-o", "--out") and i + 1 < len(argv):
                p.output_file_name = argv[i + 1]
                i += 2
            elif a == "--out-ids" and i + 1 < len(argv):
                p.output_ids_file_name = argv[i + 1]
                i += 2
            elif a == "--out-alignment" and i + 1 < len(argv):
                p.output_alignment_file_name = argv[i + 1]
                i += 2
            elif a in ("-t", "--threads") and i + 1 < len(argv):
                p.no_threads = int(argv[i + 1])
                i += 2
            elif a in ("-s", "--msl") and i + 1 < len(argv):
                p.min_seed_len = int(argv[i + 1])
                i += 2
            elif a in ("-a", "--mal") and i + 1 < len(argv):
                p.min_anchor_len = int(argv[i + 1])
                i += 2
            elif a in ("-r", "--mrd") and i + 1 < len(argv):
                p.max_dist_in_ref = int(argv[i + 1])
                i += 2
            elif a in ("-q", "--mqd") and i + 1 < len(argv):
                p.max_dist_in_query = int(argv[i + 1])
                i += 2
            elif a in ("-g", "--reg") and i + 1 < len(argv):
                p.min_region_len = int(argv[i + 1])
                i += 2
            elif a == "--aw" and i + 1 < len(argv):
                p.approx_window = int(argv[i + 1])
                i += 2
            elif a == "--am" and i + 1 < len(argv):
                p.approx_mismatches = int(argv[i + 1])
                i += 2
            elif a == "--ar" and i + 1 < len(argv):
                p.approx_run_len = int(argv[i + 1])
                i += 2
            elif a == "--flt-kmerdb" and i + 2 < len(argv):
                p.filter_file_name = argv[i + 1]
                p.filter_thr = float(argv[i + 2])
                i += 3
            elif a in ("-V", "--verbose") and i + 1 < len(argv):
                p.verbosity_level = int(argv[i + 1])
                i += 2
            elif a == "--out-type" and i + 1 < len(argv):
                t = argv[i + 1]
                if t == "single-txt":
                    p.output_type = "single_txt"
                elif t == "tsv":
                    p.output_type = "two_tsv"
                else:
                    print(f"Unknown output-type: {t}", file=sys.stderr)
                    raise SystemExit(1)
                i += 2
            elif a == "--out-format" and i + 1 < len(argv):
                p.parse_output_format(argv[i + 1])
                i += 2
            elif a == "--out-filter" and i + 2 < len(argv):
                p.set_output_filter(argv[i + 1], argv[i + 2])
                i += 3
            elif a == "--multisample-fasta" and i + 1 < len(argv):
                p.multisample_fasta = _parse_bool(a, argv[i + 1])
                i += 2
            elif a == "--out-in-percent" and i + 1 < len(argv):
                p.output_in_percent = _parse_bool(a, argv[i + 1])
                i += 2
            elif a == "--backend" and i + 1 < len(argv):
                if argv[i + 1] not in BACKENDS:
                    print(f"Unknown backend: {argv[i + 1]} (choose from "
                          f"{', '.join(BACKENDS)})", file=sys.stderr)
                    raise SystemExit(1)
                # auto means hybrid
                p.backend = "hybrid" if argv[i + 1] == "auto" else argv[i + 1]
                i += 2
            else:
                print(f"Unknown parameter: {a}", file=sys.stderr)
                print(USAGE.format(info=VERSION_STRING), file=sys.stderr)
                raise SystemExit(1)
        except ParamError as e:
            print(str(e), file=sys.stderr)
            raise SystemExit(1)

    if not p.input_file_names:
        print("Input file names not provided", file=sys.stderr)
        raise SystemExit(1)
    return p


def _parse_bool(flag: str, val: str) -> bool:
    if val == "true":
        return True
    if val == "false":
        return False
    print(f"Unknown value for {flag}: {val}", file=sys.stderr)
    raise SystemExit(1)


def run(argv: list[str], device=None):
    """Parse `argv` and run it: (exit code, the Matcher or None).
    `device` None means the current CUDA device for ``--backend cuda`` and
    ``hybrid``."""
    params = parse_args(argv)
    if params is None:
        return 0, None
    if params.backend != "native" and device is None:
        # libcuda, not torch: the hybrid imports torch only once its
        # warm-up starts
        from .utils import cudadev

        if cudadev.cuda_device_count() == 0:
            print(f"lz-ani-torch: --backend {params.backend} needs a CUDA "
                  f"device and none is available (use --backend native to "
                  f"run on the CPU)", file=sys.stderr)
            return 1, None
    m = Matcher(params, device=device)
    return (0 if m.run_all2all() else 1), m


def main(argv: list[str] | None = None) -> int:
    return run(sys.argv[1:] if argv is None else argv)[0]


if __name__ == "__main__":
    sys.exit(main())
