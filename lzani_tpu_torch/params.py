"""Run configuration of the port (a copy of ``lzani_tpu/params.py``).

Field-for-field equivalent of the reference's ``CParams``
(reference src/params.h:31-212): same defaults, the same output-format
mini-grammar with meta-name expansion (params.h:169-198), and the same
output-filter registry (params.h:200-211).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

# Column identifiers (reference: output_component_t, params.h:29)
OUTPUT_COMPONENTS = (
    "query", "reference", "qidx", "ridx", "qlen", "rlen",
    "tani", "gani", "ani", "qcov", "rcov", "len_ratio",
    "nt_match", "nt_mismatch", "num_alns",
)

# Filterable columns (reference: comp_flt_id, params.h:89-95)
FILTER_COMPONENTS = ("tani", "gani", "ani", "qcov", "rcov")

# Meta-names expanded inside --out-format (reference: std_comp, params.h:65-69)
META_FORMATS = {
    "complete": "qidx,ridx,query,reference,tani,gani,ani,qcov,rcov,num_alns,"
                "len_ratio,qlen,rlen,nt_match,nt_mismatch",
    "standard": "qidx,ridx,query,reference,tani,gani,ani,qcov,num_alns,len_ratio",
    "lite": "qidx,ridx,tani,gani,ani,qcov,num_alns,len_ratio",
}


class ParamError(ValueError):
    pass


@dataclass
class Params:
    # LZ-parse tunables (reference defaults: params.h:38-45)
    min_anchor_len: int = 11       # --mal
    min_seed_len: int = 7          # --msl
    max_dist_in_ref: int = 40      # --mrd
    max_dist_in_query: int = 40    # --mqd
    min_region_len: int = 35       # --reg
    approx_window: int = 15        # --aw
    approx_mismatches: int = 7     # --am
    approx_run_len: int = 3        # --ar

    multisample_fasta: bool = True
    filter_file_name: str = ""
    filter_thr: float = 0.0

    output_in_percent: bool = False
    output_type: str = "two_tsv"   # "two_tsv" | "single_txt"
    output_format: str = "standard"
    output_components: list[str] = field(default_factory=list)
    output_filter: dict[str, float] = field(default_factory=dict)

    input_file_names: list[str] = field(default_factory=list)
    output_file_name: str = ""
    output_ids_file_name: str = ""
    output_alignment_file_name: str = ""

    no_threads: int = 0
    verbosity_level: int = 1

    # Engine selection: "native" (C++ host engine), "cuda" (the CUDA
    # device engine), "hybrid" (both on one row queue), or "auto" (=
    # hybrid).
    backend: str = "auto"

    def __post_init__(self) -> None:
        if not self.output_components:
            self.parse_output_format(self.output_format)

    def parse_output_format(self, of: str) -> None:
        comps: list[str] = []
        for tok in _split(of, ","):
            expanded = META_FORMATS.get(tok)
            if expanded is not None:
                comps.extend(_split(expanded, ","))
            else:
                comps.append(tok)
        for c in comps:
            if c not in OUTPUT_COMPONENTS:
                raise ParamError(f"Unknown output-format component: {c}")
        # reference quirk: CParams::parse_output_format never writes the
        # output_format STRING member (params.h:169-198), so the single-txt
        # params dump always shows the default. Keep components updated but
        # leave the dump string untouched for byte parity.
        self.output_components = comps

    def set_output_filter(self, name: str, value: str | float) -> None:
        if name not in FILTER_COMPONENTS:
            raise ParamError(f"Unknown output-filter component: {name}")
        self.output_filter[name] = float(value)

    def adjust_threads(self) -> None:
        if self.no_threads == 0:
            self.no_threads = os.cpu_count() or 1

    def params_dump(self) -> str:
        """The ``[params]`` block embedded in single-txt output
        (reference: CParams::str(), params.h:126-157)."""
        lines = [
            "[params]",
            f"min_anchor_len             : {self.min_anchor_len}",
            f"min_seed_len               : {self.min_seed_len}",
            f"max_dist_in_ref            : {self.max_dist_in_ref}",
            f"max_dist_in_query          : {self.max_dist_in_query}",
            f"min_region_len             : {self.min_region_len}",
            f"approx_window              : {self.approx_window}",
            f"approx_mismatches          : {self.approx_mismatches}",
            f"approx_run_len             : {self.approx_run_len}",
            f"multisample_fasta          : {_cbool(self.multisample_fasta)}",
            f"filter_thr                 : {_cdouble(self.filter_thr)}",
            f"output_format              : {self.output_format}",
            f"output_in_percent          : {_cbool(self.output_in_percent)}",
            f"no_threads                 : {self.no_threads}",
            f"output_file_name           : {self.output_file_name}",
            f"output_ids_file_name       : {self.output_ids_file_name}",
            # reference prints the ids name under the alignment label (params.h:149)
            f"output_alignment_file_name : {self.output_ids_file_name}",
            f"filter_file_name           : {self.filter_file_name}",
            "input_file_names           : " + ", ".join(self.input_file_names),
        ]
        return "\n".join(lines) + "\n"


def _split(s: str, sep: str) -> list[str]:
    """Reference ``split`` (utils.cpp:16-37): drops a trailing empty token only."""
    parts: list[str] = []
    cur = ""
    for ch in s:
        if ch == sep:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    if cur:
        parts.append(cur)
    return parts


def _cbool(b: bool) -> str:
    return "true" if b else "false"


def _cdouble(v: float) -> str:
    # iostream default formatting for double (6 significant digits)
    return f"{v:g}"
