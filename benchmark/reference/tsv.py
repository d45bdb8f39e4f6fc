"""The plain version of what LZ-ANI writes: the reorder, the ids file and
the lines of the results TSV (refresh-bio/LZ-ANI seq_reservoir.cpp:215-251,
lz_matcher.cpp:280-541).

``format_real`` is a frozen copy of ``lzani_tpu_torch/utils/textnum.py``
as of commit 42336e4 (the reference tool's ``real_to_pchar``: the shortest
decimal digits, rounded half up to `prec` significant digits). Nothing
here imports the program.

``real`` is the floating-point type of the ratios (``float``, double as
published, or ``np.float32`` for the benchmark's lower-precision
control).
"""

from __future__ import annotations

import math

import numpy as np

_POW10 = tuple(10**i for i in range(20))


def _shortest_decimal(val: float) -> tuple[int, int]:
    s = repr(float(val))
    if "e" in s or "E" in s:
        mant, _, exp_s = s.lower().partition("e")
        exp10 = int(exp_s)
    else:
        mant, exp10 = s, 0
    if "." in mant:
        int_part, _, frac = mant.partition(".")
        digits = int_part + frac
        exp10 -= len(frac)
    else:
        digits = mant
    sig = int(digits)
    while sig and sig % 10 == 0:
        sig //= 10
        exp10 += 1
    return sig, exp10


def format_real(val: float, prec: int = 6) -> str:
    """A double as ``refresh::real_to_pchar(val, out, prec)`` renders it."""
    if val == 0:
        return "0"
    if math.isnan(val):
        return "nan"
    if math.isinf(val):
        return "-inf" if val < 0 else "inf"
    prec = min(max(prec, 1), 15)
    neg = val < 0
    sig, exp10 = _shortest_decimal(abs(val))
    n_dig = len(str(sig))
    if n_dig > prec:
        drop = n_dig - prec
        sig = (sig + _POW10[drop] // 2) // _POW10[drop]
        exp10 += drop
        n_dig = prec
        if sig >= _POW10[prec]:
            sig //= 10
            exp10 += 1
    digits = str(sig)
    if exp10 == 0:
        body = digits
    elif exp10 > 0 or -exp10 >= n_dig + 4:
        if n_dig == 1:
            mant, e = digits, exp10
        else:
            mant, e = digits[0] + "." + digits[1:], exp10 + n_dig - 1
        body = f"{mant}e{'-' if e < 0 else '+'}{abs(e):02d}"
    elif -exp10 < n_dig:
        dot = n_dig + exp10
        body = digits[:dot] + "." + digits[dot:]
    else:
        body = "0." + "0" * (-exp10 - n_dig) + digits
    return "-" + body if neg else body


STANDARD = ("qidx", "ridx", "query", "reference", "tani", "gani", "ani",
            "qcov", "num_alns", "len_ratio")
#: column lists of the output formats (LZ-ANI params.h:65-69)
FORMATS = {"standard": STANDARD}


def reorder(names, lengths) -> list[int]:
    """Old ids in the order the tool numbers them: longest first, then
    by name (as bytes), then by input order."""
    return sorted(range(len(names)),
                  key=lambda i: (-(lengths[i] - 2), names[i].encode("latin-1"),
                                 i))


def ids_lines(names, lengths) -> list[str]:
    """The ids file of genomes already in the tool's order."""
    return ["id\tseq_len\tno_parts\n"] + [
        f"{n}\t{ln}\t1\n" for n, ln in zip(names, lengths)]


def pair_lines(r: int, q: int, names, lengths, t_qr, t_rq,
               comps=STANDARD, real=float) -> list[str]:
    """The two TSV lines of the pair {r, q}, r < q, in the tool's ids:
    first with q as query and r as reference, then swapped. `t_qr` is the
    (matches, literals, components) triple of query q parsed against
    reference r, `t_rq` the other way round."""
    ln = (lengths[q], lengths[r])
    si_mat, si_lit, no_reg = (t_qr[0], t_rq[0]), (t_qr[1], t_rq[1]), \
        (t_qr[2], t_rq[2])
    R = real
    tani = R(si_mat[0] + si_mat[1]) / R(ln[0] + ln[1])
    gani = [R(si_mat[k]) / R(ln[k]) for k in (0, 1)]
    ani = [R(si_mat[k]) / R(si_mat[k] + si_lit[k]) if si_mat[k] + si_lit[k]
           else R(0.0) for k in (0, 1)]
    cov = [R(si_mat[k] + si_lit[k]) / R(ln[k]) for k in (0, 1)]
    if ln[0] and ln[1]:
        ratio = R(ln[0]) / R(ln[1]) if ln[0] < ln[1] else R(ln[1]) / R(ln[0])
        ratio_s = format_real(float(ratio), 4)
    else:
        ratio_s = "0"
    ids, nm = (r, q), (names[r], names[q])
    out = []
    for i in (0, 1):
        j = 1 - i
        col = {"ridx": str(ids[i]), "qidx": str(ids[j]),
               "reference": nm[i], "query": nm[j],
               "qcov": format_real(float(cov[i]), 6),
               "rcov": format_real(float(cov[j]), 6),
               "gani": format_real(float(gani[i]), 6),
               "rlen": str(ln[j]), "qlen": str(ln[i]),
               "len_ratio": ratio_s,
               "ani": format_real(float(ani[i]), 6),
               "num_alns": str(no_reg[i]),
               "nt_mismatch": str(si_lit[i]), "nt_match": str(si_mat[i]),
               "tani": format_real(float(tani), 6)}
        out.append("\t".join(col[c] for c in comps) + "\n")
    return out


def line_index(n: int, r: int, q: int) -> int:
    """Index, among the TSV's data lines, of the first line of pair {r, q}
    (r < q) in a dense all-vs-all of `n` genomes: rows by r, then q."""
    before = r * (n - 1) - r * (r - 1) // 2      # pairs of rows < r
    return 2 * (before + (q - r - 1))


def key_columns(n: int) -> np.ndarray:
    """(ridx, qidx) of every data line of a dense all-vs-all, in order."""
    r, q = np.triu_indices(n, 1)
    out = np.empty((2 * len(r), 2), np.int64)
    out[0::2, 0], out[0::2, 1] = r, q
    out[1::2, 0], out[1::2, 1] = q, r
    return out
