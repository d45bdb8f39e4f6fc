"""Scoring and output emission.

Reproduces the reference's ``store_results`` / ``store_alignment``
(reference src/lz_matcher.cpp:102-169, 280-579) byte-for-byte:

  * measures per unordered pair {r, q} with q > r, two lines (i=0: query=q,
    reference=r; i=1 swapped), rows ordered by reference id then query id
  * tani  = (m0+m1)/(len0+len1); gani_i = m_i/len_i; ani_i = m_i/(m_i+l_i);
    cov_i = (m_i+l_i)/len_i                     (lz_matcher.cpp:442-447)
  * --out-filter gates per direction            (:451-463)
  * floats at 6 significant digits, len_ratio at 4 (:488-541)
  * ids file "id\tseq_len\tno_parts"            (:341-346)
  * alignment TSV with RC coordinate back-map   (:102-169)
"""

from __future__ import annotations

from .utils.textnum import format_int, format_real

ALN_HEADER = ("query\treference\tpident\talnlen\tqstart\tqend\t"
              "rstart\trend\tnt_match\tnt_mismatch\n")


class ResultMatrix:
    """Directed parse results: row r holds, per query q, the triple from
    parsing query q against reference r (mirrors ``results`` in
    lz_matcher.cpp:178,255)."""

    def __init__(self, n: int):
        self.n = n
        self._dense = None
        self._rows: list[list[tuple[int, int, int, int]]] | None = None
        self._first: list[dict[int, tuple[int, int, int]]] | None = None

    @classmethod
    def from_dense(cls, triples) -> "ResultMatrix":
        rm = cls(triples.shape[0])
        rm._dense = triples
        return rm

    @classmethod
    def from_csr(cls, n, indptr, ids, triples) -> "ResultMatrix":
        rm = cls(n)
        rm._rows = [[] for _ in range(n)]
        rm._first = [{} for _ in range(n)]
        for r in range(n):
            row = rm._rows[r]
            for e in range(int(indptr[r]), int(indptr[r + 1])):
                q = int(ids[e])
                t = (int(triples[e, 0]), int(triples[e, 1]), int(triples[e, 2]))
                row.append((q, *t))
            row.sort(key=lambda x: x[0])  # res_row sort, lz_matcher.cpp:253
            for q, m, l, c in row:
                rm._first[r].setdefault(q, (m, l, c))
        return rm

    def row_entries_above(self, r: int):
        """Entries with q > r, ascending (duplicates preserved)."""
        if self._dense is not None:
            d = self._dense
            for q in range(r + 1, self.n):
                t = d[r, q - 1]
                yield q, int(t[0]), int(t[1]), int(t[2])
        else:
            for ent in self._rows[r]:
                if ent[0] > r:
                    yield ent

    def first(self, r: int, q: int) -> tuple[int, int, int]:
        if self._dense is not None:
            t = self._dense[r, q - 1 if q > r else q]
            return int(t[0]), int(t[1]), int(t[2])
        return self._first[r][q]


def _store_lengths(store) -> list[int]:
    """Symbol lengths without unpacking the packed store (O(1) per item)."""
    ls = getattr(store, "lengths", None)
    return list(ls) if ls is not None else [len(c) for c in store.codes]


def ids_file_lines(store, mrd: int) -> list[str]:
    lines = ["id\tseq_len\tno_parts\n"]
    for name, slen, parts in zip(store.names, _store_lengths(store),
                                 store.no_parts):
        seq_len = slen - (parts - 1) * mrd
        lines.append(f"{name}\t{seq_len}\t{parts}\n")
    return lines


def derive_ids_path(out_path: str) -> str:
    """Default ids file name: insert ".ids" before the extension
    (lz_matcher.cpp:295-302)."""
    p = out_path.rfind(".")
    if p < 0:
        return out_path + ".ids"
    return out_path[:p] + ".ids" + out_path[p:]


def results_tsv_lines(params, store, rm: ResultMatrix) -> list[str]:
    comps = params.output_components
    mult = 100.0 if params.output_in_percent else 1.0
    flt = params.output_filter
    has_flt = bool(flt)
    f_gani = flt.get("gani", 0.0)
    f_ani = flt.get("ani", 0.0)
    f_tani = flt.get("tani", 0.0)
    f_qcov = flt.get("qcov", 0.0)
    f_rcov = flt.get("rcov", 0.0)

    mrd = params.max_dist_in_ref
    names = store.names
    lens = [sl - (p - 1) * mrd
            for sl, p in zip(_store_lengths(store), store.no_parts)]

    lines = ["\t".join(comps) + "\n"]

    for r in range(rm.n):
        for q, qm, ql, qc in rm.row_entries_above(r):
            pm, pl, pc = rm.first(q, r)

            ids = (r, q)
            nm = (names[r], names[q])
            # index 0 = direction (query=q vs reference=r): lz_matcher.cpp:433-447
            ln = (lens[q], lens[r])
            si_mat = (qm, pm)
            si_lit = (ql, pl)
            no_reg = (qc, pc)

            tani = (si_mat[0] + si_mat[1]) / (ln[0] + ln[1])
            gani = (si_mat[0] / ln[0], si_mat[1] / ln[1])
            ani = (si_mat[0] / (si_mat[0] + si_lit[0]) if si_mat[0] + si_lit[0] else 0.0,
                   si_mat[1] / (si_mat[1] + si_lit[1]) if si_mat[1] + si_lit[1] else 0.0)
            cov = ((si_mat[0] + si_lit[0]) / ln[0],
                   (si_mat[1] + si_lit[1]) / ln[1])

            if ln[0] and ln[1]:
                len_ratio = ln[0] / ln[1] if ln[0] < ln[1] else ln[1] / ln[0]
                len_ratio_s = format_real(len_ratio, 4)
            else:
                len_ratio_s = "0"

            for i in (0, 1):
                j = 1 - i
                if has_flt:
                    if gani[i] < f_gani or ani[i] < f_ani or tani < f_tani \
                            or cov[i] < f_qcov or cov[j] < f_rcov:
                        continue
                cols = []
                for oc in comps:
                    if oc == "ridx":
                        cols.append(format_int(ids[i]))
                    elif oc == "qidx":
                        cols.append(format_int(ids[j]))
                    elif oc == "reference":
                        cols.append(nm[i])
                    elif oc == "query":
                        cols.append(nm[j])
                    elif oc == "qcov":
                        cols.append(format_real(mult * cov[i], 6))
                    elif oc == "rcov":
                        cols.append(format_real(mult * cov[j], 6))
                    elif oc == "gani":
                        cols.append(format_real(mult * gani[i], 6))
                    elif oc == "rlen":
                        cols.append(format_int(ln[j]))
                    elif oc == "qlen":
                        cols.append(format_int(ln[i]))
                    elif oc == "len_ratio":
                        cols.append(len_ratio_s)
                    elif oc == "ani":
                        cols.append(format_real(mult * ani[i], 6))
                    elif oc == "num_alns":
                        cols.append(format_int(no_reg[i]))
                    elif oc == "nt_mismatch":
                        cols.append(format_int(si_lit[i]))
                    elif oc == "nt_match":
                        cols.append(format_int(si_mat[i]))
                    elif oc == "tani":
                        cols.append(format_real(mult * tani, 6))
                lines.append("\t".join(cols) + "\n")

    return lines


def single_txt_lines(params, store, rm: ResultMatrix) -> list[str]:
    """The --out-type single-txt format (lz_matcher.cpp:321-338, 420-430)."""
    mrd = params.max_dist_in_ref
    lines = [params.params_dump()]
    lines.append("[no_input_sequences]\n")
    lines.append(f"{len(store)}\n")
    lines.append("[input_sequences]\n")
    for name, slen, parts in zip(store.names, _store_lengths(store),
                                 store.no_parts):
        lines.append(f"{name} {slen - (parts - 1) * mrd} {parts}\n")
    lines.append("[lz_similarities]\n")
    for r in range(rm.n):
        for q, qm, ql, qc in rm.row_entries_above(r):
            pm, pl, pc = rm.first(q, r)
            lines.append(f"{r} {q} {pm} {pl} {pc} {qm} {ql} {qc}\n")
    return lines


def alignment_lines(params, store, region_iter) -> list[str]:
    """Format the per-alignment TSV from (ref_id, q_id, regions) records.

    The gani/ani/qcov pre-filter is applied inside the native engine
    (mirroring lz_matcher.cpp:115-138); records arriving here are emitted.
    """
    mrd = params.max_dist_in_ref
    lens = _store_lengths(store)
    lines = []
    for r, q, regs in region_iter:
        s1 = store.names[r]
        s2 = store.names[q]
        len1 = lens[r]
        rc_corr = 2 * len1 + 2 * mrd + 1
        for ref_lo, ref_hi, q_lo, q_hi, n_match, n_mis in regs.tolist():
            length = q_hi - q_lo
            pident = format_real(100.0 * n_match / length, 6)
            if ref_lo < len1:
                rstart, rend = 1 + ref_lo, ref_hi
            else:
                rstart, rend = rc_corr - (1 + ref_lo), rc_corr - ref_hi
            lines.append(
                f"{s2}\t{s1}\t{pident}\t{length}\t{1 + q_lo}\t{q_hi}\t"
                f"{rstart}\t{rend}\t{n_match}\t{n_mis}\n")
    return lines
