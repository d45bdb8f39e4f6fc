"""The plain LZ parse of one (reference, query) pair, in Python and numpy.

A frozen rendering, in Python, of the parse that LZ-ANI publishes
(refresh-bio/LZ-ANI parser.cpp:16-837), as the C++ oracle of
``lzani_tpu_torch/csrc/lzani_core.cpp`` at commit 42336e4 states it
(``RefIndex``, ``Parser::parse``, ``Parser::stats``, ``kmer_stream``,
``mix64``-free anchor search, ``prob_len``, ``fpow``). It imports nothing
of the program: the benchmark hands it the generated genomes, and it
builds every table it needs from them itself.

Each step follows the C++ statement for statement; numpy only computes,
in bulk, what the scalar loop would compute one symbol at a time:
the k-mer streams, which query positions have an anchor or a seed
candidate at all (the automaton steps over the others one literal at a
time and does nothing else there), the approximate extensions' window
scans, and the match and literal runs of an aligned range. The anchor
hash table of the original (linear probing, inserts in ascending
position) is searched as the sorted list of equal k-mers it amounts to:
its probe visits one k-mer's positions in ascending order, and the
longest match wins, the first on ties.

``real`` is the floating-point type of the one decision that the parse
takes in floating point (an anchor against a seed candidate, by the
chance that either matches at random): ``float`` (double, as published)
or ``np.float32`` (the benchmark's lower-precision control).
"""

from __future__ import annotations

import math

import numpy as np

SYM_N_REF = 4          # N in the reference buffer
SYM_N_SEQ = 5          # N in the query buffer: never equals SYM_N_REF
F_LIT, F_CLOSE, F_DISTANT = 0, 1, 2


class Cfg:
    """The eight parse parameters (LZ-ANI's --mal --msl --mrd --mqd --reg
    --aw --am --ar)."""

    __slots__ = ("mal", "msl", "mrd", "mqd", "reg", "aw", "am", "ar")

    def __init__(self, mal, msl, mrd, mqd, reg, aw, am, ar):
        self.mal, self.msl, self.mrd, self.mqd = mal, msl, mrd, mqd
        self.reg, self.aw, self.am, self.ar = reg, aw, am, ar
        if not (1 <= msl <= mal <= 31 and msl <= 15):
            raise ValueError("the plain parse keys k-mers in 64 bits: "
                             "needs msl <= mal <= 31, msl <= 15")


def kmer_stream(seq: np.ndarray, k: int) -> np.ndarray:
    """Entry p: the base-4 value of the k-mer at p, or -1 where the window
    holds a symbol >= 4 or runs past the end (``kmer_stream``)."""
    n = len(seq)
    out = np.full(n, -1, np.int64)
    m = n - k + 1
    if m <= 0:
        return out
    out[:m] = np.where(_window_ok(seq, k), _kmer_values(
        seq.astype(np.int64) & 3, k), -1)
    return out


def _window_ok(seq: np.ndarray, k: int) -> np.ndarray:
    """Whether each window of `k` symbols holds no symbol >= 4."""
    bad = np.concatenate([[0], np.cumsum(seq >= 4)])
    return (bad[k:] - bad[:len(seq) - k + 1]) == 0


def _kmer_values(s: np.ndarray, k: int) -> np.ndarray:
    """Base-4 values of every window of `k` symbols of `s` (values 0..3),
    built by halving: a window of 2h is its left h-mer times 4^h plus its
    right one."""
    if k == 1:
        return s
    if k % 2:
        return _kmer_values(s, k - 1)[:-1] * 4 + s[k - 1:]
    h = _kmer_values(s, k // 2)
    return h[:-(k // 2)] * (1 << k) + h[k // 2:]


class RefIndex:
    """The composite reference buffer (forward strand, 2 mrd N, reverse
    complement, mrd N, then a guard band of N that never matches) and its
    two k-mer tables: anchors (mal-mers) sorted by (k-mer, position), and
    seeds (msl-mers) as one sorted key ``seed << 32 | position``."""

    def __init__(self, seq: np.ndarray, cfg: Cfg):
        mrd = cfg.mrd
        fwd = np.where(seq >= 4, SYM_N_REF, seq).astype(np.uint8)
        rc = np.where(seq[::-1] >= 4, SYM_N_REF, 3 - seq[::-1]).astype(
            np.uint8)
        n4 = lambda k: np.full(k, SYM_N_REF, np.uint8)  # noqa: E731
        core = np.concatenate([fwd, n4(2 * mrd), rc, n4(mrd)])
        self.n_sem = len(core)
        self.buf = np.concatenate([core, n4(cfg.mqd + cfg.msl + 64)])
        anchors = kmer_stream(core, cfg.mal)
        pos = np.flatnonzero(anchors >= 0)
        shift = 64 - 2 * cfg.mal
        if self.n_sem >= 1 << shift:
            raise ValueError("the composite is too long to key its anchors "
                             "and positions in 64 bits")
        comb = np.sort((anchors[pos].astype(np.uint64) << np.uint64(shift))
                       | pos.astype(np.uint64))
        self.a_keys = (comb >> np.uint64(shift)).astype(np.int64)
        self.a_pos = (comb & np.uint64((1 << shift) - 1)).astype(np.int64)
        seeds = kmer_stream(core, cfg.msl)
        pos = np.flatnonzero(seeds >= 0)
        self.s_comb = np.sort((seeds[pos] << 32) | pos)


class Query:
    """The query buffer (the sequence, N as SYM_N_SEQ, then mrd N) and its
    k-mer streams."""

    def __init__(self, seq: np.ndarray, cfg: Cfg):
        q = np.where(seq >= 4, SYM_N_SEQ, seq).astype(np.uint8)
        self.buf = np.concatenate([q, np.full(cfg.mrd, SYM_N_SEQ, np.uint8)])
        self.dsz = len(self.buf)
        self.anchors = kmer_stream(self.buf, cfg.mal)
        self.seeds = kmer_stream(self.buf, cfg.msl)
        #: the positions in the order of their anchor k-mers
        self.by_anchor = np.argsort(self.anchors)


def _prob_len(n: int) -> float:
    """P(a random match of `n` symbols) = 4^-n, exact (``prob_len``)."""
    return math.ldexp(1.0, -2 * n)


def _fpow(base, e: int, one):
    """Binary exponentiation in the multiplication order of ``fpow``."""
    r = one
    while e:
        if e & 1:
            r = r * base
        base = base * base
        e //= 2
    return r


def _scan(miss: np.ndarray, am: int, aw: int, ar: int) -> tuple[int, bool]:
    """The approximate extension's loop over `miss` (one flag a step):
    (the extension's length so far, whether the window broke). Steps
    until the mismatches in the last `aw` steps pass `am`, that step
    included; the length ends with the last match that closes a run of
    >= `ar` matches, where the run count starts at `ar`."""
    n = len(miss)
    cs = np.concatenate([[0], np.cumsum(miss, dtype=np.int64)])
    e = np.arange(n)
    bad = cs[1:] - cs[np.maximum(0, e + 1 - aw)]
    brk = np.flatnonzero(bad > am)
    stop = int(brk[0]) if len(brk) else n - 1
    m = miss[:stop + 1]
    last_miss = np.maximum.accumulate(np.where(m, e[:stop + 1], -1))
    ok = ~m & ((e[:stop + 1] - last_miss >= ar) | (last_miss < 0))
    hit = np.flatnonzero(ok)
    return (int(hit[-1]) + 1 if len(hit) else 0), bool(len(brk))


class Parser:
    """The greedy LZ parse of one query against one reference, and its
    factors: [dpos, kind, rpos, len] lists."""

    def __init__(self, ri: RefIndex, q: Query, cfg: Cfg, real=float):
        self.ri, self.q, self.cfg, self.real = ri, q, cfg, real
        self.fac: list[list[int]] = []
        # query positions with any anchor candidate (searched in k-mer
        # order, which numpy's binary search walks fastest)
        keys = q.anchors[q.by_anchor]
        self.has_anchor = np.zeros(q.dsz, bool)
        if len(ri.a_keys):
            at = np.minimum(np.searchsorted(ri.a_keys, keys),
                            len(ri.a_keys) - 1)
            self.has_anchor[q.by_anchor] = (ri.a_keys[at] == keys) & \
                (keys >= 0)
        self.anchor_at = np.flatnonzero(self.has_anchor)

    # --- scans ---------------------------------------------------------
    def match_len(self, rpos: int, dpos: int, start: int = 0) -> int:
        """Longest common extension of reference `rpos` and query `dpos`,
        counted from `start` (``match_len``)."""
        cap = min(self.ri.n_sem - rpos, self.q.dsz - dpos)
        a, b = self.ri.buf, self.q.buf
        r = start
        step = 32
        while r < cap:
            e = min(cap, r + step)
            ne = np.flatnonzero(a[rpos + r:rpos + e] != b[dpos + r:dpos + e])
            if len(ne):
                return r + int(ne[0])
            r = e
            step *= 4
        return r

    def _extend(self, q_at, r_at, limit: int) -> int:
        """Approximate extension over at most `limit` steps; `q_at(a, b)`
        and `r_at(a, b)` give steps [a, b) of each side."""
        cfg = self.cfg
        if limit <= 0:
            return 0
        n = min(limit, 256)
        while True:
            miss = q_at(0, n) != r_at(0, n)
            ext, broke = _scan(miss, cfg.am, cfg.aw, cfg.ar)
            if broke or n == limit:
                return ext
            n = min(limit, n * 8)

    def extend_fwd(self, dpos: int, rpos: int) -> int:
        qb, rb = self.q.buf, self.ri.buf
        limit = min(self.q.dsz - dpos, self.ri.n_sem - rpos)
        return self._extend(lambda a, b: qb[dpos + a:dpos + b],
                            lambda a, b: rb[rpos + a:rpos + b], limit)

    def extend_bwd(self, dpos: int, rpos: int, max_len: int) -> int:
        qb, rb = self.q.buf, self.ri.buf
        limit = min(dpos, rpos, max_len)
        return self._extend(lambda a, b: qb[dpos - b:dpos - a][::-1],
                            lambda a, b: rb[rpos - b:rpos - a][::-1], limit)

    # --- emission ------------------------------------------------------
    def emit_aligned_range(self, dpos: int, rpos: int, n: int,
                           backward: bool) -> None:
        """Match and literal runs of an aligned range; the first match
        run is DISTANT when `backward`, CLOSE otherwise."""
        if n <= 0:
            return
        eq = self.ri.buf[rpos:rpos + n] == self.q.buf[dpos:dpos + n]
        cut = np.flatnonzero(eq[1:] != eq[:-1]) + 1
        starts = np.concatenate([[0], cut]).tolist()
        ends = np.concatenate([cut, [n]]).tolist()
        is_m = eq[np.asarray(starts)].tolist()
        first = True
        fac = self.fac
        for s, e, m in zip(starts, ends, is_m):
            if m:
                kind = (F_DISTANT if backward else F_CLOSE) if first \
                    else F_CLOSE
                first = False
                fac.append([dpos + s, kind, rpos + s, e - s])
            else:
                fac.append([dpos + s, F_LIT, 0, e - s])

    def emit_gap_two_sided(self, dpos: int, r_left: int, r_right: int,
                           n: int) -> None:
        """The best left/right split of the literal gap before a close
        match (``emit_gap_two_sided``)."""
        rb, qb, fac = self.ri.buf, self.q.buf, self.fac
        to_scan = n if r_right < r_left else min(r_right - r_left, n)
        lhs = [(0, False)]
        nm = 0
        for j in range(to_scan):
            eq = bool(rb[r_left + j] == qb[dpos + j])
            nm += eq
            lhs.append((nm, eq))
        rhs = [(0, False)]
        nm = 0
        for j in range(1, min(to_scan, r_right) + 1):
            eq = bool(rb[r_right - j] == qb[dpos + n - j])
            nm += eq
            rhs.append((nm, eq))
        rhs += [(0, False)] * (to_scan + 1 - len(rhs))
        del rhs[to_scan + 1:]
        best, split = 0, 0
        for j in range(to_scan + 1):
            tot = lhs[j][0] + rhs[to_scan - j][0]
            if tot >= best:
                best, split = tot, j
        if split > 0:
            eq = lhs[1][1]
            dp = dpos
            fac.append([dp, F_CLOSE if eq else F_LIT, r_left if eq else 0, 1])
            dp += 1
            for j in range(2, split + 1):
                eq = lhs[j][1]
                kind = F_CLOSE if eq else F_LIT
                if kind == fac[-1][1]:
                    fac[-1][3] += 1
                else:
                    fac.append([dp, kind, r_left + j - 1 if eq else 0, 1])
                dp += 1
        if to_scan < n:
            if split > 0 and fac[-1][1] == F_LIT:
                fac[-1][3] += n - to_scan
            else:
                fac.append([dpos + split, F_LIT, 0, n - to_scan])
        if split < to_scan:
            shift = n - to_scan
            from_right = to_scan - split
            eq = rhs[from_right][1]
            dp = dpos + split + shift
            if not eq and (split > 0 or shift > 0) and fac[-1][1] == F_LIT:
                fac[-1][3] += 1
            else:
                fac.append([dp, F_CLOSE if eq else F_LIT,
                            r_right - from_right if eq else 0, 1])
                dp += 1
            for j in range(from_right - 1, 0, -1):
                eq = rhs[j][1]
                kind = F_CLOSE if eq else F_LIT
                if kind == fac[-1][1]:
                    fac[-1][3] += 1
                else:
                    fac.append([dp, kind, r_right - j if eq else 0, 1])
                dp += 1

    # --- candidates ----------------------------------------------------
    def anchor(self, i: int) -> tuple[int, int]:
        """(position, length) of the longest anchor match at query `i`,
        the first on ties; (0, 0) for none."""
        best_len, best_pos = 0, 0
        if not self.has_anchor[i]:
            return 0, 0
        key = self.q.anchors[i]
        lo = int(np.searchsorted(self.ri.a_keys, key, "left"))
        hi = int(np.searchsorted(self.ri.a_keys, key, "right"))
        for p in self.ri.a_pos[lo:hi].tolist():
            ml = self.match_len(p, i)
            if ml < self.cfg.mal:
                continue
            if ml > best_len:
                best_len, best_pos = ml, p
        return best_pos, best_len

    def seeds_in(self, i: int, lo_pos: int, hi_pos: int) -> list[int]:
        """Reference positions of query `i`'s seed in [lo_pos, hi_pos)."""
        s = int(self.q.seeds[i])
        if s < 0:
            return []
        comb = self.ri.s_comb
        a = np.searchsorted(comb, (s << 32) | max(lo_pos, 0))
        b = np.searchsorted(comb, (s << 32) | max(hi_pos, 0))
        return (comb[a:b] & 0xFFFFFFFF).tolist()

    def seed_window_hits(self, i0: int, steps: int, lo_pos: int,
                         hi0: int) -> np.ndarray:
        """For query positions i0 .. i0 + steps - 1 (step t searching
        [lo_pos, hi0 + t)): whether the seed there has a candidate."""
        s = self.q.seeds[i0:i0 + steps]
        ok = s >= 0
        base = np.where(ok, s, 0) << 32
        comb = self.ri.s_comb
        a = np.searchsorted(comb, base | max(lo_pos, 0))
        b = np.searchsorted(comb, base | (hi0 + np.arange(len(s))))
        return ok & (b > a)

    def choose(self, i: int, pred: int, lit_run: int) -> tuple[int, int]:
        """(best_pos, best_len) at query `i` in the synced state."""
        cfg = self.cfg
        best_pos = best_len = 0
        for pos in self.seeds_in(i, pred - lit_run, pred + cfg.mrd):
            ml = self.match_len(pos, i, cfg.msl)
            if ml >= best_len:
                if ml == best_len:
                    if abs(pos - pred) < abs(best_pos - pred):
                        best_pos = pos
                else:
                    best_len, best_pos = ml, pos
        a_pos, a_len = self.anchor(i)
        if a_pos:                   # an anchor AT position 0 is ignored
            if not best_pos:
                best_pos, best_len = a_pos, a_len
            else:
                real = self.real
                one = real(1.0)
                e_a = int(2 * (self.ri.n_sem + 1 - a_len)) & 0xFFFFFFFF
                e_c = int(lit_run + cfg.mrd + 1 - best_len) & 0xFFFFFFFF
                pa = _fpow(one - real(_prob_len(a_len)), e_a, one)
                pc = _fpow(one - real(_prob_len(best_len)), e_c, one)
                if pa > pc:
                    best_pos, best_len = a_pos, a_len
        return best_pos, best_len

    # --- the automaton -------------------------------------------------
    def parse(self) -> list[list[int]]:
        cfg, fac = self.cfg, self.fac
        dsz = self.q.dsz
        end = dsz - cfg.msl           # the loop runs while i < end
        pred, lit_run, reg_lo, reg_hi, i = -dsz, 0, -1, 0, 0

        def literals(k):
            nonlocal i, pred, lit_run
            i += k
            lit_run += k
            pred = -dsz if lit_run > cfg.mqd else pred + k

        while i < end:
            best_pos = best_len = 0
            if pred < 0:
                # unsynced: literals up to the next anchor candidate
                j = int(np.searchsorted(self.anchor_at, i))
                nxt = int(self.anchor_at[j]) if j < len(self.anchor_at) \
                    else end
                if nxt >= end:
                    literals(end - i)
                    break
                if nxt > i:
                    literals(nxt - i)
                best_pos, best_len = self.anchor(i)
            else:
                # synced: literals up to the next seed or anchor candidate
                steps = min(cfg.mqd - lit_run + 1, end - i)
                hits = self.seed_window_hits(i, steps, pred - lit_run,
                                             pred + cfg.mrd)
                hits |= self.has_anchor[i:i + steps]
                h = np.flatnonzero(hits)
                if not len(h):
                    literals(steps)
                    continue
                if h[0]:
                    literals(int(h[0]))
                best_pos, best_len = self.choose(i, pred, lit_run)

            if best_len >= cfg.msl:
                flag = F_DISTANT
                if pred >= 0 and abs(best_pos - pred) <= cfg.mrd:
                    self.emit_gap_two_sided(i - lit_run, pred - lit_run,
                                            best_pos + best_len, lit_run)
                    fac.append([i, F_CLOSE, best_pos, best_len])
                else:
                    if lit_run:
                        fac.append([i - lit_run, F_LIT, 0, lit_run])
                    if reg_lo >= 0 and reg_hi - reg_lo < cfg.reg:
                        while fac and fac[-1][0] >= reg_lo:
                            fac.pop()
                        run_len = i - reg_lo
                        while fac and fac[-1][1] == F_LIT:
                            run_len += fac.pop()[3]
                        fac.append([i - run_len, F_LIT, 0, run_len])
                        reg_lo = -1
                    if fac and fac[-1][1] == F_LIT:
                        bwd = self.extend_bwd(i, best_pos, fac[-1][3])
                        if bwd:
                            fac[-1][3] -= bwd
                            if fac[-1][3] == 0:
                                fac.pop()
                            self.emit_aligned_range(i - bwd, best_pos - bwd,
                                                    bwd, True)
                            flag = F_CLOSE
                            reg_lo = i - bwd
                    fac.append([i, flag, best_pos, best_len])
                    if flag == F_DISTANT:
                        reg_lo = i
                    if reg_lo < 0:
                        for f in reversed(fac):
                            if f[1] == F_DISTANT:
                                reg_lo = f[0]
                                break
                i += best_len
                pred = best_pos + best_len
                lit_run = 0
                ext = self.extend_fwd(i, pred)
                self.emit_aligned_range(i, pred, ext, False)
                i += ext
                pred += ext
                reg_hi = i
            else:
                literals(1)

        if pred < 0:
            fac.append([i - lit_run, F_LIT, 0, lit_run + (dsz - i)])
        else:
            self.emit_aligned_range(i - lit_run, pred - lit_run - cfg.msl,
                                    lit_run + (dsz - i), False)
        return fac

    def stats(self) -> tuple[int, int, int]:
        """(symbols in matches, symbols in literals, components):
        matches chain across close matches, literals count only between
        matches of one component, and a component shorter than `reg` is
        dropped (``Parser::stats``)."""
        reg = self.cfg.reg
        tot_m = tot_l = n_comp = 0
        cur_m = cur_l = pend = 0
        for _, kind, _, n in self.fac:
            if kind == F_DISTANT:
                if cur_m and cur_m + cur_l >= reg:
                    tot_m += cur_m
                    tot_l += cur_l
                    n_comp += 1
                cur_m, cur_l, pend = n, 0, 0
            elif kind == F_CLOSE:
                cur_m += n
                cur_l += pend
                pend = 0
            else:
                pend += n
        if cur_m and cur_m + cur_l >= reg:
            tot_m += cur_m
            tot_l += cur_l
            n_comp += 1
        return tot_m, tot_l, n_comp


def parse_pair(ri: RefIndex, q: Query, cfg: Cfg, real=float):
    """(symbols in matches, in literals, components) of query `q` parsed
    against reference `ri`."""
    p = Parser(ri, q, cfg, real)
    p.parse()
    return p.stats()
